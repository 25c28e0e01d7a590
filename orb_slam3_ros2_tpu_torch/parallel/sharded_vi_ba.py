"""Distributed joint visual-inertial bundle adjustment over a shard mesh.

Port of `orb_slam3_ros2_tpu/parallel/sharded_vi_ba.py`. Layout as
`parallel/sharded_ba.py`:

* **Visual part, landmark-sharded**: each shard Schur-eliminates its
  landmark shard (`backend/schur.schur_reduce`) and the reduced camera
  system is summed with one psum over the ``lm`` axis.
* **Inertial part, replicated**: the preintegration factors couple only
  poses, velocities, biases and gravity (9K+8 states, no landmark), so
  every shard builds the identical dense inertial system
  (`backend/vi_ba._inertial_terms`) with no extra communication.
* The (9K+8)^2 solve is replicated; landmark back-substitution is
  shard-local.

The solved gravity tangent is returned (`VIBAResult.thg`). The JAX
wrapper returns `thg=jnp.zeros(2)` (its :183), dropping the gravity
direction that `opt_gravity=True` optimizes; the port does not carry that
over. The visual costs of the current and the trial state, two psums in
the JAX body, travel in one here.
"""

from __future__ import annotations

import torch

from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod
from orb_slam3_ros2_tpu_torch.backend import schur
from orb_slam3_ros2_tpu_torch.backend import vi_ba as vi_mod
from orb_slam3_ros2_tpu_torch.geom import lie
from orb_slam3_ros2_tpu_torch.imu import preintegration as pre_mod
from orb_slam3_ros2_tpu_torch.parallel import mesh as mesh_mod
from orb_slam3_ros2_tpu_torch.parallel import sharded_ba

FIXED_PRIOR = ba_mod.FIXED_PRIOR


def _shard_run(R, t, X, uv, w, fixed, point_valid, pres, v0, bg0, ba0,
               fx, fy, cx, cy, n_iters, prior_bg, prior_ba, opt_gravity):
    """The JAX `run` body on one landmark shard. Returns (R, t, X, v, bg,
    ba, thg, cost)."""
    K = R.shape[0]
    D = 9 * K + 8
    dev, dt_ = R.device, R.dtype
    eye3, zero3 = (torch.eye(3, dtype=dt_, device=dev),
                   torch.zeros(3, dtype=dt_, device=dev))
    Wmats = vi_mod._whiteners(pres)
    col = vi_mod._columns(K, K - 1, dev)  # (K-1, 26)
    n_tan = col.shape[1]
    rows_idx = col[:, :, None].expand(K - 1, n_tan, n_tan)
    cols_idx = col[:, None, :].expand(K - 1, n_tan, n_tan)
    diag_prior = torch.zeros((D,), dtype=dt_, device=dev)
    diag_prior[9 * K:9 * K + 3] += prior_bg
    diag_prior[9 * K + 3:9 * K + 6] += prior_ba
    diag_prior[9 * K + 6:] += 1e-6 if opt_gravity else FIXED_PRIOR
    diag_prior[:6 * K] += torch.where(fixed, FIXED_PRIOR,
                                      0.0).to(dt_).repeat_interleave(6)

    def inertial(Rr, tt, vv, bgg, baa, tg, jacobian=True):
        return vi_mod._inertial_terms(pres, Rr, tt, vv, bgg, baa, tg, Wmats,
                                      eye3, zero3, jacobian=jacobian)

    def rest_cost(rr, bgg, baa):
        """The inertial and prior part of the total cost."""
        return (torch.sum(rr * rr) + prior_bg * torch.sum((bgg - bg0) ** 2)
                + prior_ba * torch.sum(baa ** 2))

    v, bg, ba = v0, bg0, ba0
    thg = torch.zeros(2, dtype=dt_, device=dev)
    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    cost = None
    for _ in range(n_iters):
        # --- visual: shard-local Schur reduction + ONE psum ---
        terms = schur.schur_reduce(R, t, X, uv, w, fx, fy, cx, cy, lam)
        Hcc, S_off, rhs = yield (terms.Hcc_p, terms.S_off, terms.rhs_p)
        H = torch.zeros((D, D), dtype=dt_, device=dev)
        b = torch.zeros((D,), dtype=dt_, device=dev)
        H[:6 * K, :6 * K] = -S_off + torch.block_diag(*Hcc.unbind(0))
        b[:6 * K] = rhs.reshape(-1)
        # --- inertial: replicated dense terms, no communication ---
        r_i, J_i = inertial(R, t, v, bg, ba, thg)
        H = H.index_put((rows_idx, cols_idx),
                        torch.einsum("eai,eaj->eij", J_i, J_i),
                        accumulate=True)
        b = b.index_put((col,), torch.einsum("eai,ea->ei", J_i, r_i),
                        accumulate=True)
        b = torch.cat([b[:9 * K], b[9 * K:9 * K + 3] + prior_bg * (bg - bg0),
                       b[9 * K + 3:9 * K + 6] + prior_ba * ba,
                       b[9 * K + 6:]])
        Hd = H + torch.diag(lam * torch.diagonal(H).abs() + diag_prior
                            + 1e-8)
        dx = -torch.linalg.solve_ex(Hd, b[:, None]).result[:, 0]
        dxc = dx[:6 * K].reshape(K, 6)
        # --- landmark back-substitution: shard-local ---
        dxl = schur.back_substitute(terms, dxc, point_valid)
        R_new, t_new = lie.se3_retract(R, t, dxc)
        R_new = lie.se3_normalize(R_new)
        X_new = X + dxl
        v_new = v + dx[6 * K:9 * K].reshape(K, 3)
        bg_new = bg + dx[9 * K:9 * K + 3]
        ba_new = ba + dx[9 * K + 3:9 * K + 6]
        thg_new = thg + dx[9 * K + 6:]
        vis0, vis1 = yield (
            schur.robust_cost(R, t, X, uv, w, fx, fy, cx, cy),
            schur.robust_cost(R_new, t_new, X_new, uv, w, fx, fy, cx, cy))
        c0 = vis0 + rest_cost(r_i, bg, ba)
        r1, _ = inertial(R_new, t_new, v_new, bg_new, ba_new, thg_new,
                         jacobian=False)
        c1 = vis1 + rest_cost(r1, bg_new, ba_new)
        better = c1 < c0
        R = torch.where(better, R_new, R)
        t = torch.where(better, t_new, t)
        X = torch.where(better, X_new, X)
        v = torch.where(better, v_new, v)
        bg = torch.where(better, bg_new, bg)
        ba = torch.where(better, ba_new, ba)
        thg = torch.where(better, thg_new, thg)
        lam = torch.where(better, lam * 0.3, lam * 5.0).clamp(1e-9, 1e3)
        cost = torch.where(better, c1, c0)
    return R, t, X, v, bg, ba, thg, cost


def make_sharded_vi_ba(mesh: mesh_mod.Mesh, fx, fy, cx, cy, n_iters: int = 8,
                       prior_bg: float = 1e2, prior_ba: float = 1e6,
                       opt_gravity: bool = False):
    """The distributed VI BA. The problem follows `ba.BAProblem` (whole, or
    from `shard_vi_problem`; the landmark axis divisible by the mesh's
    ``lm`` size) plus stacked preintegrations, initial velocities and
    biases."""

    def vi_ba(problem: ba_mod.BAProblem, pres: pre_mod.Preintegrated, v0,
              bg0, ba0) -> vi_mod.VIBAResult:
        if not sharded_ba._is_sharded(problem):
            problem = shard_vi_problem(problem, mesh)
        gens = []
        for fields, d in zip(zip(*problem), mesh.devices.reshape(-1)):
            d = torch.device(d)
            gens.append(_shard_run(
                *fields, pre_mod.Preintegrated(*(f.to(d) for f in pres)),
                v0.to(d), bg0.to(d), ba0.to(d), fx, fy, cx, cy, n_iters,
                prior_bg, prior_ba, opt_gravity))
        outs = mesh_mod.run_shards(mesh, gens)
        R, t, _, v, bg, ba, thg, cost = outs[0]
        X = mesh.gather([o[2] for o in outs])
        return vi_mod.VIBAResult(R=R, t=t, X=X, v=v, bg=bg, ba=ba, cost=cost,
                                 thg=thg)

    return vi_ba


def shard_vi_problem(problem: ba_mod.BAProblem, mesh: mesh_mod.Mesh
                     ) -> ba_mod.BAProblem:
    """This process's landmark shards of the problem (host -> mesh)."""
    return sharded_ba.shard_problem(problem, mesh)
