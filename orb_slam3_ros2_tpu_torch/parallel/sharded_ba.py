"""Distributed Schur-complement bundle adjustment over a shard mesh.

Port of `orb_slam3_ros2_tpu/parallel/sharded_ba.py`. Landmarks (and their
observations) are sharded over the mesh axis ``lm``; poses are replicated.
Each shard builds the Hessian contributions of its landmark shard
(`backend/schur.schur_reduce`); the reduced camera system

    S = sum over shards [ Hcc_partial - W Hll^-1 W^T ],   rhs = sum [...]

is the one psum of an iteration (S is only (K,6,K,6)), the 6K x 6K solve
is replicated, and the landmark back-substitution is shard-local. The
JAX `shard_map` body is `_shard_run`, a generator over one shard's slices
whose yields are its psums (`parallel/mesh.run_shards`); the `lax.scan`
over iterations is a Python loop, and the LM accept is a `torch.where`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod
from orb_slam3_ros2_tpu_torch.backend import residuals as res
from orb_slam3_ros2_tpu_torch.backend import schur
from orb_slam3_ros2_tpu_torch.geom import lie
from orb_slam3_ros2_tpu_torch.parallel import mesh as mesh_mod

FIXED_PRIOR = ba_mod.FIXED_PRIOR
REFRESH_EVERY = 5  # chi2 re-classification period (JAX sharded_ba.py:180)


def _shard_step(R, t, X, uv, w, fixed, point_valid, lam, fx, fy, cx, cy):
    """One damped GN step on one landmark shard. A generator: its two
    yields are the psums of the JAX body (the reduced system and cost at
    the linearization point, then the trial cost). Returns (R, t, X, lam,
    cost1)."""
    terms = schur.schur_reduce(R, t, X, uv, w, fx, fy, cx, cy, lam)
    # --- the only cross-shard communication in the iteration ---
    Hcc, S_off, rhs, cost0 = yield (terms.Hcc_p, terms.S_off, terms.rhs_p,
                                    terms.cost0)
    dxc = schur.solve_cameras(Hcc, S_off, rhs, fixed, lam, FIXED_PRIOR)
    dxl = schur.back_substitute(terms, dxc, point_valid)
    R_new, t_new = lie.se3_retract(R, t, dxc)
    R_new = lie.se3_normalize(R_new)
    X_new = X + dxl
    cost1, = yield (schur.robust_cost(R_new, t_new, X_new, uv, w, fx, fy,
                                      cx, cy),)
    better = cost1 < cost0
    R = torch.where(better, R_new, R)
    t = torch.where(better, t_new, t)
    X = torch.where(better, X_new, X)
    lam = torch.where(better, lam * 0.3, lam * 5.0).clamp(1e-9, 1e3)
    return R, t, X, lam, cost1


def _shard_run(R, t, X, uv, w, fixed, point_valid, fx, fy, cx, cy,
               n_iters: int):
    """The JAX `run` body on one shard: n_iters steps with the chi2 gate
    refreshed every REFRESH_EVERY iterations, never before the first
    (shard-local: each shard gates only its own landmarks'
    observations). Returns (R, t, X, cost of the last step)."""
    lam = torch.tensor(1e-4, dtype=torch.float32, device=X.device)
    w_act, cost = w, None
    for it in range(n_iters):
        if it > 0 and it % REFRESH_EVERY == 0:
            w_act = schur.refresh_weights(R, t, X, uv, w, fx, fy, cx, cy,
                                          res.CHI2_MONO)
        R, t, X, lam, cost = yield from _shard_step(
            R, t, X, uv, w_act, fixed, point_valid, lam, fx, fy, cx, cy)
    return R, t, X, cost


def _is_sharded(p: ba_mod.BAProblem) -> bool:
    return isinstance(p.X, (tuple, list))


def shard_problem(problem: ba_mod.BAProblem, mesh: mesh_mod.Mesh,
                  shards: Sequence[int] = None, devices=None
                  ) -> ba_mod.BAProblem:
    """This process's landmark shards of the problem (host -> mesh): a
    BAProblem whose fields are tuples, one entry per local shard on its
    device; poses and `fixed` replicated, X, uv, w and point_valid sliced
    along the landmark axis. `shards`/`devices` pick other shards of the
    axis (default this process's of the 1-D mesh)."""
    n = mesh.shape[mesh_mod.LM_AXIS]
    L = problem.X.shape[0]
    if L % n:
        raise ValueError(
            f"landmark capacity {L} not divisible by mesh size {n}")
    Ls = L // n
    shards = mesh.local_shards() if shards is None else shards
    devices = mesh.devices.reshape(-1) if devices is None else devices
    out = {f: [] for f in ba_mod.BAProblem._fields}
    for s, d in zip(shards, devices):
        d = torch.device(d)
        sl = slice(s * Ls, (s + 1) * Ls)
        out["R"].append(problem.R.to(d))
        out["t"].append(problem.t.to(d))
        out["fixed"].append(problem.fixed.to(d))
        out["X"].append(problem.X[sl].to(d))
        out["uv"].append(problem.uv[:, sl].to(d))
        out["w"].append(problem.w[:, sl].to(d))
        out["point_valid"].append(problem.point_valid[sl].to(d))
    return ba_mod.BAProblem(**{f: tuple(v) for f, v in out.items()})


def make_sharded_ba(mesh: mesh_mod.Mesh, fx, fy, cx, cy, n_iters: int = 10):
    """The distributed BA. Its problem follows `ba.BAProblem` (whole, or
    from `shard_problem`); the landmark axis must divide by the mesh's
    ``lm`` size. Returns the full landmark array on every process."""

    def ba(problem: ba_mod.BAProblem) -> ba_mod.BAResult:
        w_full = None if _is_sharded(problem) else problem.w
        if w_full is not None:
            problem = shard_problem(problem, mesh)
        outs = mesh_mod.run_shards(mesh, (
            _shard_run(*fields, fx, fy, cx, cy, n_iters)
            for fields in zip(*problem)))
        R, t, _, cost = outs[0]
        X = mesh.gather([o[2] for o in outs])
        if w_full is None:
            w_full = mesh.gather(list(problem.w), dim=1)
        return ba_mod.BAResult(R=R, t=t, X=X, cost=cost, inlier_w=w_full)

    return ba
