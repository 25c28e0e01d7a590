"""Joint visual-inertial bundle adjustment (VIBA2, the reference's
`FullInertialBA` / `LocalInertialBA`).

Port of `orb_slam3_ros2_tpu/backend/vi_ba.py`. Landmarks are Schur-
eliminated exactly as in visual BA (`backend/schur.py`); the reduced camera
system is extended with per-keyframe velocities, one shared bias pair and
the gravity direction, state layout

    [ ξ_0..ξ_{K-1} (6K) | v_0..v_{K-1} (3K) | bg (3) | ba (3) | θg (2) ]

The inertial blocks are exact forward-mode Jacobians over the 26 local
tangent coordinates of each interval, whitened by the preintegration
covariance and added into the dense reduced system; one (9K+8)² solve per
iteration. The JAX version takes `jacfwd` per interval under `vmap`; here
`backend/jacobian.jacobian` evaluates 26 copies of all E intervals in one
forward-mode pass, which gives every interval's (9, 26) block. The
iteration `lax.scan` is a Python loop whose LM accept/reject is a
`torch.where`: no host sync.

While a profiler runs, each iteration is a `vi.iteration` span holding
`vi.reduce` (the Schur reduce), `vi.inertial` (the inertial residuals,
their Jacobians and the products JᵀJ, Jᵀr), `vi.solve` (the assembly of
the (9K+8)² system: the visual block, the inertial scatter and the priors;
the damping and the dense solve), `vi.back_substitute` (the landmark step
and the candidate state) and `vi.cost` (both total costs and the LM
accept) (`utils/tracing.span`).

On a CUDA device the reduce, the inertial terms, the solve, the update
and the two costs are CUDA graphs, as `backend/ba.py`'s stages are
(`backend/stage_graphs.py`, a cache of this module's own): an iteration
is six graph replays, the copies of their inputs and the eager accept.
`vi_bundle_adjust.graph_captures`, `.graph_replays` and `.eager_stages`
count the stage calls on CUDA; `.intervals` and `.state_dim` hold the last
solve's count of inertial intervals and its state dimension 9K + 8.

Precision. The state stays in the problem's dtype (the map's float32);
each iteration linearizes it in `LIN` = float64: the reprojection and
inertial residuals, their Jacobians, the gradient, the (9K+8)² system and
its LU, and both total costs. Only the reduce's S = V Vᵀ is formed in the
problem's dtype (`schur.schur_reduce(..., dtype=LIN)`). Near the optimum
the gradient is a sum of residuals that cancel, and float32 residuals
(~2e-5 px of rounding on ~300 px projections; whitened preintegration
residuals of O(1) differences scaled by up to ~6.5e3) left it ~2e-3 off
in relative terms at 32 keyframes: the map's weak directions turned that
into steps 1e-3–1e-2 off the float64 ones from iteration 3 on, and at
256 keyframes into LM decisions that went the other way. S in float32
parts by ~2e-8 from float64 and moves the step by 1e-6–1e-4
(`tests/test_slambench_vi_gba.py`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod
from orb_slam3_ros2_tpu_torch.backend import schur
from orb_slam3_ros2_tpu_torch.backend import stage_graphs
from orb_slam3_ros2_tpu_torch.backend import jacobian as jac_mod
from orb_slam3_ros2_tpu_torch.geom import lie
from orb_slam3_ros2_tpu_torch.imu import preintegration as pre_mod
from orb_slam3_ros2_tpu_torch.utils import tracing

FIXED_PRIOR = ba_mod.FIXED_PRIOR
LIN = torch.float64  # the dtype of the linearization (module docstring)
N_TAN = 26  # [ξ_i(6), ξ_j(6), v_i(3), v_j(3), bg(3), ba(3), θg(2)]


class VIBAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    v: torch.Tensor  # (K, 3)
    bg: torch.Tensor
    ba: torch.Tensor
    cost: torch.Tensor
    thg: torch.Tensor  # (2,) residual gravity-direction tangent (x, y)


def _gravity(thg):
    """g_w from the 2-DOF tangent(s) (..., 2): exp([θx, θy, 0]) g0. The
    reference co-optimizes the gravity direction (VertexGDir) so that the
    biases do not absorb tilt left by the inertial-only stage. Takes a
    leading dimension (forward-mode AD gives a Python scalar's arithmetic
    with a 0-dim tensor a float64 tangent)."""
    phi = torch.cat([thg, torch.zeros_like(thg[..., :1])], dim=-1)
    return pre_mod._mv(lie.so3_exp(phi), pre_mod.gravity_like(thg))


def _body_state(Rcw, tcw, xi, R_cb, t_cb):
    """(R_wb, p_wb) of the camera pose exp(xi) ∘ T_cw: T_wb = T_wc ∘ T_cb."""
    dR, dt = lie.se3_exp(xi)
    Rcw2, tcw2 = lie.se3_compose(dR, dt, Rcw, tcw)
    Rwc, twc = lie.se3_inverse(Rcw2, tcw2)
    return lie.se3_compose(Rwc, twc, R_cb, t_cb)


def _interval_residuals(tan, pres, R_i, t_i, R_j, t_j, v_i, v_j, bg, ba,
                        thg, Wmats, R_cb, t_cb):
    """Whitened residuals (n, 9) of n intervals, interval e between the
    camera poses (R_i, t_i)[e] and (R_j, t_j)[e] with velocities v_i[e],
    v_j[e], at the local tangents `tan` (n, 26)."""
    R_wb_i, p_wb_i = _body_state(R_i, t_i, tan[:, 0:6], R_cb, t_cb)
    R_wb_j, p_wb_j = _body_state(R_j, t_j, tan[:, 6:12], R_cb, t_cb)
    r = pre_mod.residual(
        pres, R_wb_i, p_wb_i, v_i + tan[:, 12:15], R_wb_j, p_wb_j,
        v_j + tan[:, 15:18], bg + tan[:, 18:21], ba + tan[:, 21:24],
        g_w=_gravity(thg + tan[:, 24:26]))
    return pre_mod._mv(Wmats, r)


def _inertial_terms(pres, R, t, v, bg, ba, thg, Wmats, R_bc, t_bc,
                    n_intervals=None, jacobian: bool = True):
    """Residuals and Jacobians of the first `n_intervals` consecutive-
    keyframe intervals (default K-1, the whole window; fewer when the
    window carries trailing visual-only anchor keyframes).

    Poses are T_cw; body states derive through the body-from-camera
    extrinsic (R_bc, t_bc). Returns r (E, 9) and J (E, 9, 26) in the local
    tangent order [ξ_i, ξ_j, v_i, v_j, bg, ba, θg] (J is None without
    `jacobian`)."""
    K = R.shape[0]
    E = K - 1 if n_intervals is None else n_intervals
    R_cb, t_cb = lie.se3_inverse(R_bc, t_bc)
    rows = (pre_mod.index(pres, slice(0, E)), R[:E], t[:E], R[1:E + 1],
            t[1:E + 1], v[:E], v[1:E + 1])
    if not jacobian:
        z = torch.zeros((E, N_TAN), dtype=R.dtype, device=R.device)
        return _interval_residuals(z, *rows, bg, ba, thg, Wmats[:E], R_cb,
                                   t_cb), None

    def rep(x):
        return x.repeat((N_TAN,) + (1,) * (x.dim() - 1))

    def copies(tan):
        """(26, E, 9) residuals of the 26 stacked copies of the E
        intervals."""
        r = _interval_residuals(
            tan.reshape(-1, N_TAN), pre_mod.Preintegrated(*map(rep, rows[0])),
            *map(rep, rows[1:]), bg, ba, thg, rep(Wmats[:E]), R_cb, t_cb)
        return r.reshape(N_TAN, E, 9)

    # each interval's residual depends on its own tangent row alone
    return jac_mod.jacobian(copies, torch.zeros(
        (E, N_TAN), dtype=R.dtype, device=R.device))


def _whiteners(pres: pre_mod.Preintegrated) -> torch.Tensor:
    """Upper-triangular W with ||W r||² = rᵀ Σ⁻¹ r, per interval."""
    info = pre_mod.information(pres)
    eye = torch.eye(9, dtype=info.dtype, device=info.device)
    L = torch.linalg.cholesky_ex(
        0.5 * (info + torch.swapaxes(info, -1, -2)) + 1e-6 * eye).L
    return torch.swapaxes(L, -1, -2)


def _columns(K: int, E: int, device) -> torch.Tensor:
    """(E, 26) columns of the reduced system for each interval's tangent:
    [6i..6i+6), [6j..), v_i, v_j, bg, ba, θg."""
    i = torch.arange(E, device=device)[:, None]
    a3, a6 = torch.arange(3, device=device), torch.arange(6, device=device)
    return torch.cat([
        6 * i + a6, 6 * (i + 1) + a6,
        6 * K + 3 * i + a3, 6 * K + 3 * (i + 1) + a3,
        (9 * K + a3).expand(E, 3), (9 * K + 3 + a3).expand(E, 3),
        (9 * K + 6 + torch.arange(2, device=device)).expand(E, 2)], dim=1)


def vi_bundle_adjust(
    p: ba_mod.BAProblem,
    pres: pre_mod.Preintegrated,  # stacked, leading dim K-1
    v0: torch.Tensor,  # (K, 3) initial velocities
    bg0: torch.Tensor,
    ba0: torch.Tensor,
    fx, fy, cx, cy,
    R_bc: Optional[torch.Tensor] = None,  # body-from-camera extrinsic
    t_bc: Optional[torch.Tensor] = None,
    n_iters: int = 8,
    prior_bg: float = 1e2,
    prior_ba: float = 1e1,
    bg_prior_center: Optional[torch.Tensor] = None,
    ba_prior_center: Optional[torch.Tensor] = None,
    opt_gravity: bool = True,
    n_inertial: Optional[int] = None,
) -> VIBAResult:
    """Priors are centred at `bg/ba_prior_center` (default: the initial
    biases), as the reference anchors EdgePriorGyro/EdgePriorAcc at the
    inertial-only stage's estimates.

    `n_inertial` (default K-1): the number of leading consecutive-keyframe
    intervals that carry preintegration factors. Window entries past
    n_inertial + 1 are visual-only anchor keyframes (LocalInertialBA's
    fixed keyframes); their velocity rows have no factor and a zero
    right-hand side, so the damped solve leaves them as they are."""
    K = p.R.shape[0]
    dev, dt_ = p.R.device, p.R.dtype
    E = K - 1 if n_inertial is None else n_inertial
    if R_bc is None:
        R_bc = torch.eye(3, dtype=dt_, device=dev)
        t_bc = torch.zeros(3, dtype=dt_, device=dev)
    bg_c = bg0 if bg_prior_center is None else bg_prior_center
    ba_c = ba0 if ba_prior_center is None else ba_prior_center
    pres = pre_mod.Preintegrated(*(x.to(LIN) for x in pres))
    R_bc, t_bc = R_bc.to(LIN), t_bc.to(LIN)
    Wmats = _whiteners(pres)
    D = 9 * K + 8  # poses, velocities, biases, gravity direction
    col = _columns(K, E, dev)
    rows_idx = col[:, :, None].expand(E, N_TAN, N_TAN)
    cols_idx = col[:, None, :].expand(E, N_TAN, N_TAN)

    # bias priors (centred at bg_c / ba_c) and the gauge priors: θg free at
    # init (VertexGDir), pinned for the local windows, where the global
    # gravity alignment must not drift per window
    diag_prior = torch.zeros((D,), dtype=LIN, device=dev)
    diag_prior[9 * K:9 * K + 3] += prior_bg
    diag_prior[9 * K + 3:9 * K + 6] += prior_ba
    diag_prior[9 * K + 6:] += 1e-6 if opt_gravity else FIXED_PRIOR
    diag_prior[:6 * K] += torch.where(p.fixed, FIXED_PRIOR,
                                      0.0).to(LIN).repeat_interleave(6)

    graphs = _GRAPHS.solve(p.R, p.X, pres.dR, fx, fy, cx, cy)
    R, t, X, v, bg, ba = p.R, p.t, p.X, v0, bg0, ba0
    thg = torch.zeros(2, dtype=dt_, device=dev)
    # a fill on the device: `torch.tensor(1e-4, device=...)` copies from
    # pageable host memory and waits for the stream
    lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
    vi_bundle_adjust.intervals = E
    vi_bundle_adjust.state_dim = D
    scalars = (fx, fy, cx, cy, prior_bg, prior_ba)
    cost = None
    for _ in range(n_iters):
        with tracing.span("vi.iteration"):
            # visual part: the Schur-reduced camera system
            with tracing.span("vi.reduce"):
                terms = schur.schur_reduce(R, t, X, p.uv, p.w, fx, fy, cx,
                                           cy, lam, graphs=graphs, dtype=LIN)
            with tracing.span("vi.inertial"):
                r_i, JtJ, Jtr = stage_graphs.run(
                    graphs, "vi_inertial", _inertial_stage, R, t, v, bg, ba,
                    thg, Wmats, R_bc, t_bc, E, *pres)
            with tracing.span("vi.solve"):
                dx = stage_graphs.run(
                    graphs, "vi_solve", _solve, terms.S_off, terms.Hcc_p,
                    terms.rhs_p, JtJ, Jtr, rows_idx, cols_idx, col, bg, ba,
                    bg_c, ba_c, lam, diag_prior, prior_bg, prior_ba)
            with tracing.span("vi.back_substitute"):
                # the candidate is cloned off the update's graph: the cost
                # graph replays before the candidate is read, and a graph
                # captured before the update's (the cost's is) may keep its
                # temporaries where the update's graph keeps its outputs
                R_new, t_new, X_new, v_new, bg_new, ba_new, thg_new = (
                    x.clone() for x in stage_graphs.run(
                        graphs, "vi_update", _update, terms.V, terms.M6,
                        terms.bl_t, p.point_valid, dx, R, t, X, v, bg, ba,
                        thg))
            with tracing.span("vi.cost"):
                # accept/reject on the total cost (the current state's
                # inertial residuals came with the Jacobian); the costs are
                # cloned off the graphs' buffers, as they are handed on
                c0 = stage_graphs.run(
                    graphs, "vi_cost", _total_cost, R, t, X, bg, ba, r_i,
                    p.uv, p.w, bg_c, ba_c, *scalars).clone()
                c1 = stage_graphs.run(
                    graphs, "vi_candidate_cost", _candidate_cost, R_new,
                    t_new, X_new, v_new, bg_new, ba_new, thg_new, p.uv, p.w,
                    bg_c, ba_c, *scalars, Wmats, R_bc, t_bc, E,
                    *pres).clone()
                better = accept(c0, c1)
                R = torch.where(better, R_new, R)
                t = torch.where(better, t_new, t)
                X = torch.where(better, X_new, X)
                v = torch.where(better, v_new, v)
                bg = torch.where(better, bg_new, bg)
                ba = torch.where(better, ba_new, ba)
                thg = torch.where(better, thg_new, thg)
                lam = torch.where(better, lam * 0.3, lam * 5.0).clamp(1e-9,
                                                                      1e3)
                # the accepted state's cost (a rejected trial may be
                # non-finite)
                cost = torch.where(better, c1, c0)
    return VIBAResult(R=R, t=t, X=X, v=v, bg=bg, ba=ba, cost=cost, thg=thg)


def _lin(*xs):
    return tuple(x.to(LIN) for x in xs)


def _inertial_stage(R, t, v, bg, ba, thg, Wmats, R_bc, t_bc, E, *pres):
    """The inertial residuals (E, 9) of the first E intervals and their
    products JᵀJ (E, 26, 26) and Jᵀr (E, 26), in `LIN`."""
    r_i, J_i = _inertial_terms(pre_mod.Preintegrated(*pres),
                               *_lin(R, t, v, bg, ba, thg), Wmats, R_bc,
                               t_bc, n_intervals=E)
    return (r_i, torch.einsum("eai,eaj->eij", J_i, J_i),
            torch.einsum("eai,ea->ei", J_i, r_i))


def _solve(S_off, Hcc_p, rhs_p, JtJ, Jtr, rows_idx, cols_idx, col, bg, ba,
           bg_c, ba_c, lam, diag_prior, prior_bg, prior_ba):
    """The (9K+8)² system, damped, and its step dx, in `LIN`."""
    K, D = Hcc_p.shape[0], diag_prior.shape[0]
    bg, ba, bg_c, ba_c = _lin(bg, ba, bg_c, ba_c)
    # the inertial blocks are added onto the visual ones, in the JAX
    # version's order of the sums
    H = torch.zeros((D, D), dtype=LIN, device=Hcc_p.device)
    b = torch.zeros((D,), dtype=LIN, device=Hcc_p.device)
    H[:6 * K, :6 * K] = -S_off.to(LIN) + torch.block_diag(*Hcc_p.unbind(0))
    b[:6 * K] = rhs_p.reshape(-1)
    H = H.index_put((rows_idx, cols_idx), JtJ, accumulate=True)
    b = b.index_put((col,), Jtr, accumulate=True)
    b = torch.cat([b[:9 * K], b[9 * K:9 * K + 3] + prior_bg * (bg - bg_c),
                   b[9 * K + 3:9 * K + 6] + prior_ba * (ba - ba_c),
                   b[9 * K + 6:]])
    Hd = H + torch.diag(lam * torch.diagonal(H).abs() + diag_prior + 1e-8)
    return -torch.linalg.solve_ex(Hd, b[:, None]).result[:, 0]


def _update(V, M6, bl_t, point_valid, dx, R, t, X, v, bg, ba, thg):
    """The landmark step and the candidate state (in the state's dtype)."""
    K = R.shape[0]
    dxl = schur.landmark_step(V, M6, bl_t, dx[:6 * K].reshape(K, 6),
                              point_valid).to(X.dtype)
    dx = dx.to(R.dtype)
    dxc = dx[:6 * K].reshape(K, 6)
    R_new, t_new = lie.se3_retract(R, t, dxc)
    return (lie.se3_normalize(R_new), t_new, X + dxl,
            v + dx[6 * K:9 * K].reshape(K, 3), bg + dx[9 * K:9 * K + 3],
            ba + dx[9 * K + 3:9 * K + 6], thg + dx[9 * K + 6:])


def _total_cost(R, t, X, bg, ba, rr, uv, w, bg_c, ba_c, fx, fy, cx, cy,
                prior_bg, prior_ba):
    """Robust visual + inertial + prior cost, in `LIN`, of a state whose
    inertial residuals are `rr`."""
    R, t, X, bg, ba, uv, w, bg_c, ba_c = _lin(R, t, X, bg, ba, uv, w, bg_c,
                                              ba_c)
    c_vis = schur.robust_cost(R, t, X, uv, w, fx, fy, cx, cy)
    return (c_vis + torch.sum(rr * rr)
            + prior_bg * torch.sum((bg - bg_c) ** 2)
            + prior_ba * torch.sum((ba - ba_c) ** 2))


def _candidate_cost(R, t, X, v, bg, ba, thg, uv, w, bg_c, ba_c, fx, fy, cx,
                    cy, prior_bg, prior_ba, Wmats, R_bc, t_bc, E, *pres):
    """`_total_cost` of a candidate, its inertial residuals evaluated."""
    rr, _ = _inertial_terms(pre_mod.Preintegrated(*pres),
                            *_lin(R, t, v, bg, ba, thg), Wmats, R_bc, t_bc,
                            n_intervals=E, jacobian=False)
    return _total_cost(R, t, X, bg, ba, rr, uv, w, bg_c, ba_c, fx, fy, cx,
                       cy, prior_bg, prior_ba)


def accept(c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    """The LM accept of one iteration, a device bool (no host sync): the
    candidate's total cost `c1` below the linearization point's `c0`.
    Called through the module's name, so that a wrapper sees each
    iteration's two costs."""
    return c1 < c0


def _count(event: str) -> None:
    """Bump `vi_bundle_adjust.<event>` through the module's name."""
    setattr(vi_bundle_adjust, event, getattr(vi_bundle_adjust, event) + 1)


vi_bundle_adjust.intervals = 0
vi_bundle_adjust.state_dim = 0
vi_bundle_adjust.graph_captures = 0
vi_bundle_adjust.graph_replays = 0
vi_bundle_adjust.eager_stages = 0
# one per process, apart from `backend/ba.py`'s: a stage's capture pays
# off over every later solve of its problem's shape
_GRAPHS = stage_graphs.StageGraphs(_count)
