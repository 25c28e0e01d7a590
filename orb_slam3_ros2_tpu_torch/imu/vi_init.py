"""Visual-inertial initialization (the VIBA1 stage): inertial-only MAP
estimation of {scale, gravity direction, per-keyframe velocities, gyro and
accel biases} with the visual poses fixed.

Port of `orb_slam3_ros2_tpu/imu/vi_init.py`. The problem is one flat
parameter vector θ = [log s, θ_g(2), v(K·3), bg(3), ba(3)] and one residual
vector (every preintegration interval whitened by its covariance, plus the
bias priors), solved by Gauss-Newton with exact forward-mode Jacobians, as
the JAX version does with `jax.jacfwd`. The residuals are written over the
stacked intervals and a batch of parameter vectors at once (the JAX
`vmap`s): `backend/jacobian.jacobian` takes the Jacobian in one
forward-mode pass over P copies of θ, and one evaluation of the three
step-halving candidates gives their costs. The fixed iteration counts
are Python loops; the step-halving choice is a `torch.where`, and the
solves are `*_ex` calls that do not check their input, so nothing reads a
value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orb_slam3_ros2_tpu_torch.backend import jacobian as jac_mod
from orb_slam3_ros2_tpu_torch.geom import lie
from orb_slam3_ros2_tpu_torch.imu import preintegration as pre_mod

G0 = pre_mod.GRAVITY


class VIInitResult(NamedTuple):
    scale: torch.Tensor  # ()
    R_wg: torch.Tensor  # (3, 3) gravity-aligning rotation: g_w = R_wg @ g0
    v: torch.Tensor  # (K, 3) body velocities (metric)
    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    cost: torch.Tensor  # () final whitened cost
    scale_var: torch.Tensor  # () posterior variance of log s (GN Hessian,
    # inflated by the reduced chi²): how observable the scale is in this
    # window; callers gate on it and weight the correction with it


def _unpack(theta, K):
    log_s = theta[0]
    th_g = theta[1:3]
    v = theta[3: 3 + 3 * K].reshape(K, 3)
    bg = theta[3 + 3 * K: 6 + 3 * K]
    ba = theta[6 + 3 * K: 9 + 3 * K]
    return log_s, th_g, v, bg, ba


def _solve(H, b):
    return torch.linalg.solve_ex(H, b[:, None]).result[:, 0]


def _rot_g(th_g):
    """exp([θx, θy, 0]) for a batch of 2-DOF gravity tangents (B, 2): the
    gravity rotations (B, 3, 3)."""
    return lie.so3_exp(torch.cat([th_g, torch.zeros_like(th_g[:, :1])],
                                 dim=1))


def _bootstrap(pres: pre_mod.Preintegrated, R_wb, p_wb, fix_scale: bool,
               n_bg_iters: int = 6):
    """Starting point of the MAP GN (the reference's staged schedule):

    Stage A: GN on bg alone over the rotation residuals (near-linear).
    Stage B: with bg fixed, the Δv/Δp equations are LINEAR in
    (s, g_w, v_0..v_{K-1}): one dense least-squares solve."""
    K = R_wb.shape[0]
    n_int = K - 1
    dev, dt_ = R_wb.device, R_wb.dtype
    R_i, R_j = R_wb[:-1], R_wb[1:]

    def rot_residuals(bgs):
        """(B, 3·n_int) rotation residuals of a batch of biases (B, 3)."""
        dR = pres.dR @ lie.so3_exp(pre_mod._mv(pres.JRg,
                                               bgs[:, None] - pres.bg))
        return lie.so3_log(torch.swapaxes(dR, -1, -2)
                           @ torch.swapaxes(R_i, -1, -2) @ R_j).reshape(
                               bgs.shape[0], -1)

    eye3 = torch.eye(3, dtype=dt_, device=dev)
    bg0 = torch.zeros(3, dtype=dt_, device=dev)
    for _ in range(n_bg_iters):
        r, J = jac_mod.jacobian(rot_residuals, bg0)
        H = J.T @ J + 1e-8 * eye3
        bg0 = bg0 - _solve(H, J.T @ r)

    # stage B: rows per interval, unknowns x = [s, g(3), v(3K)]
    _, dv_all, dp_all = pre_mod.bias_corrected(pres, bg0, pres.ba)
    dt_all = pres.dt
    D = 4 + 3 * K
    A = torch.zeros((n_int, 6, D), dtype=dt_, device=dev)
    ii = torch.arange(n_int, device=dev)
    c3 = torch.arange(3, device=dev)
    # r_p: s·Δp_vis − v_i·dt − ½dt²·g = R_i @ dp
    A[:, 0:3, 0] = p_wb[1:] - p_wb[:-1]
    A[:, 0:3, 1:4] = -0.5 * (dt_all * dt_all)[:, None, None] * eye3
    A[ii[:, None], c3[None], (4 + 3 * ii)[:, None] + c3[None]] = \
        -dt_all[:, None].expand(n_int, 3)
    # r_v: v_j − v_i − dt·g = R_i @ dv
    A[:, 3:6, 1:4] = -dt_all[:, None, None] * eye3
    A[ii[:, None], 3 + c3[None], (4 + 3 * ii)[:, None] + c3[None]] = -1.0
    A[ii[:, None], 3 + c3[None], (7 + 3 * ii)[:, None] + c3[None]] = 1.0
    b = torch.cat([pre_mod._mv(R_i, dp_all), pre_mod._mv(R_i, dv_all)],
                  dim=-1)
    A = A.reshape(-1, D)
    b = b.reshape(-1)
    if fix_scale:
        # pin s = 1: move the s column to the right-hand side
        b = b - A[:, 0]
        A = torch.cat([torch.zeros_like(A[:, :1]), A[:, 1:]], dim=1)
    # mild Tikhonov keeps the few-keyframe case well-posed
    H = A.T @ A + 1e-6 * torch.eye(D, dtype=dt_, device=dev)
    x = _solve(H, A.T @ b)
    s0 = torch.ones_like(x[0]) if fix_scale else x[0].clamp(1e-3, 1e3)
    g0 = x[1:4]
    v0 = x[4:].reshape(K, 3)

    # gravity direction → the minimal 2-DOF rotation taking (0,0,-1) to ĝ
    ghat = g0 / torch.linalg.norm(g0).clamp(min=1e-9)
    z = torch.tensor([0.0, 0.0, -1.0], dtype=dt_, device=dev)
    axis = torch.linalg.cross(z, ghat)
    sin_a = torch.linalg.norm(axis)
    cos_a = torch.dot(z, ghat)
    angle = torch.atan2(sin_a, cos_a)
    axis = axis / sin_a.clamp(min=1e-9)
    th_g = (axis * angle)[:2]
    return torch.log(s0), th_g, v0, bg0


def vi_init(
    pres: pre_mod.Preintegrated,  # stacked, leading dim K-1 (intervals)
    R_wb: torch.Tensor,  # (K, 3, 3) visual body rotations (world arbitrary)
    p_wb: torch.Tensor,  # (K, 3) visual body positions (up to scale)
    prior_bg: float = 1e2,
    prior_ba: float = 1e10,
    n_iters: int = 25,
    fix_scale: bool = False,
    bg_center: Optional[torch.Tensor] = None,
    ba_center: Optional[torch.Tensor] = None,
) -> VIInitResult:
    """Inertial-only MAP estimation with the visual poses fixed.

    `fix_scale=True` (stereo / RGB-D input) pins log s = 0. The default
    accel-bias prior is essentially rigid (the reference's monocular
    InitializeIMU uses priorA = 1e10): with the low excitation of an init
    window a free ba is confounded with scale. Refinement stages pass a
    looser prior, with `bg/ba_center` at the running estimates."""
    K = R_wb.shape[0]
    dev, dt_ = R_wb.device, R_wb.dtype
    zeros3 = torch.zeros(3, dtype=dt_, device=dev)
    bg_c = zeros3 if bg_center is None else bg_center
    ba_c = zeros3 if ba_center is None else ba_center
    g0 = torch.tensor(G0, dtype=dt_, device=dev)

    # whitening: W = chol(info) so ||Wᵀ r||² = rᵀ Σ⁻¹ r
    info = pre_mod.information(pres)
    Wmat = torch.linalg.cholesky_ex(
        0.5 * (info + torch.swapaxes(info, -1, -2))
        + 1e-6 * torch.eye(9, dtype=dt_, device=dev)).L
    sq_bg, sq_ba = prior_bg ** 0.5, prior_ba ** 0.5
    R_i, R_j = R_wb[:-1], R_wb[1:]

    def residuals(thetas):
        """(B, n_res) residuals of a batch of parameter vectors (B, P)."""
        B = thetas.shape[0]
        log_s, th_g = thetas[:, 0], thetas[:, 1:3]
        v = thetas[:, 3: 3 + 3 * K].reshape(B, K, 3)
        bg = thetas[:, 3 + 3 * K: 6 + 3 * K]
        ba = thetas[:, 6 + 3 * K: 9 + 3 * K]
        s = (torch.ones_like(log_s) if fix_scale
             else torch.exp(log_s))[:, None, None]
        g_w = pre_mod._mv(_rot_g(th_g), g0)[:, None]
        r = pre_mod.residual(pres, R_i, s * p_wb[:-1], v[:, :-1], R_j,
                             s * p_wb[1:], v[:, 1:], bg[:, None],
                             ba[:, None], scale=1.0, g_w=g_w)
        r_all = torch.einsum("eji,bej->bei", Wmat, r).reshape(B, -1)
        return torch.cat([r_all, sq_bg * (bg - bg_c), sq_ba * (ba - ba_c)],
                         dim=1)

    log_s0, th_g0, v0, bg0 = _bootstrap(pres, R_wb, p_wb, fix_scale)
    theta = torch.cat([log_s0[None], th_g0, v0.reshape(-1), bg0, zeros3])
    P = theta.shape[0]
    eyeP = torch.eye(P, dtype=dt_, device=dev)
    for _ in range(n_iters):
        # the residuals ride the Jacobian's pass, and the current cost is
        # theirs (the JAX version evaluates both again; same values)
        r, J = jac_mod.jacobian(residuals, theta)
        H = J.T @ J + 1e-6 * eyeP
        dx = -_solve(H, J.T @ r)
        # step-halving safeguard: accept only if the cost decreases
        c0 = torch.sum(r * r)
        cands = torch.stack([theta + dx, theta + 0.5 * dx,
                             theta + 0.25 * dx])
        rc = residuals(cands)
        costs = torch.sum(rc * rc, dim=1)
        best = torch.argmin(costs)
        theta = torch.where(costs[best] < c0, cands[best], theta)
    log_s, th_g, v, bg, ba = _unpack(theta, K)
    # posterior variance of log s: [H^-1]_00 at the optimum (whitened
    # residuals => unit-information Gauss-Markov), inflated by the reduced
    # chi² so windows whose visual poses disagree with the IMU report it
    r, J = jac_mod.jacobian(residuals, theta)
    H = J.T @ J + 1e-9 * eyeP
    var0 = torch.linalg.inv_ex(H).inverse[0, 0]
    dof = max(r.shape[0] - P, 1)
    chi2_red = (torch.sum(r * r) / dof).clamp(min=1.0)
    return VIInitResult(
        scale=torch.ones_like(log_s) if fix_scale else torch.exp(log_s),
        R_wg=_rot_g(th_g[None])[0], v=v, bg=bg, ba=ba,
        cost=torch.sum(r * r), scale_var=var0 * chi2_red)
