"""Plain visual-inertial bundle adjustment, the reference of the program's
inertial global BA (the `vi_gba_map` traffic).

The cost is ORB-SLAM3's FullInertialBA as the program states it for its
solve (`runtime/system.py` `vi_ba2` → `backend/vi_ba.py`):

- Huber reprojection (δ² = 5.991) of every observation at unit weight;
- for each interval between consecutive keyframes, the 9-dimensional
  preintegration residual (r_ΔR, r_Δv, r_Δp) of the body states, with the
  deltas corrected to first order for the change of the biases from their
  linearization values, whitened by the interval's information;
- the bias priors prior_bg ‖bg − bg_c‖² and prior_ba ‖ba − ba_c‖².

The solve is a plain Levenberg-Marquardt, one linearization a step: the
landmarks are eliminated (each 3x3 block damped by λ|diag| + 1e-8 and
inverted under the program's guard, `reference.ba.guarded_inverse`), and
the dense reduced system over [ξ (6K) | v (3K) | bg | ba] is damped by
λ|diag| + the priors + 1e-8 and solved in float64; λ from 1e-4, × 0.3 on
an accepted step and × 5 on a rejected one, clamped to [1e-9, 1e3]; a step
is accepted when the total cost drops. Poses are T_cw with the left
retraction exp(ξ) ∘ T; velocities and biases are additive.

The deltas come from the benchmark's own IMU stream (`reference.preint`);
their bias Jacobians and covariance are worked out here by Forster's
recursion (on-manifold Euler steps, the discrete noise σ²/dt of each
sample). The inertial Jacobians are forward-mode derivatives of this
module's own residual (`torch.func`). Everything is float64; the caller
sets TF32 off. It imports nothing of the program.

Departures, each as the program writes it:
- one bias pair for the whole map (ORB-SLAM3 keeps a bias per keyframe,
  joined by random-walk factors);
- unit information for every observation (ORB-SLAM3 weighs one by its
  pyramid level's σ⁻²) and no robust kernel on the inertial factors;
- the information of an interval is (Σ + 1e-8 I)⁻¹ + 1e-6 I;
- no gravity-direction state: the program pins it (`opt_gravity=False`)
  by a 1e12 prior, this module holds it at g_w = (0, 0, −9.81);
- the fixed keyframes are held exactly (the program pins them by a 1e12
  prior on their diagonal).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from slambench.reference import ba as ref_ba
from slambench.reference import preint as ref_pre

GRAVITY = (0.0, 0.0, -9.81)
COV_EPS, INFO_EPS = 1e-8, 1e-6
N_TAN = 24  # [ξ_i (6), ξ_j (6), v_i (3), v_j (3), bg (3), ba (3)]


class Preint(NamedTuple):
    """Stacked preintegrated intervals (E, ...), float64."""

    dR: torch.Tensor  # (E, 3, 3)
    dv: torch.Tensor  # (E, 3)
    dp: torch.Tensor  # (E, 3)
    dt: torch.Tensor  # (E,)
    JRg: torch.Tensor  # (E, 3, 3)
    Jvg: torch.Tensor
    Jva: torch.Tensor
    Jpg: torch.Tensor
    Jpa: torch.Tensor
    cov: torch.Tensor  # (E, 9, 9) of (δφ, δv, δp)
    bg: torch.Tensor  # (3,) linearization biases
    ba: torch.Tensor


class Problem(NamedTuple):
    vis: ref_ba.Problem  # poses, points, observations, fixed keyframes
    pre: Preint  # interval e joins keyframes e and e + 1
    v: torch.Tensor  # (K, 3) initial velocities
    bg: torch.Tensor  # (3,) initial biases
    ba: torch.Tensor
    bg_c: torch.Tensor  # (3,) prior centres
    ba_c: torch.Tensor
    prior_bg: float
    prior_ba: float
    R_bc: torch.Tensor  # body-from-camera extrinsic
    t_bc: torch.Tensor


def _jr(phi):
    """Right Jacobian of SO(3): J_l(−φ)."""
    return ref_ba.so3_exp_and_jl(-phi)[1]


def bias_jacobians(gyro, acc, dts, mask, bg, ba, noise_gyro, noise_acc):
    """Forster's bias Jacobians and the covariance of (δφ, δv, δp) of E
    intervals at once: gyro, acc (E, M, 3), dts (E, M), mask (E, M) the
    samples each interval holds. Returns (JRg, Jvg, Jva, Jpg, Jpa, cov)."""
    E, M = dts.shape
    f64 = dict(dtype=torch.float64, device=gyro.device)
    I3 = torch.eye(3, **f64).expand(E, 3, 3)
    Z3 = torch.zeros((E, 3, 3), **f64)
    wd = (gyro - bg) * dts[..., None]
    ad = acc - ba
    dRk, _ = ref_ba.so3_exp_and_jl(wd)
    Jr = _jr(wd)
    dR = I3.clone()
    JRg, Jvg, Jva, Jpg, Jpa = Z3, Z3, Z3, Z3, Z3
    cov = torch.zeros((E, 9, 9), **f64)
    for k in range(M):
        on = mask[:, k][:, None, None]
        d = dts[:, k][:, None, None]
        sdt = torch.where(dts[:, k] > 0, 1.0 / dts[:, k].clamp(min=1e-9),
                          0.0)
        ha = dR @ ref_ba.hat(ad[:, k])
        A = torch.cat([
            torch.cat([dRk[:, k].transpose(1, 2), Z3, Z3], 2),
            torch.cat([-ha * d, I3, Z3], 2),
            torch.cat([-0.5 * ha * d * d, I3 * d, I3], 2)], 1)
        B = torch.cat([
            torch.cat([Jr[:, k] * d, Z3], 2),
            torch.cat([Z3, dR * d], 2),
            torch.cat([Z3, 0.5 * dR * d * d], 2)], 1)
        q = torch.cat([(noise_gyro ** 2 * sdt)[:, None].expand(E, 3),
                       (noise_acc ** 2 * sdt)[:, None].expand(E, 3)], 1)
        cov_n = A @ cov @ A.transpose(1, 2) + (B * q[:, None, :]) @ \
            B.transpose(1, 2)
        haJ = ha @ JRg
        new = (dRk[:, k].transpose(1, 2) @ JRg - Jr[:, k] * d,
               Jvg - haJ * d, Jva - dR * d,
               Jpg + Jvg * d - 0.5 * haJ * d * d,
               Jpa + Jva * d - 0.5 * dR * d * d)
        JRg, Jvg, Jva, Jpg, Jpa = (torch.where(on, n, o) for n, o in zip(
            new, (JRg, Jvg, Jva, Jpg, Jpa)))
        cov = torch.where(on, cov_n, cov)
        dR = torch.where(on, dR @ dRk[:, k], dR)
    return JRg, Jvg, Jva, Jpg, Jpa, cov


def preintegrate(imu_t, gyro, acc, kf_times, cap: int, bg, ba,
                 noise_gyro: float, noise_acc: float, device) -> Preint:
    """The intervals between consecutive keyframe times, from the IMU
    stream (imu_t (N,), gyro, acc (N, 3), numpy float64), linearized at
    (bg, ba): the deltas by `reference.preint`, their bias Jacobians and
    covariance by `bias_jacobians`."""
    bg = np.asarray(bg, np.float64)
    ba = np.asarray(ba, np.float64)
    parts = [ref_pre.interval_samples(imu_t, gyro, acc, float(a), float(b),
                                      cap)
             for a, b in zip(kf_times[:-1], kf_times[1:])]
    deltas = [ref_pre.preintegrate(g, a, d, bg, ba) for g, a, d in parts]
    E, M = len(parts), max(d.shape[0] for _, _, d in parts)
    G, A = np.zeros((E, M, 3)), np.zeros((E, M, 3))
    D, on = np.zeros((E, M)), np.zeros((E, M), bool)
    for e, (g, a, d) in enumerate(parts):
        n = d.shape[0]
        G[e, :n], A[e, :n], D[e, :n], on[e, :n] = g, a, d, True
    f = lambda x: torch.as_tensor(x, dtype=torch.float64, device=device)
    jac = bias_jacobians(f(G), f(A), f(D), torch.as_tensor(on, device=device),
                         f(bg), f(ba), noise_gyro, noise_acc)
    stack = lambda i: torch.stack([x[i] for x in deltas]).to(device)
    return Preint(stack(0), stack(1), stack(2), f(D.sum(1)), *jac, f(bg),
                  f(ba))


def whiteners(pre: Preint) -> torch.Tensor:
    """(E, 9, 9) upper-triangular W with ‖W r‖² = rᵀ A r, A = (Σ +
    COV_EPS I)⁻¹ + INFO_EPS I (symmetrized)."""
    eye = torch.eye(9, dtype=torch.float64, device=pre.cov.device)
    info = torch.linalg.inv(pre.cov + COV_EPS * eye)
    A = 0.5 * (info + info.transpose(1, 2)) + INFO_EPS * eye
    return torch.linalg.cholesky(A).transpose(1, 2)


def so3_log(Rm):
    """Log of rotations near the identity, smooth in Rm: the small-angle
    branch takes θ²/6 ≈ (1 − cos θ) / 3."""
    w = torch.stack([Rm[..., 2, 1] - Rm[..., 1, 2],
                     Rm[..., 0, 2] - Rm[..., 2, 0],
                     Rm[..., 1, 0] - Rm[..., 0, 1]], -1)
    c = (Rm[..., 0, 0] + Rm[..., 1, 1] + Rm[..., 2, 2] - 1.0) * 0.5
    s2 = 0.25 * (w * w).sum(-1)
    small = s2 < 1e-12
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    th = torch.atan2(s, c)
    k = torch.where(small, 0.5 + (1.0 - c) / 6.0, th / (2.0 * s))
    return k[..., None] * w


def _left(xi, R, t):
    """exp(ξ) ∘ (R, t), ξ = [ρ, φ] (no re-orthonormalization)."""
    dR, Jl = ref_ba.so3_exp_and_jl(xi[..., 3:])
    return dR @ R, (dR @ t[..., None])[..., 0] + (Jl @ xi[..., :3, None])[
        ..., 0]


def _body(R_cw, t_cw, R_bc, t_bc):
    """(R_wb, p_wb) = T_wc ∘ T_cb."""
    R_wc = R_cw.transpose(-1, -2)
    p_wc = -(R_wc @ t_cw[..., None])[..., 0]
    R_cb = R_bc.transpose(-1, -2)
    t_cb = -(R_cb @ t_bc[..., None])[..., 0]
    return R_wc @ R_cb, p_wc + (R_wc @ t_cb[..., None])[..., 0]


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _residual(tan, R_i, t_i, R_j, t_j, v_i, v_j, dR, dv, dp, dt, JRg, Jvg,
              Jva, Jpg, Jpa, W, bg, ba, bg_lin, ba_lin, R_bc, t_bc, g):
    """The whitened residual (9,) of one interval at its tangent `tan`
    (N_TAN,)."""
    Ri, ti = _left(tan[0:6], R_i, t_i)
    Rj, tj = _left(tan[6:12], R_j, t_j)
    Rwi, pwi = _body(Ri, ti, R_bc, t_bc)
    Rwj, pwj = _body(Rj, tj, R_bc, t_bc)
    vi, vj = v_i + tan[12:15], v_j + tan[15:18]
    dbg = bg + tan[18:21] - bg_lin
    dba = ba + tan[21:24] - ba_lin
    dRc = dR @ ref_ba.so3_exp_and_jl(_mv(JRg, dbg))[0]
    dvc = dv + _mv(Jvg, dbg) + _mv(Jva, dba)
    dpc = dp + _mv(Jpg, dbg) + _mv(Jpa, dba)
    RiT = Rwi.transpose(-1, -2)
    r_R = so3_log(dRc.transpose(-1, -2) @ RiT @ Rwj)
    r_v = _mv(RiT, vj - vi - g * dt) - dvc
    r_p = _mv(RiT, pwj - pwi - vi * dt - 0.5 * g * dt * dt) - dpc
    return _mv(W, torch.cat([r_R, r_v, r_p]))


# per interval; shared: the biases, their linearization values, the
# extrinsic and gravity
_IN = (0,) * 17 + (None,) * 7


def _rows(pre, W, R, t, v):
    E = pre.dt.shape[0]
    return (R[:E], t[:E], R[1:E + 1], t[1:E + 1], v[:E], v[1:E + 1],
            pre.dR, pre.dv, pre.dp, pre.dt, pre.JRg, pre.Jvg, pre.Jva,
            pre.Jpg, pre.Jpa, W)


def inertial(prob: Problem, W, R, t, v, bg, ba, jacobian: bool = True):
    """Whitened residuals (E, 9) and, with `jacobian`, their Jacobians
    (E, 9, N_TAN) in [ξ_i, ξ_j, v_i, v_j, bg, ba]."""
    pre = prob.pre
    args = _rows(pre, W, R, t, v) + (bg, ba, pre.bg, pre.ba, prob.R_bc,
                                     prob.t_bc, R.new_tensor(GRAVITY))
    tan = torch.zeros((pre.dt.shape[0], N_TAN), dtype=R.dtype,
                      device=R.device)
    r = torch.func.vmap(_residual, in_dims=_IN)(tan, *args)
    if not jacobian:
        return r, None
    J = torch.func.vmap(torch.func.jacfwd(_residual), in_dims=_IN)(tan,
                                                                   *args)
    return r, J


def _columns(K: int, E: int, device):
    """(E, N_TAN) state columns of each interval's tangent."""
    i = torch.arange(E, device=device)[:, None]
    a3, a6 = torch.arange(3, device=device), torch.arange(6, device=device)
    return torch.cat([6 * i + a6, 6 * (i + 1) + a6,
                      6 * K + 3 * i + a3, 6 * K + 3 * (i + 1) + a3,
                      (9 * K + a3).expand(E, 3),
                      (9 * K + 3 + a3).expand(E, 3)], 1)


def total_cost(prob: Problem, cam, W, R, t, X, v, bg, ba, w=None,
               r_in: Optional[torch.Tensor] = None):
    """Robust visual + inertial + bias-prior cost (`r_in`: the state's
    whitened inertial residuals, where at hand)."""
    p = prob.vis
    if w is None:
        w = torch.ones(p.k.shape[0], dtype=X.dtype, device=X.device)
    if r_in is None:
        r_in, _ = inertial(prob, W, R, t, v, bg, ba, jacobian=False)
    return (ref_ba.robust_cost(p, R, t, X, w, cam)
            + (r_in * r_in).sum()
            + prob.prior_bg * ((bg - prob.bg_c) ** 2).sum()
            + prob.prior_ba * ((ba - prob.ba_c) ** 2).sum())


def _visual(p: ref_ba.Problem, R, t, X, w, lam, cam, pairs, chunk):
    """The landmark-reduced camera system (6K, 6K) with the camera blocks
    undamped, its right-hand side (K, 6), and what the back-substitution
    reads, as `reference.ba` linearizes (its camera damping is this
    module's, over the whole state)."""
    fx, fy, cx, cy = cam
    K, L = R.shape[0], X.shape[0]
    dt = X.dtype
    r, xc, iz = ref_ba._residuals(p, R, t, X, cam)
    r2 = (r * r).sum(-1) * w
    rn = torch.sqrt(r2.clamp(min=1e-12))
    hw = torch.where(rn <= ref_ba.DELTA, torch.ones_like(rn),
                     ref_ba.DELTA / rn)
    ww = w * hw * (xc[:, 2] > 0.05)
    zero = torch.zeros_like(iz)
    Jp = torch.stack([
        torch.stack([fx * iz, zero, -fx * xc[:, 0] * iz * iz], -1),
        torch.stack([zero, fy * iz, -fy * xc[:, 1] * iz * iz], -1)], -2)
    Jc = torch.cat([Jp, -Jp @ ref_ba.hat(xc)], -1)
    Jx = Jp @ R[p.k]
    Jc_w = Jc * ww[:, None, None]
    Jx_w = Jx * ww[:, None, None]
    z = lambda *s: torch.zeros(s, dtype=dt, device=X.device)
    Hcc = z(K, 6, 6).index_add_(0, p.k, Jc_w.transpose(1, 2) @ Jc)
    bc = z(K, 6).index_add_(0, p.k, (Jc_w.transpose(1, 2)
                                     @ r[..., None])[..., 0])
    Hll = z(L, 3, 3).index_add_(0, p.l, Jx_w.transpose(1, 2) @ Jx)
    bl = z(L, 3).index_add_(0, p.l, (Jx_w.transpose(1, 2)
                                     @ r[..., None])[..., 0])
    Wo = Jc_w.transpose(1, 2) @ Jx
    dl = torch.diagonal(Hll, dim1=1, dim2=2)
    seen = torch.zeros((L,), dtype=torch.bool, device=X.device)
    seen[p.l] = True
    eye3 = torch.eye(3, dtype=dt, device=X.device)
    Hinv = ref_ba.guarded_inverse(torch.where(
        seen[:, None, None], Hll + torch.diag_embed(lam * dl.abs() + 1e-8),
        eye3)).to(dt)
    Y = Hinv[p.l] @ Wo.transpose(1, 2)
    S = z(K * K, 6, 6)
    a_all, b_all = pairs
    for i in range(0, a_all.shape[0], chunk):
        a, b = a_all[i:i + chunk], b_all[i:i + chunk]
        S.index_add_(0, p.k[a] * K + p.k[b], Wo[a] @ Y[b])
    S = -S.reshape(K, K, 6, 6)
    ar = torch.arange(K, device=X.device)
    S[ar, ar] += Hcc
    S = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    hb = (Hinv @ bl[..., None])[..., 0]
    rhs = bc - z(K, 6).index_add_(0, p.k, (Wo @ hb[p.l][..., None])[..., 0])
    return S, rhs, Wo, Hinv, bl, seen


def bundle_adjust(prob: Problem, cam, n_iters: int = 10,
                  chunk: int = 1 << 21, accepts=None):
    """Returns (R, t, X, v, bg, ba, cost, the total cost of each
    iteration's candidate) after `n_iters` LM iterations in float64.

    `accepts`, one bool an iteration, are the accept decisions of the
    solve this one is compared with: where this solve's own decision is a
    near tie (the candidate's cost within `reference.ba.NEAR` of the
    linearization point's), it takes theirs, as `reference.ba` does."""
    f = lambda x: x.to(torch.float64)
    p = prob.vis
    prob = prob._replace(
        vis=p._replace(R=f(p.R), t=f(p.t), X=f(p.X), uv=f(p.uv)),
        v=f(prob.v), bg=f(prob.bg), ba=f(prob.ba), bg_c=f(prob.bg_c),
        ba_c=f(prob.ba_c), R_bc=f(prob.R_bc), t_bc=f(prob.t_bc))
    p = prob.vis
    R, t, X, v, bg, ba = p.R, p.t, p.X, prob.v, prob.bg, prob.ba
    K, L, dev = R.shape[0], X.shape[0], X.device
    E = prob.pre.dt.shape[0]
    D = 9 * K + 6
    W = whiteners(prob.pre)
    col = _columns(K, E, dev)
    pairs = ref_ba._pairs(p.l, L)
    w = torch.ones(p.k.shape[0], dtype=torch.float64, device=dev)
    prior = torch.zeros(D, dtype=torch.float64, device=dev)
    prior[9 * K:9 * K + 3] = prob.prior_bg
    prior[9 * K + 3:] = prob.prior_ba
    free = torch.ones(D, dtype=torch.bool, device=dev)
    free[:6 * K] = ~p.fixed.repeat_interleave(6)
    lam = 1e-4
    cands = []
    for it in range(n_iters):
        S, rhs, Wo, Hinv, bl, seen = _visual(p, R, t, X, w, lam, cam,
                                             pairs, chunk)
        r_in, J = inertial(prob, W, R, t, v, bg, ba)
        H = torch.zeros((D, D), dtype=torch.float64, device=dev)
        H[:6 * K, :6 * K] = S
        H.index_put_((col[:, :, None].expand(E, N_TAN, N_TAN),
                      col[:, None, :].expand(E, N_TAN, N_TAN)),
                     J.transpose(1, 2) @ J, accumulate=True)
        b = torch.zeros(D, dtype=torch.float64, device=dev)
        b[:6 * K] = rhs.reshape(-1)
        b.index_put_((col,), (J.transpose(1, 2) @ r_in[..., None])[..., 0],
                     accumulate=True)
        b[9 * K:9 * K + 3] += prob.prior_bg * (bg - prob.bg_c)
        b[9 * K + 3:] += prob.prior_ba * (ba - prob.ba_c)
        Hd = H + torch.diag(lam * torch.diagonal(H).abs() + prior + 1e-8)
        dx = torch.zeros(D, dtype=torch.float64, device=dev)
        dx[free] = -torch.linalg.solve(Hd[free][:, free], b[free])
        dxc = dx[:6 * K].reshape(K, 6)
        g = bl + torch.zeros((L, 3), dtype=torch.float64,
                             device=dev).index_add_(
            0, p.l, (Wo.transpose(1, 2) @ dxc[p.k][..., None])[..., 0])
        dxl = -(Hinv @ g[..., None])[..., 0] * seen[:, None]
        R1, t1 = ref_ba.retract(R, t, dxc)
        X1 = X + dxl
        v1 = v + dx[6 * K:9 * K].reshape(K, 3)
        bg1 = bg + dx[9 * K:9 * K + 3]
        ba1 = ba + dx[9 * K + 3:]
        c0 = total_cost(prob, cam, W, R, t, X, v, bg, ba, w, r_in)
        c1 = total_cost(prob, cam, W, R1, t1, X1, v1, bg1, ba1, w)
        cands.append(float(c1))
        better = bool(c1 < c0)
        if (accepts is not None and it < len(accepts)
                and abs(float(c1 - c0)) <= ref_ba.NEAR * abs(float(c0))):
            better = bool(accepts[it])
        if better:
            R, t, X, v, bg, ba = R1, t1, X1, v1, bg1, ba1
            lam = min(max(lam * 0.3, 1e-9), 1e3)
        else:
            lam = min(max(lam * 5.0, 1e-9), 1e3)
    return (R, t, X, v, bg, ba,
            total_cost(prob, cam, W, R, t, X, v, bg, ba, w), cands)


def centres(R, t):
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


def gaps(prob: Problem, cam, prog, ref) -> dict:
    """How far the program's end state `prog` = (R, t, X, v, bg, ba) lies
    from the reference's `ref` (its first six): the relative gap of their
    total costs (both evaluated here in float64), the worst keyframe
    centre over the RMS spread of the reference's centres, the worst
    velocity over the reference's RMS speed, the worst rotation in
    radians, and the bias gaps (rad/s, m/s²). No similarity is fitted:
    with the IMU, the fixed keyframe and gravity fix the gauge and the
    scale."""
    f = lambda x: x.to(torch.float64)
    Rp, tp, Xp, vp, bgp, bap = (f(x) for x in prog)
    Rr, tr, Xr, vr, bgr, bar = (f(x) for x in ref[:6])
    p = prob.vis
    prob = prob._replace(
        vis=p._replace(uv=f(p.uv)), bg_c=f(prob.bg_c), ba_c=f(prob.ba_c),
        R_bc=f(prob.R_bc), t_bc=f(prob.t_bc))
    W = whiteners(prob.pre)
    cp = total_cost(prob, cam, W, Rp, tp, Xp, vp, bgp, bap)
    cr = total_cost(prob, cam, W, Rr, tr, Xr, vr, bgr, bar)
    cen_p, cen_r = centres(Rp, tp), centres(Rr, tr)
    spread = (cen_r - cen_r.mean(0)).pow(2).sum(-1).mean().sqrt().clamp(
        min=1e-12)
    speed = vr.pow(2).sum(-1).mean().sqrt().clamp(min=1e-12)
    rot = torch.linalg.matrix_norm(Rp - Rr) / math.sqrt(2)
    return dict(
        cost_gap=float((cp - cr).abs() / cr.abs().clamp(min=1e-30)),
        pose_gap=float((cen_p - cen_r).norm(dim=-1).max() / spread),
        velocity_gap=float((vp - vr).norm(dim=-1).max() / speed),
        rot_gap=float(rot.max()),
        bg_gap=float((bgp - bgr).norm()), ba_gap=float((bap - bar).norm()),
        cost_prog=float(cp), cost_ref=float(cr))
