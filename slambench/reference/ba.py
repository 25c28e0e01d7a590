"""Plain bundle adjustment, the reference of the program's BA solves (the
global BA of the `gba_map` traffic and the local BA of a keyframe
insertion).

The semantics are those the program states for its solve: robust (Huber,
δ² = 5.991) Levenberg-Marquardt over keyframe poses T_cw and world points,
the left retraction exp(ξ) ∘ T with the rotation re-orthonormalized, one
linearization a step, λ from 1e-4 (× 0.3 on an accepted step, × 5 on a
rejected one, clamped to [1e-9, 1e3]), the landmark blocks damped by
λ|diag| + 1e-8 and the camera blocks by λ|diag| + 1e-9, fixed poses
pinned by a 1e12 prior, a step accepted only when the robust cost drops,
the χ² gate (with depth > 0.05) refreshed every 5 iterations after the
first, and each landmark block inverted under the guard the program
states for it (`guarded_inverse`).

The formulation is this module's own: a list of observations instead of
dense (K, L) planes, each landmark's 3x3 block inverted in float64, and
the reduced camera system built from the pairs of observations that share
a landmark, block by block, with its 6x6 blocks added where they belong.
It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

CHI2 = 5.991
DELTA = math.sqrt(CHI2)
PRIOR = 1e12
NEAR = 1e-4  # a relative margin that float32 round-off can cross


class Problem(NamedTuple):
    R: torch.Tensor  # (K, 3, 3) T_cw
    t: torch.Tensor  # (K, 3)
    X: torch.Tensor  # (L, 3)
    k: torch.Tensor  # (n,) long keyframe of each observation
    l: torch.Tensor  # (n,) long landmark of each observation
    uv: torch.Tensor  # (n, 2) undistorted pixels
    fixed: torch.Tensor  # (K,) bool


def hat(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def so3_exp_and_jl(phi):
    """(exp(φ), left Jacobian J_l(φ)) by Rodrigues, Taylor below 1e-8."""
    th2 = (phi * phi).sum(-1)
    small = th2 < 1e-8
    ts = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(ts)
    a = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / ts)
    c = torch.where(small, 1 / 6.0 - th2 / 120, (1 - a) / ts)
    P = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(P.shape)
    PP = P @ P
    return (eye + a[..., None, None] * P + b[..., None, None] * PP,
            eye + b[..., None, None] * P + c[..., None, None] * PP)


def retract(R, t, xi):
    """exp(ξ) ∘ (R, t) with ξ = [ρ, φ], then Gram-Schmidt on R."""
    dR, Jl = so3_exp_and_jl(xi[..., 3:])
    dt = (Jl @ xi[..., :3, None])[..., 0]
    R2 = dR @ R
    t2 = (dR @ t[..., None])[..., 0] + dt
    x = R2[..., :, 0]
    y = R2[..., :, 1]
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp(min=1e-12)
    y = y - (x * y).sum(-1, keepdim=True) * x
    y = y / torch.linalg.norm(y, dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.stack([x, y, torch.linalg.cross(x, y, dim=-1)], -1), t2


def _residuals(p: Problem, R, t, X, cam):
    fx, fy, cx, cy = cam
    xc = (R[p.k] @ X[p.l][..., None])[..., 0] + t[p.k]
    z = xc[:, 2]
    iz = 1.0 / torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    r = torch.stack([fx * xc[:, 0] * iz + cx, fy * xc[:, 1] * iz + cy],
                    -1) - p.uv
    return r, xc, iz


def robust_cost(p: Problem, R, t, X, w, cam):
    r, _, _ = _residuals(p, R, t, X, cam)
    r2 = (r * r).sum(-1) * w
    rn = torch.sqrt(r2.clamp(min=1e-12))
    return (torch.where(r2 <= CHI2, r2, 2 * DELTA * rn - CHI2)
            * (w > 0)).sum()


def _pairs(l: torch.Tensor, L: int):
    """Observation pairs (a, b) that share a landmark, a and b running
    over every observation of it (both orders and a == b)."""
    order = torch.argsort(l, stable=True)
    ls = l[order]
    counts = torch.bincount(ls, minlength=L)
    start = torch.cumsum(counts, 0) - counts
    reps = counts[ls]  # partners of each sorted observation
    a_sorted = torch.repeat_interleave(
        torch.arange(ls.shape[0], device=l.device), reps)
    first = torch.cumsum(reps, 0) - reps
    within = torch.arange(a_sorted.shape[0], device=l.device) \
        - first[a_sorted]
    b_sorted = start[ls[a_sorted]] + within
    return order[a_sorted], order[b_sorted]


def _linearize(p: Problem, R, t, X, w, lam, cam, pairs, chunk: int):
    fx, fy, cx, cy = cam
    K, L = R.shape[0], X.shape[0]
    dt = X.dtype
    r, xc, iz = _residuals(p, R, t, X, cam)
    r2 = (r * r).sum(-1) * w
    rn = torch.sqrt(r2.clamp(min=1e-12))
    cost0 = (torch.where(r2 <= CHI2, r2, 2 * DELTA * rn - CHI2)
             * (w > 0)).sum()
    hw = torch.where(rn <= DELTA, torch.ones_like(rn), DELTA / rn)
    ww = w * hw * (xc[:, 2] > 0.05)
    zero = torch.zeros_like(iz)
    Jp = torch.stack([
        torch.stack([fx * iz, zero, -fx * xc[:, 0] * iz * iz], -1),
        torch.stack([zero, fy * iz, -fy * xc[:, 1] * iz * iz], -1)], -2)
    Jc = torch.cat([Jp, -Jp @ hat(xc)], -1)  # (n, 2, 6)
    Jx = Jp @ R[p.k]  # (n, 2, 3)
    Jc_w = Jc * ww[:, None, None]
    Jx_w = Jx * ww[:, None, None]
    Hcc = torch.zeros((K, 6, 6), dtype=dt, device=X.device).index_add_(
        0, p.k, Jc_w.transpose(1, 2) @ Jc)
    bc = torch.zeros((K, 6), dtype=dt, device=X.device).index_add_(
        0, p.k, (Jc_w.transpose(1, 2) @ r[..., None])[..., 0])
    Hll = torch.zeros((L, 3, 3), dtype=dt, device=X.device).index_add_(
        0, p.l, Jx_w.transpose(1, 2) @ Jx)
    bl = torch.zeros((L, 3), dtype=dt, device=X.device).index_add_(
        0, p.l, (Jx_w.transpose(1, 2) @ r[..., None])[..., 0])
    Wo = Jc_w.transpose(1, 2) @ Jx  # (n, 6, 3)
    eye3 = torch.eye(3, dtype=dt, device=X.device)
    dl = torch.diagonal(Hll, dim1=1, dim2=2)
    Hll_d = Hll + torch.diag_embed(lam * dl.abs() + 1e-8)
    seen = torch.zeros((L,), dtype=torch.bool, device=X.device)
    seen[p.l] = True
    Hinv = guarded_inverse(torch.where(seen[:, None, None], Hll_d,
                                       eye3)).to(dt)
    Y = Hinv[p.l] @ Wo.transpose(1, 2)  # (n, 3, 6) = H⁻¹ Wᵀ
    S = torch.zeros((K * K, 6, 6), dtype=dt, device=X.device)
    a_all, b_all = pairs
    for i in range(0, a_all.shape[0], chunk):
        a, b = a_all[i:i + chunk], b_all[i:i + chunk]
        S.index_add_(0, p.k[a] * K + p.k[b], Wo[a] @ Y[b])
    dc = torch.diagonal(Hcc, dim1=1, dim2=2)
    prior = torch.where(p.fixed, PRIOR, 0.0).to(dt)
    Hcc_d = Hcc + torch.diag_embed(lam * dc.abs() + prior[:, None] + 1e-9)
    S = -S.reshape(K, K, 6, 6)
    ar = torch.arange(K, device=X.device)
    S[ar, ar] += Hcc_d
    S = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    hb = (Hinv @ bl[..., None])[..., 0]  # (L, 3)
    rhs = bc - torch.zeros((K, 6), dtype=dt, device=X.device).index_add_(
        0, p.k, (Wo @ hb[p.l][..., None])[..., 0])
    return S, rhs, Wo, Hinv, bl, seen, cost0


def bundle_adjust(p: Problem, cam, n_iters: int = 8, dtype=torch.float64,
                  reclassify_every: int = 5, chunk: int = 1 << 21,
                  accepts=None, gates=None):
    """Returns (R, t, X, w_active, cost, the robust cost of each
    iteration's candidate) after `n_iters` LM iterations,
    computed in `dtype` (the caller sets TF32 on or off around it).

    `accepts`, one bool an iteration, are the accept decisions of the
    solve this one is compared with, and `gates` the (K, L) weights it
    took at each refresh of its χ² gate: where this solve's own decision
    is a near tie (a cost change, or an observation's χ² against the
    threshold, within NEAR of it), it takes theirs. Near the minimum a
    step's cost change sits inside the rounding of the costs, and a
    decision that goes the other way (λ × 5 instead of × 0.3, one
    observation in or out) sends the rest of the path elsewhere; a
    decision that is no tie stays this solve's own, so a solve that
    rejects good steps or gates out good observations still parts."""
    cast = lambda v: v.to(dtype)
    R, t, X = cast(p.R), cast(p.t), cast(p.X)
    p = p._replace(R=R, t=t, X=X, uv=cast(p.uv))
    K, L = R.shape[0], X.shape[0]
    pairs = _pairs(p.l, L)
    w_base = torch.ones(p.k.shape[0], dtype=dtype, device=X.device)
    w = w_base
    lam = 1e-4
    cands = []
    for it in range(n_iters):
        if it > 0 and it % reclassify_every == 0:
            r, xc, _ = _residuals(p, R, t, X, cam)
            chi2 = (r * r).sum(-1) * w_base
            keep = (chi2 <= CHI2) & (xc[:, 2] > 0.05)
            k = it // reclassify_every - 1
            if gates is not None and k < len(gates):
                near = (chi2 - CHI2).abs() <= NEAR * CHI2
                keep = torch.where(near, gates[k][p.k, p.l] > 0, keep)
            w = w_base * keep
        S, rhs, Wo, Hinv, bl, seen, cost0 = _linearize(
            p, R, t, X, w, lam, cam, pairs, chunk)
        sol = torch.linalg.solve(S.to(torch.float64),
                                 rhs.reshape(-1, 1).to(torch.float64))
        dxc = (-sol.reshape(K, 6)).to(dtype)
        g = bl + torch.zeros((L, 3), dtype=dtype,
                             device=X.device).index_add_(
            0, p.l, (Wo.transpose(1, 2) @ dxc[p.k][..., None])[..., 0])
        dxl = -(Hinv @ g[..., None])[..., 0] * seen[:, None]
        R1, t1 = retract(R, t, dxc)
        X1 = X + dxl
        cost1 = robust_cost(p, R1, t1, X1, w, cam)
        cands.append(float(cost1))
        better = bool(cost1 < cost0)
        if (accepts is not None and it < len(accepts)
                and abs(float(cost1 - cost0)) <= NEAR * abs(float(cost0))):
            better = bool(accepts[it])
        if better:
            R, t, X = R1, t1, X1
            lam = min(max(lam * 0.3, 1e-9), 1e3)
        else:
            lam = min(max(lam * 5.0, 1e-9), 1e3)
    return R, t, X, w, robust_cost(p, R, t, X, w, cam), cands


def umeyama(src: torch.Tensor, dst: torch.Tensor):
    """Similarity (s, R, t) with dst ≈ s R src + t (least squares)."""
    src, dst = src.double(), dst.double()
    mu_s, mu_d = src.mean(0), dst.mean(0)
    a, b = src - mu_s, dst - mu_d
    U, D, Vt = torch.linalg.svd(b.T @ a / a.shape[0])
    S = torch.eye(3, dtype=torch.float64, device=src.device)
    if torch.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = (D * torch.diagonal(S)).sum() / (a * a).sum(-1).mean().clamp(
        min=1e-30)
    return s, R, mu_d - s * R @ mu_s


def step_gap(prog_cands, ref_cands) -> float:
    """The relative gap of the first LM candidate's robust cost, the
    program's (as it evaluated it) against the reference's: the first
    step's linearization, Schur reduction, camera solve and back
    substitution, before the solve's later, flatter steps, whose weak
    directions (a window's free scale) float32 leaves to round-off."""
    if not prog_cands:
        return float("inf")  # the solve took no step
    c_p, c_r = float(prog_cands[0]), float(ref_cands[0])
    return abs(c_p - c_r) / max(abs(c_r), 1e-30)


def gaps(p: Problem, cam, prog, ref, moved: torch.Tensor,
         kf: torch.Tensor) -> dict:
    """How far the program's solve `prog` = (R, t, X) lies from the
    reference's `ref` = (R, t, X, w, cost): the relative gap of the two
    robust costs (both evaluated here in float64 under the reference's
    final gate), the worst keyframe centre and the worst moved landmark
    after the similarity that maps the program's keyframe centres onto
    the reference's, each over the RMS spread of the reference's centres,
    and the worst rotation gap in radians, over the keyframes `kf` and the
    landmarks `moved` that the observations pin down (`pinned`)."""
    f = lambda v: v.double()
    Rp, tp, Xp = (f(v) for v in prog)
    Rr, tr, Xr, w = ref[:4]
    Rr, tr, Xr, w = f(Rr), f(tr), f(Xr), f(w)
    pd = p._replace(uv=f(p.uv))
    cp = robust_cost(pd, Rp, tp, Xp, w, cam)
    cr = robust_cost(pd, Rr, tr, Xr, w, cam)
    Rr_all, tr_all, Rp_all, tp_all = Rr, tr, Rp, tp
    Rp, tp, Rr, tr = Rp[kf], tp[kf], Rr[kf], tr[kf]
    cen_p = -(Rp.transpose(1, 2) @ tp[..., None])[..., 0]
    cen_r = -(Rr.transpose(1, 2) @ tr[..., None])[..., 0]
    s, Ra, ta = umeyama(cen_p, cen_r)
    spread = (cen_r - cen_r.mean(0)).pow(2).sum(-1).mean().sqrt().clamp(
        min=1e-12)
    cen_a = s * cen_p @ Ra.T + ta
    pin = pinned(pd, Rr_all, tr_all, Xr, w, cam)
    moved = moved & pin
    # the robust costs over the observations of pinned landmarks only
    wp = w * pin[p.l]
    cpp = robust_cost(pd, Rp_all, tp_all, Xp, wp, cam)
    crp = robust_cost(pd, Rr_all, tr_all, Xr, wp, cam)
    X_a = s * Xp[moved] @ Ra.T + ta
    rot = torch.linalg.matrix_norm(Rp @ Ra.T - Rr) / math.sqrt(2)
    return dict(
        cost_gap=float((cp - cr).abs() / cr.abs().clamp(min=1e-30)),
        pinned_cost_gap=float((cpp - crp).abs()
                              / crp.abs().clamp(min=1e-30)),
        pose_gap=float((cen_a - cen_r).norm(dim=-1).max() / spread),
        point_gap=float(torch.cat([(X_a - Xr[moved]).norm(dim=-1),
                                   X_a.new_zeros(1)]).max() / spread),
        n_pinned=int(moved.sum()),
        rot_gap=float(rot.max()),
        cost_prog=float(cp), cost_ref=float(cr))


PINNED_RATIO = 1e-4


def pinned(p: Problem, R, t, X, w, cam) -> torch.Tensor:
    """Landmarks whose information matrix at the solution (the active
    observations' J_xᵀ J_x, Jacobi-normalized) has its smallest eigenvalue
    at least PINNED_RATIO of its largest. The rest (seen along nearly one
    ray) move along their ray by round-off and damping alone: the
    program's own landmark solve floors such pivots (a modified Cholesky),
    so their positions are not a reading of the solve."""
    fx, fy, _, _ = cam
    _, xc, iz = _residuals(p, R, t, X, cam)
    zero = torch.zeros_like(iz)
    Jp = torch.stack([
        torch.stack([fx * iz, zero, -fx * xc[:, 0] * iz * iz], -1),
        torch.stack([zero, fy * iz, -fy * xc[:, 1] * iz * iz], -1)], -2)
    Jx = Jp @ R[p.k]
    ww = w * (xc[:, 2] > 0.05)
    L = X.shape[0]
    H = torch.zeros((L, 3, 3), dtype=X.dtype, device=X.device).index_add_(
        0, p.l, (Jx * ww[:, None, None]).transpose(1, 2) @ Jx)
    d = torch.diagonal(H, dim1=1, dim2=2).clamp(min=1e-300).rsqrt()
    Hn = H * d[:, :, None] * d[:, None, :]
    ev = torch.linalg.eigvalsh(Hn)
    return ev[:, 0] >= PINNED_RATIO * ev[:, 2].clamp(min=1e-300)


PIVOT_FLOOR = 1e-6


def guarded_inverse(H: torch.Tensor) -> torch.Tensor:
    """(L, 3, 3) inverses of the damped landmark blocks, with the guard the
    program states for them: the block is Jacobi-normalized to a unit
    diagonal, its Cholesky pivots are floored at PIVOT_FLOOR and the
    (2, 1) factor clipped to [-2, 2], and the inverse is that of the
    guarded factor. A block seen along nearly one ray then keeps a bounded
    inverse; a well-conditioned one gets its exact inverse. Float64."""
    H = H.double()
    d = torch.diagonal(H, dim1=1, dim2=2).clamp(min=1e-30).rsqrt()
    ab = H[:, 0, 1] * d[:, 0] * d[:, 1]
    ac = H[:, 0, 2] * d[:, 0] * d[:, 2]
    bc = H[:, 1, 2] * d[:, 1] * d[:, 2]
    l11 = torch.sqrt((1.0 - ab * ab).clamp(min=PIVOT_FLOOR))
    l21 = ((bc - ac * ab) / l11).clamp(-2.0, 2.0)
    l22 = torch.sqrt((1.0 - ac * ac - l21 * l21).clamp(min=PIVOT_FLOOR))
    one, zero = torch.ones_like(ab), torch.zeros_like(ab)
    Lf = torch.stack([torch.stack([one, zero, zero], -1),
                      torch.stack([ab, l11, zero], -1),
                      torch.stack([ac, l21, l22], -1)], -2)
    Li = torch.linalg.solve_triangular(
        Lf, torch.eye(3, dtype=H.dtype, device=H.device).expand_as(Lf),
        upper=False)
    D = torch.diag_embed(d)
    return D @ Li.transpose(1, 2) @ Li @ D
