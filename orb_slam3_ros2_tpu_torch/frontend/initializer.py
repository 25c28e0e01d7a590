"""Monocular map initialization: parallel-hypothesis RANSAC for homography and
fundamental matrix, model selection, pose recovery, triangulation.

Port of `orb_slam3_ros2_tpu/frontend/initializer.py`. All RANSAC hypotheses
are scored at once (a batched SVD builds every model), and the 12 candidate
motions (4 from E, 8 from H) are triangulated and vetted as one batch.

The sampling is split from the rest: `initialize` draws the hypotheses'
sample indices from an explicit `torch.Generator` on the matches' device
and hands them to
`initialize_from_samples`, which is deterministic. A test can feed the
latter the JAX package's own samples, since the two packages' random
generators cannot draw the same numbers.

SVD sign conventions differ between libraries: H and F are defined up to
scale, so their scores do not depend on the sign, and the candidate motion
sets from `_motions_from_e` / `_motions_from_h` are the same sets whatever
the signs, though possibly listed in another order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

N_HYPO = 192  # RANSAC hypotheses scored in parallel (reference uses 200 iters)
CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991  # per-point score cap, as in the reference's CheckHomography


class InitResult(NamedTuple):
    ok: torch.Tensor  # () bool — initialization accepted
    R: torch.Tensor  # (3, 3) — T_c2c1 rotation (frame2 from frame1)
    t: torch.Tensor  # (3,) — unit-norm translation
    X: torch.Tensor  # (N, 3) — triangulated points in frame-1 camera coords
    good: torch.Tensor  # (N,) bool — triangulated & vetted correspondences
    used_h: torch.Tensor  # () bool — homography model chosen
    n_good: torch.Tensor  # () int32


def _normalize_points(x, mask):
    """Hartley normalization: zero-mean, mean abs deviation 1 (masked)."""
    w = mask.to(x.dtype)[:, None]
    wsum = mask.sum().to(x.dtype).clamp(min=1.0)
    mu = (x * w).sum(0) / wsum
    d = ((x - mu).abs() * w).sum(0) / wsum
    s = 1.0 / d.clamp(min=1e-8)
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([
        torch.stack([s[0], zero, -mu[0] * s[0]]),
        torch.stack([zero, s[1], -mu[1] * s[1]]),
        torch.stack([zero, zero, one]),
    ])
    return (x - mu) * s, T


def sample_indices(gen: torch.Generator, mask: torch.Tensor, n_samples: int,
                   k: int) -> torch.Tensor:
    """(n_samples, k) int64 indices drawn uniformly, with replacement, from
    the valid matches (the JAX version draws `jax.random.categorical` over
    the same uniform logits). `gen` lies on the mask's device, so the draw
    needs no host round trip."""
    probs = mask.to(torch.float32).expand(n_samples, -1).contiguous()
    return torch.multinomial(probs, k, replacement=True, generator=gen)


def _null_vector(A):
    """Last right singular vector of each (.., m, 9) system."""
    return torch.linalg.svd(A, full_matrices=True).Vh[..., -1, :]


def _fit_h(x1, x2, idx):
    """Batched 4-point DLT homographies. x*: (N, 2); idx: (NH, 4)."""
    p1, p2 = x1[idx], x2[idx]
    u, v = p1[..., 0], p1[..., 1]
    up, vp = p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(u), torch.ones_like(u)
    row1 = torch.stack([z, z, z, -u, -v, -o, vp * u, vp * v, vp], dim=-1)
    row2 = torch.stack([u, v, o, z, z, z, -up * u, -up * v, -up], dim=-1)
    A = torch.cat([row1, row2], dim=1)  # (NH, 8, 9)
    return _null_vector(A).reshape(-1, 3, 3)


def _fit_f(x1, x2, idx):
    """Batched 8-point fundamental matrices with rank-2 projection."""
    p1, p2 = x1[idx], x2[idx]
    u, v = p1[..., 0], p1[..., 1]
    up, vp = p2[..., 0], p2[..., 1]
    o = torch.ones_like(u)
    A = torch.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v, o], dim=-1)
    F = _null_vector(A).reshape(-1, 3, 3)
    uf, sf, vtf = torch.linalg.svd(F)
    sf = torch.cat([sf[:, :2], torch.zeros_like(sf[:, 2:])], dim=1)
    return uf @ (sf[:, :, None] * vtf)


def _homog(x):
    return torch.cat([x, torch.ones_like(x[:, :1])], dim=-1)


def _score_h(H, x1, x2, mask):
    """Symmetric transfer error score (reference's CheckHomography)."""
    Hinv = torch.linalg.inv_ex(H).inverse
    h1, h2 = _homog(x1), _homog(x2)

    def transfer(M, src, dst):
        p = torch.einsum("hij,nj->hni", M, src)
        z = p[..., 2:]
        p = p[..., :2] / torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8),
                                     z)
        return ((p - dst[None]) ** 2).sum(-1)  # (NH, N)

    e12 = transfer(H, h1, x2)
    e21 = transfer(Hinv, h2, x1)
    s = torch.where(e12 < CHI2_H, SCORE_TH - e12, 0.0) + torch.where(
        e21 < CHI2_H, SCORE_TH - e21, 0.0)
    inl = (e12 < CHI2_H) & (e21 < CHI2_H) & mask[None]
    return (s * mask[None]).sum(-1), inl


def _score_f(F, x1, x2, mask):
    """Epipolar (Sampson-per-side) score (reference's CheckFundamental)."""
    h1, h2 = _homog(x1), _homog(x2)
    Fx1 = torch.einsum("hij,nj->hni", F, h1)  # lines in image 2
    Ftx2 = torch.einsum("hji,nj->hni", F, h2)  # lines in image 1
    x2Fx1 = torch.einsum("ni,hni->hn", h2, Fx1)
    d2_2 = x2Fx1 ** 2 / (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2).clamp(min=1e-12)
    d2_1 = x2Fx1 ** 2 / (Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2).clamp(
        min=1e-12)
    s = torch.where(d2_2 < CHI2_F, SCORE_TH - d2_2, 0.0) + torch.where(
        d2_1 < CHI2_F, SCORE_TH - d2_1, 0.0)
    inl = (d2_2 < CHI2_F) & (d2_1 < CHI2_F) & mask[None]
    return (s * mask[None]).sum(-1), inl


def _dlt_rows(P, x):
    """P (..., 3, 4), x (N, 3) -> (..., N, 2, 4) linear triangulation rows."""
    r1 = x[:, 0:1, None] * P[..., None, 2:3, :] - P[..., None, 0:1, :]
    r2 = x[:, 1:2, None] * P[..., None, 2:3, :] - P[..., None, 1:2, :]
    return torch.cat([r1, r2], dim=-2)


def _triangulate(R, t, x1n, x2n):
    """Linear DLT triangulation for a batch of candidate motions.

    R (C, 3, 3), t (C, 3); x*n: (N, 3) unit-z rays in each camera; P1 =
    [I|0], P2 = [R|t]. Returns X (C, N, 3) in camera-1 coordinates."""
    C, N = R.shape[0], x1n.shape[0]
    P1 = torch.cat([torch.eye(3, dtype=R.dtype, device=R.device),
                    torch.zeros((3, 1), dtype=R.dtype, device=R.device)], 1)
    P2 = torch.cat([R, t[:, :, None]], dim=2)  # (C, 3, 4)
    A = torch.cat([_dlt_rows(P1, x1n).expand(C, N, 2, 4),
                   _dlt_rows(P2, x2n)], dim=-2)  # (C, N, 4, 4)
    Xh = torch.linalg.svd(A).Vh[..., -1, :]
    w = Xh[..., 3:]
    return Xh[..., :3] / torch.where(w.abs() < 1e-10,
                                     torch.full_like(w, 1e-10), w)


def _vet_motion(R, t, x1n, x2n, mask, fx, reproj_th_px: float = 4.0,
                strong_parallax_cos: float = 0.9998):
    """Triangulate and count good points for a batch of (R, t) candidates.

    Returns (X (C, N, 3), good (C, N), n_strong (C,)): `n_strong` counts good
    points whose ray parallax exceeds the strong threshold (~1.15 deg), the
    global acceptance statistic of upstream CheckRT."""
    X = _triangulate(R, t, x1n, x2n)
    z1 = X[..., 2]
    Xc2 = torch.einsum("cij,cnj->cni", R, X) + t[:, None, :]
    z2 = Xc2[..., 2]
    r1 = X / torch.linalg.norm(X, dim=-1, keepdim=True).clamp(min=1e-12)
    c2 = -torch.einsum("cji,cj->ci", R, t)  # camera-2 centre, R^T t
    d2 = X - c2[:, None, :]
    r2 = d2 / torch.linalg.norm(d2, dim=-1, keepdim=True).clamp(min=1e-12)
    cos_par = (r1 * r2).sum(-1)

    def safe(z):
        z = z[..., None]
        return torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)

    e1 = X[..., :2] / safe(z1) - x1n[None, :, :2]
    e2 = Xc2[..., :2] / safe(z2) - x2n[None, :, :2]
    err_px = fx * torch.maximum(torch.linalg.norm(e1, dim=-1),
                                torch.linalg.norm(e2, dim=-1))
    good = ((z1 > 0.0) & (z2 > 0.0) & (cos_par < 0.99998)
            & (err_px < reproj_th_px) & mask[None])
    n_strong = (good & (cos_par < strong_parallax_cos)).sum(-1)
    return X, good, n_strong


def _motions_from_e(E):
    """4 candidate (R, t) from an essential matrix."""
    u, _, vt = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    t = u[:, 2]
    t = t / torch.linalg.norm(t).clamp(min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _motions_from_h(H):
    """8 candidate (R, t) from a homography (Faugeras SVD decomposition)."""
    U, s, Vt = torch.linalg.svd(H)
    d1, d2, d3 = s[0], s[1], s[2]
    sdet = torch.linalg.det(U) * torch.linalg.det(Vt)
    den13 = (d1 * d1 - d3 * d3).clamp(min=1e-12)
    x1 = torch.sqrt((d1 * d1 - d2 * d2).clamp(min=0.0) / den13)
    x3 = torch.sqrt((d2 * d2 - d3 * d3).clamp(min=0.0) / den13)
    prod = ((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)).clamp(min=0.0)
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    Rs, ts = [], []
    # case d' = +d2
    sin_t = torch.sqrt(prod) / ((d1 + d3) * d2).clamp(min=1e-12)
    cos_t = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2).clamp(min=1e-12)
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = e1 * e3 * sin_t
            Rp = torch.stack([torch.stack([cos_t, zero, -st]),
                              torch.stack([zero, one, zero]),
                              torch.stack([st, zero, cos_t])])
            tp = (d1 - d3) * torch.stack([e1 * x1, zero, -e3 * x3])
            t = U @ tp
            Rs.append(sdet * U @ Rp @ Vt)
            ts.append(t / torch.linalg.norm(t).clamp(min=1e-12))
    # case d' = -d2
    sin_p = torch.sqrt(prod) / ((d1 - d3) * d2).clamp(min=1e-12)
    cos_p = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2).clamp(min=1e-12)
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            sp = e1 * e3 * sin_p
            Rp = torch.stack([torch.stack([cos_p, zero, sp]),
                              torch.stack([zero, -one, zero]),
                              torch.stack([sp, zero, -cos_p])])
            tp = (d1 + d3) * torch.stack([e1 * x1, zero, e3 * x3])
            t = U @ tp
            Rs.append(sdet * U @ Rp @ Vt)
            ts.append(t / torch.linalg.norm(t).clamp(min=1e-12))
    return torch.stack(Rs), torch.stack(ts)


def initialize_from_samples(
    uv1: torch.Tensor,  # (N, 2) undistorted pixels, frame 1
    uv2: torch.Tensor,  # (N, 2) matched undistorted pixels, frame 2
    mask: torch.Tensor,  # (N,) valid match
    idx_h: torch.Tensor,  # (N_HYPO, 4) sample indices of the H hypotheses
    idx_f: torch.Tensor,  # (N_HYPO, 8) sample indices of the F hypotheses
    fx: float, fy: float, cx: float, cy: float,
    min_good: int = 50,
    # cos(1.15 deg): slightly past upstream's 1.0-deg minParallax, because
    # this parallax statistic comes from noisy triangulated points (pinned
    # by test_init_rejects_low_parallax_baseline)
    min_parallax_cos: float = 0.9998,
    h_ratio_th: float = 0.45,
) -> InitResult:
    """Two-view reconstruction from given RANSAC samples."""
    x1n = _homog(torch.stack([(uv1[:, 0] - cx) / fx, (uv1[:, 1] - cy) / fy],
                             -1))
    x2n = _homog(torch.stack([(uv2[:, 0] - cx) / fx, (uv2[:, 1] - cy) / fy],
                             -1))
    # Hartley-normalized pixel coords for conditioning
    p1, T1 = _normalize_points(uv1, mask)
    p2, T2 = _normalize_points(uv2, mask)
    idx_h, idx_f = idx_h.long(), idx_f.long()

    Hn = _fit_h(p1, p2, idx_h)
    Fn = _fit_f(p1, p2, idx_f)
    # denormalize: H = T2^-1 Hn T1 ; F = T2^T Fn T1
    H = torch.linalg.inv(T2)[None] @ Hn @ T1[None]
    F = T2.T[None] @ Fn @ T1[None]

    sh, _ = _score_h(H, uv1, uv2, mask)
    sf, _ = _score_f(F, uv1, uv2, mask)
    best_h = torch.argmax(sh)
    best_f = torch.argmax(sf)
    SH, SF = sh[best_h], sf[best_f]
    use_h = SH / (SH + SF).clamp(min=1e-9) > h_ratio_th

    Km = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                      dtype=uv1.dtype, device=uv1.device)
    E = Km.T @ F[best_f] @ Km
    Re, te = _motions_from_e(E)
    Rh, th = _motions_from_h(torch.linalg.inv(Km) @ H[best_h] @ Km)
    Rs = torch.cat([Re, Rh], dim=0)  # (12, 3, 3)
    ts = torch.cat([te, th], dim=0)
    # the candidate's source must match the chosen model
    from_h = torch.arange(12, device=uv1.device) >= 4
    cand_ok = torch.where(use_h, from_h, ~from_h)

    Xs, goods, n_strongs = _vet_motion(Rs, ts, x1n, x2n, mask, fx,
                                       strong_parallax_cos=min_parallax_cos)
    n_goods = goods.sum(-1) * cand_ok
    best = torch.argmax(n_goods)
    n_best = n_goods[best]
    # the winner must clearly dominate and carry enough strong-parallax
    # points that its depths are conditioned
    second = torch.sort(n_goods).values[-2]
    ok = ((n_best >= min_good) & (n_best > 1.35 * second)
          & (n_strongs[best] >= min_good))
    return InitResult(ok=ok, R=Rs[best], t=ts[best], X=Xs[best],
                      good=goods[best] & cand_ok[best], used_h=use_h,
                      n_good=n_best.to(torch.int32))


def initialize(gen: torch.Generator, uv1, uv2, mask, fx, fy, cx, cy,
               **kw) -> InitResult:
    """Full two-view reconstruction: draw the H and F samples from `gen`,
    then `initialize_from_samples`."""
    idx_h = sample_indices(gen, mask, N_HYPO, 4)
    idx_f = sample_indices(gen, mask, N_HYPO, 8)
    return initialize_from_samples(uv1, uv2, mask, idx_h, idx_f, fx, fy, cx,
                                   cy, **kw)
