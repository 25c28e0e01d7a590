"""Schur elimination core for bundle adjustment.

Port of `orb_slam3_ros2_tpu/backend/schur.py`. One LM linearization: the
per-landmark 3x3 Hessian blocks are damped and inverted in closed form
(M = L^-T of a modified Cholesky factor, six (L,) planes), the whitened
cross term V[c] = W M[:, c] is built elementwise, and the reduced camera
system is S = blockdiag(Hcc) - sum_c V[c] V[c]^T, one batched matmul. The
camera step is a dense solve; the landmark step is back-substituted.

The JAX version keeps every large intermediate landmark-minor, `(K, L)`
planes and `(3, 6K, L)` cross terms, for the TPU's (8, 128) tiling. The
same planes are ordinary batched torch ops here; only the layout's reason
is gone, the arithmetic is the same.

`schur_reduce`, `solve_cameras`, `robust_cost` and `refresh_weights` take
a keyword `graphs`, one solve's CUDA graphs (`backend/stage_graphs.py`),
which `backend/ba.py` `bundle_adjust` passes: the stage then replays its
graph, with the same kernels in the same order. What they return that a
caller may keep (the costs, the gate) is a fresh tensor; the rest is the
graph's, as `SchurTerms` and `solve_cameras` say. Without `graphs` (the
CPU, and the direct callers: `vi_ba`, `parallel/sharded_*`) every call
runs eagerly.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from orb_slam3_ros2_tpu_torch.backend import residuals as res
from orb_slam3_ros2_tpu_torch.backend import stage_graphs

HUBER_2 = res.CHI2_MONO  # chi2 threshold = squared Huber delta
_DELTA = math.sqrt(HUBER_2)


class SchurTerms(NamedTuple):
    """Reduced camera system of one landmark set plus back-substitution
    state (the JAX version's fields, same shapes).

    From a `schur_reduce` with `graphs`, every field but `cost0` is the
    graph's own buffer (`V` is 151 MB at 256 x 8192): it holds for one LM
    iteration, until the next `schur_reduce` of the same problem replays.
    `cost0` is always a fresh tensor."""

    Hcc_p: torch.Tensor  # (K, 6, 6) camera Hessian blocks (undamped)
    S_off: torch.Tensor  # (6K, 6K) = V V^T (subtract from blockdiag(Hcc))
    rhs_p: torch.Tensor  # (K, 6) reduced gradient bc - V (M^T bl)
    V: torch.Tensor  # (3, 6K, L) whitened cross term
    M6: torch.Tensor  # (6, L) upper-tri entries m00,m01,m02,m11,m12,m22
    bl_t: torch.Tensor  # (3, L) = M^T bl
    cost0: torch.Tensor  # () robust cost at the linearization point


_CHOL_PIVOT_FLOOR = 1e-6  # min normalized pivot (modified Cholesky)


def _chol3_invT_planes(haa, hab, hac, hbb, hbc, hcc):
    """Closed-form M = L^-T for SPD 3x3 matrices given as 6 (L,) planes.

    Returns the planes (m00, m01, m02, m11, m12, m22) of the upper-triangular
    M with H^-1 ≈ M M^T. A MODIFIED Cholesky in f32: the matrix is Jacobi-
    normalized to unit diagonal, the normalized pivots are floored at
    _CHOL_PIVOT_FLOOR and l21 is clipped to [-2, 2]. A landmark seen once
    has a rank-2 Hessian; unfloored, its last pivot is an f32 cancellation
    (~1e4 - ~1e4) that blew M up to ~1e15 (a 14% e2e RGBD scale error in
    the JAX package before this guard). The floor damps only the unobserved
    directions."""
    d0 = torch.rsqrt(haa.clamp(min=1e-30))
    d1 = torch.rsqrt(hbb.clamp(min=1e-30))
    d2 = torch.rsqrt(hcc.clamp(min=1e-30))
    # normalized (correlation-form) off-diagonals, |.| <= 1 for true PSD
    ab = hab * d0 * d1
    ac = hac * d0 * d2
    bc = hbc * d1 * d2
    eps = _CHOL_PIVOT_FLOOR
    # Cholesky of the unit-diagonal matrix: l00 = 1
    l10 = ab
    l20 = ac
    l11 = torch.sqrt((1.0 - l10 * l10).clamp(min=eps))
    il11 = 1.0 / l11
    l21 = ((bc - l20 * l10) * il11).clamp(-2.0, 2.0)
    l22 = torch.sqrt((1.0 - l20 * l20 - l21 * l21).clamp(min=eps))
    il22 = 1.0 / l22
    # inverse of the unit-diagonal factor (lower), with l00 = 1
    i10 = -l10 * il11
    i21 = -l21 * il11 * il22
    i20 = (l10 * l21 - l20 * l11) * (il11 * il22)
    # H^-1 = D M~ M~^T D with M~ = L~^-T: row b of M scales by d_b
    return (d0, d0 * i10, d0 * i20, d1 * il11, d1 * i21, d2 * il22)


def _safe_inv_depth(depth):
    return 1.0 / torch.where(depth.abs() < 1e-8, torch.full_like(depth, 1e-8),
                             depth)


def project_planes(R, t, X, uv, fx, fy, cx, cy):
    """Residual planes: returns (r0, r1, depth), each (K, L)."""
    xc = torch.einsum("kab,bl->kal", R, X.T) + t[:, :, None]
    depth = xc[:, 2]
    iz = _safe_inv_depth(depth)
    r0 = fx * xc[:, 0] * iz + cx - uv[..., 0]
    r1 = fy * xc[:, 1] * iz + cy - uv[..., 1]
    return r0, r1, depth


def _huber_cost(r2, w_active):
    rn = torch.sqrt(r2.clamp(min=1e-12))
    return torch.sum(torch.where(r2 <= HUBER_2, r2,
                                 2.0 * _DELTA * rn - HUBER_2)
                     * (w_active > 0))


def robust_cost(R, t, X, uv, w_active, fx, fy, cx, cy, *, graphs=None):
    """Robust (Huber) total cost — the cost-only evaluation for LM
    accept/reject."""
    if graphs is not None:
        return graphs.run("cost", _robust_cost, R, t, X, uv, w_active, fx,
                          fy, cx, cy).clone()
    return _robust_cost(R, t, X, uv, w_active, fx, fy, cx, cy)


def _robust_cost(R, t, X, uv, w_active, fx, fy, cx, cy):
    r0, r1, _ = project_planes(R, t, X, uv, fx, fy, cx, cy)
    return _huber_cost((r0 * r0 + r1 * r1) * w_active, w_active)


def refresh_weights(R, t, X, uv, w_base, fx, fy, cx, cy,
                    chi2_th: float = HUBER_2, *, graphs=None):
    """chi² re-classification against the BASE weights."""
    if graphs is not None:
        return graphs.run("refresh_weights", _refresh_weights, R, t, X, uv,
                          w_base, fx, fy, cx, cy, chi2_th).clone()
    return _refresh_weights(R, t, X, uv, w_base, fx, fy, cx, cy, chi2_th)


def _refresh_weights(R, t, X, uv, w_base, fx, fy, cx, cy, chi2_th):
    r0, r1, depth = project_planes(R, t, X, uv, fx, fy, cx, cy)
    chi2 = (r0 * r0 + r1 * r1) * w_base
    keep = (chi2 <= chi2_th) & (depth > 0.05) & (w_base > 0)
    return w_base * keep


def schur_reduce(R, t, X, uv, w_active, fx, fy, cx, cy, lam, *,
                 graphs=None) -> SchurTerms:
    """Linearize and eliminate the landmark block.

    R (K,3,3), t (K,3), X (L,3), uv (K,L,2), w_active (K,L). `lam` damps
    the landmark blocks here; camera damping happens in `solve_cameras`."""
    if graphs is not None:
        terms = graphs.run("reduce", _schur_reduce, R, t, X, uv, w_active,
                           fx, fy, cx, cy, lam)
        return terms._replace(cost0=terms.cost0.clone())
    return _schur_reduce(R, t, X, uv, w_active, fx, fy, cx, cy, lam)


def _schur_reduce(R, t, X, uv, w_active, fx, fy, cx, cy, lam) -> SchurTerms:
    K, L = w_active.shape
    xc = torch.einsum("kab,bl->kal", R, X.T) + t[:, :, None]  # (K, 3, L)
    x, y, depth = xc[:, 0], xc[:, 1], xc[:, 2]
    iz = _safe_inv_depth(depth)
    iz2 = iz * iz
    r0 = fx * x * iz + cx - uv[..., 0]
    r1 = fy * y * iz + cy - uv[..., 1]

    # robust IRLS weight (Huber + cheirality)
    r2 = (r0 * r0 + r1 * r1) * w_active
    rn = torch.sqrt(r2.clamp(min=1e-12))
    hw = torch.where(rn <= _DELTA, torch.ones_like(rn), _DELTA / rn)
    ww = w_active * hw * (depth > 0.05)
    cost0 = _huber_cost(r2, w_active)
    sw = torch.sqrt(ww)

    # whitened projection jacobian rows:
    #   Jp0 = [fx·iz, 0, −fx·x·iz²],  Jp1 = [0, fy·iz, −fy·y·iz²]
    g0x = sw * fx * iz
    g0z = -sw * fx * x * iz2
    g1y = sw * fy * iz
    g1z = -sw * fy * y * iz2
    zero = torch.zeros_like(g0x)

    def jx(gx, gy, gz):  # J_point row = Jp_a @ R_k -> (K, 3, L)
        return (gx[:, None, :] * R[:, 0, :, None]
                + gy[:, None, :] * R[:, 1, :, None]
                + gz[:, None, :] * R[:, 2, :, None])

    Jx0 = jx(g0x, zero, g0z)
    Jx1 = jx(zero, g1y, g1z)

    def jphi(gx, gy, gz):  # −Jp_a @ hat(x_c)
        return (-(gy * depth - gz * y), -(gz * x - gx * depth),
                -(gx * y - gy * x))

    p00, p01, p02 = jphi(g0x, zero, g0z)
    p10, p11, p12 = jphi(zero, g1y, g1z)
    Jc0 = torch.stack([g0x, zero, g0z, p00, p01, p02], dim=1)  # (K, 6, L)
    Jc1 = torch.stack([zero, g1y, g1z, p10, p11, p12], dim=1)
    rw0, rw1 = sw * r0, sw * r1

    # camera blocks + gradients
    Hcc_p = (torch.einsum("kil,kjl->kij", Jc0, Jc0)
             + torch.einsum("kil,kjl->kij", Jc1, Jc1))
    bc_p = (torch.einsum("kil,kl->ki", Jc0, rw0)
            + torch.einsum("kil,kl->ki", Jc1, rw1))

    # landmark blocks as 6 planes (sum over keyframes)
    def hsum(a, b):
        return (Jx0[:, a] * Jx0[:, b]).sum(0) + (Jx1[:, a] * Jx1[:, b]).sum(0)

    haa, hab, hac = hsum(0, 0), hsum(0, 1), hsum(0, 2)
    hbb, hbc, hcc = hsum(1, 1), hsum(1, 2), hsum(2, 2)
    bl = (torch.einsum("kbl,kl->bl", Jx0, rw0)
          + torch.einsum("kbl,kl->bl", Jx1, rw1))  # (3, L)

    # landmark damping + closed-form M = L^-T
    m00, m01, m02, m11, m12, m22 = _chol3_invT_planes(
        haa + lam * haa.abs() + 1e-8, hab, hac,
        hbb + lam * hbb.abs() + 1e-8, hbc,
        hcc + lam * hcc.abs() + 1e-8)
    M6 = torch.stack([m00, m01, m02, m11, m12, m22])
    bl_t = torch.stack([
        m00 * bl[0],
        m01 * bl[0] + m11 * bl[1],
        m02 * bl[0] + m12 * bl[1] + m22 * bl[2],
    ])  # (3, L) = M^T bl

    def jxt(Jxa):  # Jxa M, upper-triangular M
        return (Jxa[:, 0] * m00,
                Jxa[:, 0] * m01 + Jxa[:, 1] * m11,
                Jxa[:, 0] * m02 + Jxa[:, 1] * m12 + Jxa[:, 2] * m22)

    t00, t01, t02 = jxt(Jx0)
    t10, t11, t12 = jxt(Jx1)
    V = torch.stack([
        Jc0 * t00[:, None, :] + Jc1 * t10[:, None, :],
        Jc0 * t01[:, None, :] + Jc1 * t11[:, None, :],
        Jc0 * t02[:, None, :] + Jc1 * t12[:, None, :],
    ]).reshape(3, K * 6, L)

    S_off = torch.einsum("cpl,cql->pq", V, V)  # (6K, 6K)
    rhs_p = bc_p - torch.einsum("cpl,cl->p", V, bl_t).reshape(K, 6)
    return SchurTerms(Hcc_p=Hcc_p, S_off=S_off, rhs_p=rhs_p, V=V, M6=M6,
                      bl_t=bl_t, cost0=cost0)


def solve_cameras(Hcc, S_off, rhs, fixed, lam, fixed_prior: float, *,
                  graphs=None):
    """Damp and gauge-pin the camera system and solve for dxc (K, 6).

    `torch.linalg.solve_ex` does not check for a singular system, so the
    solve makes no host sync; the fixed prior keeps the system regular.
    With `graphs`, dxc is the graph's buffer, as `SchurTerms`' fields."""
    return stage_graphs.run(graphs, "solve_cameras", _solve_cameras, Hcc,
                            S_off, rhs, fixed, lam, fixed_prior)


def _solve_cameras(Hcc, S_off, rhs, fixed, lam, fixed_prior):
    K = Hcc.shape[0]
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    prior = torch.where(fixed, fixed_prior, 0.0).to(Hcc.dtype)
    diag = torch.diagonal(Hcc, dim1=1, dim2=2)  # (K, 6)
    Hcc = (Hcc + lam * diag.abs()[:, :, None] * eye6
           + (prior[:, None, None] + 1e-9) * eye6)
    S = -S_off + torch.block_diag(*Hcc.unbind(0))
    sol = torch.linalg.solve_ex(S, rhs.reshape(K * 6, 1)).result
    return -sol.reshape(K, 6)


def back_substitute(terms: SchurTerms, dxc, point_valid):
    """dxl = -M (M^T bl + V^T dxc): (L, 3)."""
    return landmark_step(terms.V, terms.M6, terms.bl_t, dxc, point_valid)


def landmark_step(V, M6, bl_t, dxc, point_valid):
    """`back_substitute` on the terms it reads."""
    g = torch.einsum("cpl,p->cl", V, dxc.reshape(-1))
    s = bl_t + g
    m00, m01, m02, m11, m12, m22 = M6
    dxl = torch.stack([-(m00 * s[0] + m01 * s[1] + m02 * s[2]),
                       -(m11 * s[1] + m12 * s[2]),
                       -(m22 * s[2])], dim=-1)
    return dxl * point_valid[:, None]
