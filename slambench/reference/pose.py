"""Plain robust pose optimization, the reference of a tracked frame's pose.

Each of the program's pose solves of a frame (the first from the frame's
predicted pose, the second from the first's result after the tight
re-match) takes a start pose, the matched landmarks X (n, 3), their
undistorted pixels uv (n, 2), their information 1 / σ² (σ =
scale_factor^level) and a mask. The semantics the program states for the
solve: Σ ρ_Huber(χ²) with χ² = |r|² / σ², δ² = 5.991, an observation
behind depth 0.05 weighted 0; 3 rounds of 5 Levenberg-Marquardt
iterations (λ from 1e-3, × 0.5 on an accepted step, × 4 on a rejected
one, clamped to [1e-7, 1e2], the damped system H + λ diag(H) + 1e-9 I),
the left retraction with the rotation re-orthonormalized, and before
rounds 2 and 3 the χ² gate (χ² <= 5.991 and in front) re-drawn from the
last accepted state; inliers are those passing the gate at the end.
This module follows that schedule in the precision asked (the 6x6 solve
in float64). It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from slambench.reference.ba import hat, retract

CHI2 = 5.991


def _system(R, t, X, uv, inv_s2, w_active, cam):
    fx, fy, cx, cy = cam
    xc = X @ R.T + t
    z = xc[:, 2]
    iz = 1.0 / torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    r = torch.stack([fx * xc[:, 0] * iz + cx, fy * xc[:, 1] * iz + cy],
                    -1) - uv
    chi2 = (r * r).sum(-1) * inv_s2
    rn = torch.sqrt(chi2.clamp(min=1e-12))
    d = math.sqrt(CHI2)
    pos = z > 0.05
    cost = (torch.where(chi2 <= d * d, chi2, 2 * d * rn - d * d)
            * (w_active > 0)).sum()
    hw = torch.where(rn <= d, torch.ones_like(rn), d / rn)
    w = w_active * hw * pos
    zero = torch.zeros_like(iz)
    Jp = torch.stack([
        torch.stack([fx * iz, zero, -fx * xc[:, 0] * iz * iz], -1),
        torch.stack([zero, fy * iz, -fy * xc[:, 1] * iz * iz], -1)], -2)
    J = torch.cat([Jp, -Jp @ hat(xc)], -1)  # (n, 2, 6)
    Jw = J * w[:, None, None]
    H = torch.einsum("nai,naj->ij", Jw, J)
    g = torch.einsum("nai,na->i", Jw, r)
    return H, g, cost, chi2, pos


def optimize(R0, t0, X, uv, inv_s2, mask, cam, dtype=torch.float64,
             n_rounds: int = 3, iters: int = 5):
    """(R, t, inliers) of the robust solve, in `dtype`."""
    cast = lambda v: v.to(dtype)
    R, t, X, uv, inv_s2 = (cast(v) for v in (R0, t0, X, uv, inv_s2))
    mask = mask.bool()
    w_base = inv_s2 * mask
    lam = 1e-3
    chi2v = torch.zeros_like(inv_s2)
    posv = torch.ones_like(mask)
    eye = torch.eye(6, dtype=torch.float64, device=X.device)
    for rnd in range(n_rounds):
        w_active = w_base if rnd == 0 else \
            w_base * ((chi2v <= CHI2) & posv & mask)
        H, g, cost, chi2v, posv = _system(R, t, X, uv, inv_s2, w_active, cam)
        for _ in range(iters):
            Hd = H.double()
            Hd = Hd + lam * torch.diag(torch.diag(Hd)) + 1e-9 * eye
            dx = -torch.linalg.solve(Hd, g.double())
            R1, t1 = retract(R, t, dx.to(dtype))
            H1, g1, cost1, chi1, pos1 = _system(R1, t1, X, uv, inv_s2,
                                                w_active, cam)
            if bool(cost1 < cost):
                R, t, H, g, cost, chi2v, posv = R1, t1, H1, g1, cost1, \
                    chi1, pos1
                lam = min(max(lam * 0.5, 1e-7), 1e2)
            else:
                lam = min(max(lam * 4.0, 1e-7), 1e2)
    return R, t, (chi2v <= CHI2) & posv & mask


def gap(R_prog, t_prog, R_ref, t_ref, depth: float) -> float:
    """The larger of the camera-centre gap over the scene depth and the
    rotation gap in radians."""
    Rp, tp = R_prog.double(), t_prog.double()
    Rr, tr = R_ref.double(), t_ref.double()
    cp = -Rp.T @ tp
    cr = -Rr.T @ tr
    ang = float(torch.linalg.matrix_norm(Rp - Rr)) / math.sqrt(2.0)
    return max(float((cp - cr).norm()) / max(depth, 1e-9), ang)
