"""Batched SO(3)/SE(3)/Sim(3) operations on torch tensors.

Port of `orb_slam3_ros2_tpu/geom/lie.py` (all but the SE(3) logarithm and
the inverse left Jacobian, which nothing ported calls). Same conventions:
rotations (..., 3, 3); SE(3) is the pair (R, t) acting as x' = R x + t;
se(3) tangents are ordered [rho, phi]; Sim(3) is (R, t, s) acting as
x' = s R x + t with tangents [rho, phi, sigma]. Small-angle branches use the
same Taylor guards on theta^2 (and on sigma).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _sinc_cos_coeffs(theta_sq: torch.Tensor):
    """(sin θ/θ, (1-cos θ)/θ², (θ-sin θ)/θ³), Taylor-guarded below _EPS."""
    small = theta_sq < _EPS
    safe_ts = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_ts)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / safe_ts)
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (1.0 - a) / safe_ts)
    return a, b, c


def _eye_like(M: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=M.dtype, device=M.device).expand(M.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3) (Rodrigues), (..., 3) -> (..., 3, 3)."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    a, b, _ = _sinc_cos_coeffs(theta_sq)
    Phi = hat(phi)
    return _eye_like(Phi) + a[..., None, None] * Phi \
        + b[..., None, None] * (Phi @ Phi)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3): (..., 3) -> (..., 3, 3)."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    _, b, c = _sinc_cos_coeffs(theta_sq)
    Phi = hat(phi)
    return _eye_like(Phi) + b[..., None, None] * Phi \
        + c[..., None, None] * (Phi @ Phi)


def se3_exp(xi: torch.Tensor):
    """Exponential map se(3) -> SE(3). xi (..., 6) = [rho, phi] -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    t = torch.einsum("...ij,...j->...i", V, rho)
    return R, t


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) ∘ (Rb, tb): first apply b, then a."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


def se3_inverse(R, t):
    Rt = torch.swapaxes(R, -1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def se3_apply(R, t, x):
    """Apply SE(3) to points x (..., 3)."""
    return torch.einsum("...ij,...j->...i", R, x) + t


def se3_retract(R, t, xi):
    """Left-multiplicative retraction: exp(xi) ∘ (R, t) — the GN/LM update."""
    dR, dt = se3_exp(xi)
    return se3_compose(dR, dt, R, t)


def se3_normalize(R):
    """Re-orthonormalize a rotation (Gram-Schmidt via cross products)."""
    x = R[..., :, 0]
    y = R[..., :, 1]
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp(min=1e-12)
    y = y - torch.sum(x * y, dim=-1, keepdim=True) * x
    y = y / torch.linalg.norm(y, dim=-1, keepdim=True).clamp(min=1e-12)
    z = torch.linalg.cross(x, y, dim=-1)
    return torch.stack([x, y, z], dim=-1)


# ---------------------------------------------------------------------------
# SO(3) logarithm and Sim(3), for loop closing (the Sim3 solver's callers and
# the essential-graph optimization); port of the JAX module's lines 45-48,
# 76-115 and 205-315.
# ---------------------------------------------------------------------------


def vee(Phi: torch.Tensor) -> torch.Tensor:
    """Inverse of `hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([Phi[..., 2, 1], Phi[..., 0, 2], Phi[..., 1, 0]],
                       dim=-1)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3), (..., 3, 3) -> (..., 3), with the
    θ≈0 and θ≈π branches of the JAX version."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    cos_safe = torch.clamp(cos_theta, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_safe)
    near_pi = cos_theta < -1.0 + 1e-6
    near_zero = cos_theta > 1.0 - 1e-6
    w = vee(R - torch.swapaxes(R, -1, -2)) * 0.5
    sin_theta = torch.sin(theta)
    scale = torch.where(
        near_zero, 1.0 + (1.0 - cos_theta) / 3.0,
        theta / torch.where(sin_theta.abs() < 1e-12,
                            torch.ones_like(sin_theta), sin_theta))
    log_generic = w * scale[..., None]
    S = R + _eye_like(R)
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    idx = k[..., None, None].expand(*k.shape, 3, 1)
    col = torch.gather(S, -1, idx)[..., 0]
    axis = col / torch.linalg.norm(col, dim=-1, keepdim=True).clamp(min=1e-12)
    sign = torch.where(torch.sum(axis * w, dim=-1, keepdim=True) < 0.0,
                       -1.0, 1.0)
    log_pi = axis * sign * theta[..., None]
    return torch.where(near_pi[..., None], log_pi, log_generic)


def sim3_exp(xi: torch.Tensor):
    """Exponential map sim(3) -> Sim(3). xi (..., 7) = [rho, phi, sigma]
    -> (R, t, s), with the closed-form W matrix and the JAX version's
    Taylor guards on θ and σ."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    R = so3_exp(phi)
    one = torch.ones_like(sigma)
    theta_sq = torch.sum(phi * phi, dim=-1)
    small_th = theta_sq < _EPS
    theta = torch.sqrt(torch.where(small_th, one, theta_sq))
    small_sg = sigma.abs() < 1e-5
    sg_safe = torch.where(small_sg, one, sigma)
    a_coef = torch.where(small_sg, 1.0 + sigma / 2.0, (s - 1.0) / sg_safe)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    denom = torch.where(small_sg, one, sigma * sigma + theta_sq)
    th_safe = torch.where(small_th, one, theta)
    thsq_safe = torch.where(small_th, one, theta_sq)
    b_gen = (s * (sigma * sin_t - theta * cos_t) + theta) / (th_safe * denom)
    c_gen = (a_coef - ((s * cos_t - 1.0) * sigma + s * sin_t * theta)
             / denom) / thsq_safe
    b_small_th = torch.where(
        small_sg, 0.5 + sigma / 3.0,
        (sigma * s - s + 1.0 + 0.0 * theta_sq) / (sg_safe * sg_safe))
    c_small_th = torch.where(
        small_sg, 1.0 / 6.0 + sigma / 8.0,
        (s * (0.5 * sigma * sigma - sigma + 1.0) - 1.0)
        / (sg_safe * sg_safe * sg_safe))
    b_small_sg = (1.0 - cos_t) / thsq_safe
    c_small_sg = (theta - sin_t) / torch.where(small_th, one,
                                               theta_sq * theta)
    B = torch.where(small_th, b_small_th,
                    torch.where(small_sg, b_small_sg, b_gen))
    C = torch.where(small_th, c_small_th,
                    torch.where(small_sg, c_small_sg, c_gen))
    Phi = hat(phi)
    W = (a_coef[..., None, None] * _eye_like(Phi) + B[..., None, None] * Phi
         + C[..., None, None] * (Phi @ Phi))
    t = torch.einsum("...ij,...j->...i", W, rho)
    return R, t, s


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """(Ra, ta, sa) ∘ (Rb, tb, sb); action x -> s R x + t."""
    return (Ra @ Rb,
            sa[..., None] * torch.einsum("...ij,...j->...i", Ra, tb) + ta,
            sa * sb)


def sim3_inverse(R, t, s):
    Rt = torch.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt, t), \
        s_inv


def sim3_apply(R, t, s, x):
    return s[..., None] * torch.einsum("...ij,...j->...i", R, x) + t


def _sim3_W(phi, sigma):
    """The W matrix of `sim3_exp` at (phi, sigma), column by column."""
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    cols = []
    for i in range(3):
        rho = eye[i].expand(phi.shape)
        _, t_i, _ = sim3_exp(torch.cat([rho, phi, sigma[..., None]], dim=-1))
        cols.append(t_i)
    return torch.stack(cols, dim=-1)


def sim3_log(R, t, s):
    """Logarithm Sim(3) -> sim(3): phi from so3_log, sigma = log s, and rho
    from the solve W rho = t."""
    phi = so3_log(R)
    sigma = torch.log(s)
    W = _sim3_W(phi, sigma)
    rho = torch.linalg.solve(W, t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
