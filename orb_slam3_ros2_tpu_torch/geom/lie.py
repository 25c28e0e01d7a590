"""Batched SO(3)/SE(3) operations on torch tensors.

Port of `orb_slam3_ros2_tpu/geom/lie.py` (the SO(3)/SE(3) part). Same
conventions: rotations (..., 3, 3); SE(3) is the pair (R, t) acting as
x' = R x + t; se(3) tangents are ordered [rho, phi]. Small-angle branches
use the same Taylor guards on theta^2.
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
