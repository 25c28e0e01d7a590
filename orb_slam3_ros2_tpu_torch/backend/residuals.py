"""Reprojection residuals + closed-form Jacobians for the pose LM.

Port of `orb_slam3_ros2_tpu/backend/residuals.py`. Poses are T_cw; the
tangent is the left perturbation T_cw <- exp(xi) T_cw with xi = [rho, phi],
so for x_c = R x_w + t: dx_c/drho = I and dx_c/dphi = -[x_c]x.
Observations are undistorted pinhole pixels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_ros2_tpu_torch.geom import lie

# chi-square 95% threshold for a 2-DoF (mono) observation
CHI2_MONO = 5.991


class Projection(NamedTuple):
    r: torch.Tensor  # (..., 2) residual (predicted - observed), pixels
    J_pose: torch.Tensor  # (..., 2, 6) d r / d xi
    J_point: torch.Tensor  # (..., 2, 3) d r / d X_w
    depth: torch.Tensor  # (...,) camera-frame depth


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)


def reproj_residual(R_cw, t_cw, X_w, uv_obs, fx, fy, cx, cy) -> Projection:
    """Residual + Jacobians, broadcasting over leading dims."""
    x_c = lie.se3_apply(R_cw, t_cw, X_w)
    x, y = x_c[..., 0], x_c[..., 1]
    iz = 1.0 / _safe_z(x_c[..., 2])
    iz2 = iz * iz
    r = torch.stack([fx * x * iz + cx, fy * y * iz + cy], dim=-1) - uv_obs
    zeros = torch.zeros_like(x)
    Jp = torch.stack(
        [torch.stack([fx * iz, zeros, -fx * x * iz2], dim=-1),
         torch.stack([zeros, fy * iz, -fy * y * iz2], dim=-1)], dim=-2)
    J_phi = -Jp @ lie.hat(x_c)
    J_pose = torch.cat([Jp, J_phi], dim=-1)
    J_point = Jp @ R_cw
    return Projection(r=r, J_pose=J_pose, J_point=J_point, depth=x_c[..., 2])


def huber_weight(r2: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight for the Huber loss on squared error r2: 1 inside δ,
    δ/|r| beyond."""
    rn = torch.sqrt(torch.clamp(r2, min=1e-12))
    return torch.where(rn <= delta, torch.ones_like(rn), delta / rn)
