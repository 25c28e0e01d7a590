"""Camera models: PinHole (radtan), Rectified and KannalaBrandt8 (fisheye).

Port of `orb_slam3_ros2_tpu/models/cameras.py:37-192`. A camera is a frozen
dataclass of static metadata plus a 9-float parameter tuple
[fx, fy, cx, cy, d0..d4]; `project` / `unproject` are plain functions that
broadcast over leading dims. KannalaBrandt8 (`Camera.type:
"KannalaBrandt8"`, k1..k4 in d0..d3) projects through the θ-polynomial and
unprojects by 10 Newton iterations on θ, as the JAX functions do.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import torch


class CameraModel(enum.IntEnum):
    PINHOLE = 0  # radtan distortion (k1, k2, p1, p2, k3)
    RECTIFIED = 1  # no distortion
    KANNALA_BRANDT8 = 2  # equidistant fisheye (k1..k4)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Static camera description; `params` = [fx, fy, cx, cy, d0..d4]."""

    model: CameraModel
    params: Tuple[float, ...]  # length 9
    width: int
    height: int
    fps: float = 30.0
    baseline: float = 0.0  # Stereo.b for Rectified stereo; 0 for mono

    @property
    def fx(self):
        return self.params[0]

    @property
    def fy(self):
        return self.params[1]

    @property
    def cx(self):
        return self.params[2]

    @property
    def cy(self):
        return self.params[3]

    def K(self, device="cpu") -> torch.Tensor:
        fx, fy, cx, cy = self.params[:4]
        return torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]],
                            dtype=torch.float32, device=device)


def make_camera(model: str, fx, fy, cx, cy, dist=(), width=640, height=480,
                fps=30.0, baseline=0.0) -> Camera:
    d = tuple(dist) + (0.0,) * (5 - len(dist))
    m = {
        "PinHole": CameraModel.PINHOLE,
        "Rectified": CameraModel.RECTIFIED,
        "KannalaBrandt8": CameraModel.KANNALA_BRANDT8,
    }[model]
    return Camera(model=m,
                  params=(float(fx), float(fy), float(cx), float(cy)) + d,
                  width=int(width), height=int(height), fps=float(fps),
                  baseline=float(baseline))


def _project_pinhole(p, x: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    k1, k2, p1, p2, k3 = p[4], p[5], p[6], p[7], p[8]
    z = torch.where(x[..., 2].abs() < 1e-8,
                    torch.full_like(x[..., 2], 1e-8), x[..., 2])
    a = x[..., 0] / z
    b = x[..., 1] / z
    r2 = a * a + b * b
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = a * radial + 2.0 * p1 * a * b + p2 * (r2 + 2.0 * a * a)
    yd = b * radial + p1 * (r2 + 2.0 * b * b) + 2.0 * p2 * a * b
    return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)


def _project_rectified(p, x: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    z = torch.where(x[..., 2].abs() < 1e-8,
                    torch.full_like(x[..., 2], 1e-8), x[..., 2])
    return torch.stack([fx * x[..., 0] / z + cx, fy * x[..., 1] / z + cy],
                       dim=-1)


def _project_kb8(p, x: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    k1, k2, k3, k4 = p[4], p[5], p[6], p[7]
    r = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2).clamp_min(1e-12)
    theta = torch.atan2(r, x[..., 2])
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = theta_d / r
    return torch.stack([fx * scale * x[..., 0] + cx,
                        fy * scale * x[..., 1] + cy], dim=-1)


def project(cam: Camera, x_cam: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points (..., 3) to pixels (..., 2)."""
    if cam.model == CameraModel.PINHOLE:
        return _project_pinhole(cam.params, x_cam)
    if cam.model == CameraModel.RECTIFIED:
        return _project_rectified(cam.params, x_cam)
    return _project_kb8(cam.params, x_cam)


def _unproject_rectified(p, uv):
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    a = (uv[..., 0] - cx) / fx
    b = (uv[..., 1] - cy) / fy
    return torch.stack([a, b, torch.ones_like(a)], dim=-1)


def _unproject_pinhole(p, uv, iters: int = 8):
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    k1, k2, p1, p2, k3 = p[4], p[5], p[6], p[7], p[8]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    a, b = xd, yd
    for _ in range(iters):  # fixed-point undistortion
        r2 = a * a + b * b
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * a * b + p2 * (r2 + 2.0 * a * a)
        dy = p1 * (r2 + 2.0 * b * b) + 2.0 * p2 * a * b
        a = (xd - dx) / radial
        b = (yd - dy) / radial
    return torch.stack([a, b, torch.ones_like(a)], dim=-1)


def _unproject_kb8(p, uv, iters: int = 10):
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    k1, k2, k3, k4 = p[4], p[5], p[6], p[7]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    theta_d = torch.sqrt(mx * mx + my * my).clamp_min(1e-12)
    theta = theta_d
    for _ in range(iters):  # Newton on f(θ) = θ·poly(θ²) − θ_d
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) \
            - theta_d
        df = 1.0 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        theta = theta - f / torch.where(df.abs() < 1e-8,
                                        torch.full_like(df, 1e-8), df)
    scale = torch.tan(theta) / theta_d
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def unproject(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Unproject pixels (..., 2) to unit-z rays (..., 3)."""
    if cam.model == CameraModel.PINHOLE:
        return _unproject_pinhole(cam.params, uv)
    if cam.model == CameraModel.RECTIFIED:
        return _unproject_rectified(cam.params, uv)
    return _unproject_kb8(cam.params, uv)
