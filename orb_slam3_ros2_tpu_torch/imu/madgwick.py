"""Madgwick AHRS orientation filter (the `imu_filter_madgwick` side car).

Port of `orb_slam3_ros2_tpu/imu/madgwick.py`: the gradient-descent IMU
update of Madgwick's 2010 report over a batch of samples, and a streaming
host wrapper. The JAX `lax.scan` over the batch is a loop over its rows on
the tensors' device, with no host sync; a masked row leaves the state as it
was.

Conventions: Hamilton quaternions `(w, x, y, z)`; the state `q` is
world-from-body (`v_world = R(q) @ v_body`), so a static sensor satisfies
`R(q)^T @ [0,0,1] == acc/|acc|`. Gyro in rad/s (body frame), accel in any
consistent unit (only its direction is used).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = [
    "quat_mul", "quat_normalize", "quat_to_rotmat", "quat_from_accel",
    "madgwick_step", "madgwick_filter", "MadgwickFilter",
]


def quat_mul(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Hamilton product p ⊗ q, both (..., 4) as (w, x, y, z)."""
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        pw * qw - px * qx - py * qy - pz * qz,
        pw * qx + px * qw + py * qz - pz * qy,
        pw * qy - px * qz + py * qw + pz * qx,
        pw * qz + px * qy - py * qx + pz * qw,
    ], dim=-1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz → (..., 3, 3) with v_world = R @ v_body."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def quat_from_accel(acc: torch.Tensor) -> torch.Tensor:
    """Tilt-only initial quaternion from one accelerometer sample: the
    shortest-arc world-from-body rotation taking the measured gravity
    direction (body) onto +z (world); yaw is left at zero. Identity for a
    near-zero sample."""
    n = torch.linalg.norm(acc)
    a = acc / n.clamp(min=1e-12)
    # shortest arc from a to e3: q = [1 + a·e3, a × e3] normalized
    w = 1.0 + a[2]
    q = torch.stack([w, a[1], -a[0], torch.zeros_like(a[0])])
    # antipodal (a ≈ -e3): a 180° roll
    q = torch.where(w < 1e-6, q.new_tensor([0.0, 1.0, 0.0, 0.0]),
                    quat_normalize(q))
    return torch.where(n > 1e-8, q, q.new_tensor([1.0, 0.0, 0.0, 0.0]))


def madgwick_step(q: torch.Tensor, gyro: torch.Tensor, acc: torch.Tensor,
                  dt, beta) -> torch.Tensor:
    """One IMU (gyro+accel) Madgwick update of a single quaternion."""
    qw, qx, qy, qz = q[0], q[1], q[2], q[3]
    # gyro quaternion derivative: 0.5 * q ⊗ (0, ω)
    omega = torch.cat([torch.zeros((1,), dtype=q.dtype, device=q.device),
                       gyro])
    q_dot = 0.5 * quat_mul(q, omega)
    # gradient-descent correction toward R(q)^T e3 == acc/|acc|
    anorm = torch.linalg.norm(acc)
    a = acc / anorm.clamp(min=1e-12)
    f = torch.stack([
        2.0 * (qx * qz - qw * qy) - a[0],
        2.0 * (qw * qx + qy * qz) - a[1],
        1.0 - 2.0 * (qx * qx + qy * qy) - a[2],
    ])
    zero = torch.zeros_like(qw)
    J = torch.stack([
        torch.stack([-2.0 * qy, 2.0 * qz, -2.0 * qw, 2.0 * qx]),
        torch.stack([2.0 * qx, 2.0 * qw, 2.0 * qz, 2.0 * qy]),
        torch.stack([zero, -4.0 * qx, -4.0 * qy, zero]),
    ])
    grad = J.T @ f
    gnorm = torch.linalg.norm(grad)
    use = (anorm > 1e-8) & (gnorm > 1e-12)
    corr = torch.where(use, beta * grad / gnorm.clamp(min=1e-12), 0.0)
    return quat_normalize(q + (q_dot - corr) * dt)


def madgwick_filter(gyro: torch.Tensor, acc: torch.Tensor, dts: torch.Tensor,
                    q0: torch.Tensor, beta,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Filter a batch of N samples; returns the (N, 4) quaternions.

    `dts[i]` is the interval ending at sample i. Masked-out samples leave
    the state unchanged (fixed-capacity host buffers pad with mask=False)."""
    n = gyro.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=gyro.device)
    dts = torch.as_tensor(dts, dtype=gyro.dtype,
                          device=gyro.device).expand(n)
    q, out = q0, []
    for i in range(n):
        q = torch.where(mask[i], madgwick_step(q, gyro[i], acc[i], dts[i],
                                               beta), q)
        out.append(q)
    return torch.stack(out) if out else q0.new_zeros((0, 4))


class MadgwickFilter:
    """Streaming host wrapper: feed sample windows, read the latest pose.
    Each window is filtered with one `madgwick_filter` call on `device`:
    the card unless the caller passes device="cpu" (without a card the
    default raises)."""

    def __init__(self, beta: float = 0.1, dtype=torch.float32,
                 device=None):
        self.beta = float(beta)
        self.dtype = dtype
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"MadgwickFilter(device={device!r}): no CUDA device is "
                "available; pass device=\"cpu\" to run on the CPU")
        self.q: Optional[torch.Tensor] = None
        self._t_prev: Optional[float] = None

    def update(self, gyro, acc, times):
        """Filter one window; arrays (N,3),(N,3),(N,). Returns (N,4) quats."""
        gyro = torch.as_tensor(np.asarray(gyro), dtype=self.dtype,
                               device=self.device)
        acc = torch.as_tensor(np.asarray(acc), dtype=self.dtype,
                              device=self.device)
        times = np.asarray(times, float)
        if self.q is None:
            self.q = quat_from_accel(acc[0])
            self._t_prev = float(times[0])
        dts = np.diff(np.concatenate([[self._t_prev], times]))
        dts = np.clip(dts, 0.0, 0.5)  # tolerate gaps/replays
        qs = madgwick_filter(
            gyro, acc, torch.as_tensor(dts, dtype=self.dtype,
                                       device=self.device),
            self.q, torch.tensor(self.beta, dtype=self.dtype,
                                 device=self.device))
        self.q = qs[-1]
        self._t_prev = float(times[-1])
        return qs

    @property
    def rotation(self) -> Optional[torch.Tensor]:
        """Latest world-from-body rotation matrix, or None before any data."""
        return None if self.q is None else quat_to_rotmat(self.q)
