"""IMU preintegration: Forster-style preintegrated deltas with first-order
bias Jacobians and noise-covariance propagation.

Port of `orb_slam3_ros2_tpu/imu/preintegration.py`. Same conventions: body
frame b; world gravity g_w = (0, 0, -9.81); states (R_wb, p_w, v_w, bg, ba);
the accelerometer measures specific force a_m = R_bw (a_w - g_w) + ba +
noise. Noise densities are continuous-time, as in the settings files.

The JAX `lax.scan` over the sample batch is a loop over the batch's rows on
the tensors' device. The terms that do not depend on the running deltas
(the bias-corrected samples, each sample's rotation increment and its
right Jacobian) are computed for the whole batch first; the loop then
carries the deltas, the bias Jacobians and the covariance. A masked row
leaves the state as it was, as the JAX step's `where` does, and nothing in
the loop reads a value back to the host.

Every function takes tensors with any leading batch dimensions (a stack of
intervals) except `integrate`, which integrates one interval.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.geom import lie

GRAVITY = (0.0, 0.0, -9.81)


class Preintegrated(NamedTuple):
    """Preintegrated deltas over [t_i, t_j] at linearization biases (bg, ba)."""

    dR: torch.Tensor  # (3, 3)
    dv: torch.Tensor  # (3,)
    dp: torch.Tensor  # (3,)
    dt: torch.Tensor  # () total time
    # bias Jacobians (first order, Forster eq. 44)
    JRg: torch.Tensor  # (3, 3) ∂ΔR/∂bg
    Jvg: torch.Tensor  # (3, 3) ∂Δv/∂bg
    Jva: torch.Tensor  # (3, 3) ∂Δv/∂ba
    Jpg: torch.Tensor  # (3, 3) ∂Δp/∂bg
    Jpa: torch.Tensor  # (3, 3) ∂Δp/∂ba
    cov: torch.Tensor  # (9, 9) covariance of (δφ, δv, δp)
    bg: torch.Tensor  # (3,) linearization gyro bias
    ba: torch.Tensor  # (3,) linearization accel bias


def gravity_like(x: torch.Tensor) -> torch.Tensor:
    """g_w on the device and dtype of `x`, made there by fills: a
    `torch.tensor` of the host tuple (or an item assignment) copies from
    pageable host memory and waits for the stream. The same bits."""
    g = torch.zeros(3, dtype=x.dtype, device=x.device)
    g[2:].fill_(GRAVITY[2])
    return g


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., m, n) x (..., n) -> (..., m)."""
    return (A @ x[..., None])[..., 0]


def identity_preintegrated(bg=None, ba=None, device="cpu",
                           dtype=torch.float32) -> Preintegrated:
    """The empty interval, linearized at (bg, ba) (zeros by default)."""
    z3 = torch.zeros(3, dtype=dtype, device=device)
    z33 = torch.zeros((3, 3), dtype=dtype, device=device)
    return Preintegrated(
        dR=torch.eye(3, dtype=dtype, device=device), dv=z3, dp=z3,
        dt=torch.zeros((), dtype=dtype, device=device),
        JRg=z33, Jvg=z33, Jva=z33, Jpg=z33, Jpa=z33,
        cov=torch.zeros((9, 9), dtype=dtype, device=device),
        bg=z3 if bg is None else bg, ba=z3 if ba is None else ba)


def integrate(
    pre: Preintegrated,
    gyro: torch.Tensor,  # (M, 3) raw gyro samples
    acc: torch.Tensor,  # (M, 3) raw accel samples
    dts: torch.Tensor,  # (M,) per-sample integration intervals
    mask: torch.Tensor,  # (M,) bool — padded tail entries are skipped
    noise_gyro: float = 1.7e-4,
    noise_acc: float = 2.0e-3,
) -> Preintegrated:
    """Integrate a (masked, fixed-length) batch of samples into `pre`
    (Forster eq. A.7-A.9 for the covariance of (δφ, δv, δp); discrete
    covariance per step σ²/dt)."""
    dts = torch.where(mask, dts, 0.0)
    wd = gyro - pre.bg
    ad = acc - pre.ba
    dRk_all = lie.so3_exp(wd * dts[:, None])
    Jr_all = lie.so3_left_jacobian(-wd * dts[:, None])  # right Jacobian
    hat_a_all = lie.hat(ad)
    sdt_all = torch.where(dts > 0, 1.0 / dts.clamp(min=1e-9), 0.0)
    dev, dt_ = gyro.device, gyro.dtype
    I3 = torch.eye(3, dtype=dt_, device=dev)
    Z3 = torch.zeros((3, 3), dtype=dt_, device=dev)
    Z36 = torch.zeros((3, 6), dtype=dt_, device=dev)
    c = pre
    for k in range(gyro.shape[0]):
        dt = dts[k]
        dRk, Jr, hat_a = dRk_all[k], Jr_all[k], hat_a_all[k]
        a_rot = c.dR @ ad[k]
        dR_hat = c.dR @ hat_a
        # covariance propagation: A (9, 9), B (9, 6), Q = diag(σg², σa²)/dt
        A = torch.cat([
            torch.cat([dRk.T, Z36], dim=1),
            torch.cat([-dR_hat * dt, I3, Z3], dim=1),
            torch.cat([-0.5 * dR_hat * dt * dt, I3 * dt, I3], dim=1),
        ])
        B = torch.cat([
            torch.cat([Jr * dt, Z3], dim=1),
            torch.cat([Z3, c.dR * dt], dim=1),
            torch.cat([Z3, 0.5 * c.dR * dt * dt], dim=1),
        ])
        q = torch.cat([(noise_gyro ** 2 * sdt_all[k]).expand(3),
                       (noise_acc ** 2 * sdt_all[k]).expand(3)])
        cov = A @ c.cov @ A.T + (B * q) @ B.T
        # bias Jacobians (updated BEFORE dR: they use the previous dR)
        dR_hat_J = dR_hat @ c.JRg
        Jpg = c.Jpg + c.Jvg * dt - 0.5 * dR_hat_J * dt * dt
        Jpa = c.Jpa + c.Jva * dt - 0.5 * c.dR * dt * dt
        Jvg = c.Jvg - dR_hat_J * dt
        Jva = c.Jva - c.dR * dt
        JRg = dRk.T @ c.JRg - Jr * dt
        dp = c.dp + c.dv * dt + 0.5 * a_rot * dt * dt
        dv = c.dv + a_rot * dt
        dR = c.dR @ dRk
        new = Preintegrated(dR=dR, dv=dv, dp=dp, dt=c.dt + dt, JRg=JRg,
                            Jvg=Jvg, Jva=Jva, Jpg=Jpg, Jpa=Jpa, cov=cov,
                            bg=c.bg, ba=c.ba)
        m = mask[k]
        # a masked row keeps the previous state entirely
        c = Preintegrated(*(torch.where(m, n, o) for n, o in zip(new, c)))
    return c


def preintegrate(gyro, acc, dts, mask, bg=None, ba=None,
                 noise_gyro: float = 1.7e-4, noise_acc: float = 2.0e-3
                 ) -> Preintegrated:
    """`integrate` from the empty interval at (bg, ba)."""
    pre = identity_preintegrated(bg, ba, device=gyro.device, dtype=gyro.dtype)
    return integrate(pre, gyro, acc, dts, mask, noise_gyro, noise_acc)


def merge(pre1: Preintegrated, pre2: Preintegrated) -> Preintegrated:
    """Compose two consecutive preintegrated intervals into one (the
    reference's `IMU::Preintegrated::MergePrevious`, used when a keyframe
    between them is culled): first-order composition of the deltas, bias
    Jacobians and covariance, linearized at `pre1`'s biases."""
    dR1, dv1, dp1, dt2 = pre1.dR, pre1.dv, pre1.dp, pre2.dt
    dR = dR1 @ pre2.dR
    dv = dv1 + _mv(dR1, pre2.dv)
    dp = dp1 + dv1 * dt2[..., None] + _mv(dR1, pre2.dp)
    dR2T = torch.swapaxes(pre2.dR, -1, -2)
    JRg = dR2T @ pre1.JRg + pre2.JRg
    hat_dv2 = lie.hat(pre2.dv)
    hat_dp2 = lie.hat(pre2.dp)
    t2 = dt2[..., None, None]
    Jvg = pre1.Jvg + dR1 @ pre2.Jvg - dR1 @ hat_dv2 @ pre1.JRg
    Jva = pre1.Jva + dR1 @ pre2.Jva
    Jpg = (pre1.Jpg + pre1.Jvg * t2 + dR1 @ pre2.Jpg
           - dR1 @ hat_dp2 @ pre1.JRg)
    Jpa = pre1.Jpa + pre1.Jva * t2 + dR1 @ pre2.Jpa
    # covariance: δ_combined = A1 δ1 + A2 δ2 for the state (δφ, δv, δp)
    I3 = torch.eye(3, dtype=dR1.dtype, device=dR1.device).expand(dR1.shape)
    Z3 = torch.zeros_like(dR1)
    A1 = torch.cat([
        torch.cat([dR2T, Z3, Z3], dim=-1),
        torch.cat([-dR1 @ hat_dv2, I3, Z3], dim=-1),
        torch.cat([-dR1 @ hat_dp2, I3 * t2, I3], dim=-1),
    ], dim=-2)
    A2 = torch.cat([
        torch.cat([I3, Z3, Z3], dim=-1),
        torch.cat([Z3, dR1, Z3], dim=-1),
        torch.cat([Z3, Z3, dR1], dim=-1),
    ], dim=-2)
    cov = (A1 @ pre1.cov @ torch.swapaxes(A1, -1, -2)
           + A2 @ pre2.cov @ torch.swapaxes(A2, -1, -2))
    return Preintegrated(dR=dR, dv=dv, dp=dp, dt=pre1.dt + dt2, JRg=JRg,
                         Jvg=Jvg, Jva=Jva, Jpg=Jpg, Jpa=Jpa, cov=cov,
                         bg=pre1.bg, ba=pre1.ba)


def bias_corrected(pre: Preintegrated, bg: torch.Tensor, ba: torch.Tensor):
    """First-order bias-corrected deltas (dR, dv, dp) at new biases."""
    dbg = bg - pre.bg
    dba = ba - pre.ba
    dR = pre.dR @ lie.so3_exp(_mv(pre.JRg, dbg))
    dv = pre.dv + _mv(pre.Jvg, dbg) + _mv(pre.Jva, dba)
    dp = pre.dp + _mv(pre.Jpg, dbg) + _mv(pre.Jpa, dba)
    return dR, dv, dp


def residual(pre: Preintegrated, R_i, p_i, v_i, R_j, p_j, v_j, bg, ba,
             scale=1.0, g_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """9-dim preintegration residual (r_ΔR, r_Δv, r_Δp); Forster eq. 45.
    `scale` multiplies translations and velocities (the VI initializer's
    up-to-scale visual map). Pure: it runs under `torch.func` transforms."""
    if g_w is None:
        g_w = gravity_like(pre.dv)
    dR, dv, dp = bias_corrected(pre, bg, ba)
    dt = pre.dt[..., None]
    R_iT = torch.swapaxes(R_i, -1, -2)
    r_R = lie.so3_log(torch.swapaxes(dR, -1, -2) @ R_iT @ R_j)
    r_v = _mv(R_iT, scale * (v_j - v_i) - g_w * dt) - dv
    r_p = _mv(R_iT, scale * (p_j - p_i - v_i * dt) - 0.5 * g_w * dt * dt) - dp
    return torch.cat([r_R, r_v, r_p], dim=-1)


def information(pre: Preintegrated, eps: float = 1e-8) -> torch.Tensor:
    """(..., 9, 9) information matrix = cov⁻¹ (regularized); no host sync
    (`inv_ex` does not check for a singular matrix)."""
    eye = torch.eye(9, dtype=pre.cov.dtype, device=pre.cov.device)
    return torch.linalg.inv_ex(pre.cov + eps * eye).inverse


def stack(pres) -> Preintegrated:
    """Stack a sequence of intervals along a new leading dimension."""
    return Preintegrated(*(torch.stack(xs) for xs in zip(*pres)))


def index(pre: Preintegrated, i) -> Preintegrated:
    """Interval `i` (or a slice) of a stacked Preintegrated."""
    return Preintegrated(*(x[i] for x in pre))


def preintegrated_from_numpy(fields, device="cpu") -> Preintegrated:
    """A Preintegrated of float32 tensors from numpy arrays: a mapping of
    the field names, or any named tuple with those fields (a JAX
    `Preintegrated` converted with `np.asarray`). The state counterpart of
    `atlas.map_state.from_numpy`."""
    if not isinstance(fields, Mapping):
        fields = fields._asdict()
    return Preintegrated(**{
        k: torch.as_tensor(np.array(fields[k], np.float32), device=device)
        for k in Preintegrated._fields})


def to_numpy(pre: Preintegrated) -> dict:
    """The fields of `pre` as numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in pre._asdict().items()}
