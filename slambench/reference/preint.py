"""Plain IMU preintegration, the reference of a keyframe interval's
preintegrated deltas.

The interval's samples are worked out again from the benchmark's own IMU
stream: those in (t_prev_kf, t_kf], closed by a sample at t_kf (linear
interpolation against the next sample, or the last one held) when none
lies on it, at most `cap` of them, each integrated over its gap to the one
before (the first from t_prev_kf, at least 1e-5 s). The deltas follow the
on-manifold Euler step at the linearization biases (bg, ba):
ΔR ← ΔR Exp((ω − bg) dt), Δp ← Δp + Δv dt + ½ ΔR (a − ba) dt²,
Δv ← Δv + ΔR (a − ba) dt. It imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slambench.reference.ba import so3_exp_and_jl


def interval_samples(imu_t, gyro, acc, t_a: float, t_b: float, cap: int):
    """(gyro (M, 3), acc (M, 3), dts (M,)) of the interval (t_a, t_b]."""
    sel = (imu_t > t_a) & (imu_t <= t_b)
    ts, gy, ac = list(imu_t[sel]), list(gyro[sel]), list(acc[sel])
    if ts and ts[-1] < t_b - 1e-9:
        nxt = np.where(imu_t > t_b)[0]
        if nxt.size:
            j = nxt[0]
            w = (t_b - ts[-1]) / max(imu_t[j] - ts[-1], 1e-9)
            gy.append((1 - w) * gy[-1] + w * gyro[j])
            ac.append((1 - w) * ac[-1] + w * acc[j])
        else:
            gy.append(gy[-1])
            ac.append(ac[-1])
        ts.append(t_b)
    ts, gy, ac = ts[:cap], gy[:cap], ac[:cap]
    dts = np.maximum(np.diff(np.concatenate([[t_a], ts])), 1e-5)
    return np.asarray(gy), np.asarray(ac), dts


def preintegrate(gyro, acc, dts, bg, ba, dtype=torch.float64,
                 device="cpu"):
    """(ΔR, Δv, Δp) in `dtype`."""
    f = lambda v: torch.as_tensor(np.asarray(v, np.float64)).to(
        device=device, dtype=dtype)
    g, a, d = f(gyro), f(acc), f(dts)
    wd = (g - f(bg)) * d[:, None]
    ad = a - f(ba)
    dRk, _ = so3_exp_and_jl(wd)
    dR = torch.eye(3, dtype=dtype, device=device)
    dv = torch.zeros(3, dtype=dtype, device=device)
    dp = torch.zeros(3, dtype=dtype, device=device)
    for k in range(d.shape[0]):
        a_rot = dR @ ad[k]
        dp = dp + dv * d[k] + 0.5 * a_rot * d[k] * d[k]
        dv = dv + a_rot * d[k]
        dR = dR @ dRk[k]
    return dR, dv, dp


def gap(prog, ref) -> float:
    """The largest of the rotation gap in radians and the velocity and
    position gaps relative to the reference's deltas."""
    (Rp, vp, pp), (Rr, vr, pr) = ([x.double().cpu() for x in s]
                                  for s in (prog, ref))
    rot = float(torch.linalg.matrix_norm(Rp - Rr)) / math.sqrt(2.0)
    dv = float((vp - vr).norm() / vr.norm().clamp(min=1e-9))
    dp = float((pp - pr).norm() / pr.norm().clamp(min=1e-9))
    return max(rot, dv, dp)
