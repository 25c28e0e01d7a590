"""The card's peaks and the algorithmic work of the layers that a roofline
share is read for, counted from the configuration's shapes and the
generated inputs, never from the program's own layout.

Peaks: NVIDIA's H100 SXM data sheet at the full 700 W, HBM3 bytes/s and
float32 operations/s outside the tensor cores (the program keeps TF32
off), as `orb_slam3_ros2_tpu_torch/tools/roofline.py` states them; the
frontend's operations per pixel are that file's counts (FAST-9 162, 3x3
NMS 8, separable 7x7 blur 26). Its `frontend_packed_cost` counts the
outputs over the kernel's packed canvas, a layout of the implementation;
this copy counts them over the pyramid's pixels.
"""

from __future__ import annotations

import math

import torch

PEAK_BYTES_S, PEAK_OPS_S = 3.35e12, 67e12
OPS_FAST, OPS_NMS, OPS_BLUR = 162, 8, 26


def bound_ms(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_OPS_S) * 1e3


def level_shapes(height, width, n_levels, scale_factor):
    return [(max(int(round(height / scale_factor ** l)), 32),
             max(int(round(width / scale_factor ** l)), 32))
            for l in range(n_levels)]


def frontend_cost(height, width, n_levels, scale_factor) -> dict:
    """The packed frontend's work on one pyramid: every level read once
    (f32), score, blur and raw (f32) and keep (bool) written once per
    pyramid pixel, FAST, NMS and blur on every pixel."""
    n_px = sum(h * w for h, w in level_shapes(height, width, n_levels,
                                              scale_factor))
    n_bytes = 4 * n_px + 13 * n_px
    n_ops = (OPS_FAST + OPS_NMS + OPS_BLUR) * n_px
    return dict(bytes=n_bytes, ops=n_ops, bound_ms=bound_ms(n_bytes, n_ops))


# A BA iteration, per valid observation: projection and residual (~30),
# the 2x6 and 2x3 Jacobians (~40), the camera block's 21 and the landmark
# block's 6 upper entries and both gradients (2 rows x 2 operations each:
# 108), the 6x3 cross block W (72), H_ll⁻¹ Wᵀ (108), the robust weight and
# costs at the linearization point, the candidate and the gate (~40), and
# the back-substitution Wᵀ Δx_c (36); per landmark the 3x3 inverse and its
# damping (~60); per unordered pair of observations of one landmark, the
# pair with itself included, the 6x6 Schur block W_a (H⁻¹ W_bᵀ) (216; the
# reduced camera system is symmetric, so a landmark seen c times needs
# (c² + c) / 2 of them); the reduced camera solve (6K)³ / 3 and the
# retraction of each pose (~150).
OPS_OBS, OPS_LM, OPS_PAIR, OPS_POSE = 434, 60, 216, 150


def ba_iter_cost(problem) -> dict:
    """One BA iteration's work on the generated problem: operations as
    above; bytes: each observation (its uv and its keyframe and landmark
    ids, 16 B) and each pose and point read once, the updated poses and
    points written once, and the reduced camera system (6K)² f32 written
    and read once."""
    n_obs = int(problem.k.shape[0])
    L = int(torch.unique(problem.l).numel())
    K = int(problem.R.shape[0])
    c = torch.bincount(problem.l).double()
    pairs = int(((c * c + c) / 2).sum())
    n_ops = (OPS_OBS * n_obs + OPS_LM * L + OPS_PAIR * pairs
             + (6 * K) ** 3 / 3 + OPS_POSE * K)
    n_bytes = 16 * n_obs + 2 * (48 * K + 12 * L) + 2 * 4 * (6 * K) ** 2
    return dict(bytes=n_bytes, ops=n_ops, bound_ms=bound_ms(n_bytes, n_ops),
                observations=n_obs, landmarks=L, keyframes=K, pairs=pairs)


def share(bound: float, measured_ms: float):
    """A share of the roofline in %, or None where nothing was measured."""
    if not measured_ms or measured_ms <= 0 or not math.isfinite(
            measured_ms):
        return None
    return 100.0 * bound / measured_ms
