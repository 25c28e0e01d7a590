"""The card's peaks and the work of the port's main-path kernels, counted
from their code: the one place that `chip_smoke.py` and
`tools/profile_tracking.py` read them from.

A bound is the least time the card could take for a call: the larger of
the bytes the call must move (each input read once, each output written
once) over the memory rate and its operations over the f32 rate.
"""

from __future__ import annotations

import subprocess

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W): HBM3 bytes/s, f32
# operations/s outside the tensor cores (integer and min/max operations
# are counted at the same rate; TF32 is off in the port)
PEAK_BYTES_S, PEAK_OPS_S = 3.35e12, 67e12
# operations per pixel, counted from the kernels' code: FAST-9 by the
# doubling window (64 min + 64 max, 30 arc maxima/minima, 2 subtractions,
# 2 max), 3x3 NMS (8 compares), separable 7x7 blur (2 x 7 multiplies + 2 x
# 6 adds); the moment maps' prefix sums (4) and 31 disc rows (6 each, + 2)
OPS_FAST, OPS_NMS, OPS_BLUR, OPS_MOMENTS = 162, 8, 26, 192
# match: the window test of a pair (2 sub, 2 abs, 2 compare, the masks);
# a pair inside the window: 8 XOR, 8 popcount, 8 adds, the row's top-2 and
# the column's argmin
OPS_MATCH_PAIR, OPS_MATCH_IN_WINDOW = 7, 28
# pose LM: 3 rounds x (1 + 5) evaluations of ~235 operations a point
# (transform 18, projection and residual 16, chi2/Huber/weights 15,
# Jacobian 18, the 28 Gram entries 168)
POSE_EVALS, OPS_POSE_POINT = 18, 235


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the f32 rate."""
    t_b = n_bytes / PEAK_BYTES_S * 1e3
    t_o = n_ops / PEAK_OPS_S * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                bytes=n_bytes, ops=n_ops)


def frontend_packed_cost(n_px: int, canvas_cells: int):
    """`frontend_pass_packed` over levels of `n_px` pixels in all and a
    canvas of `canvas_cells`: the levels read once (f32), score, blur and
    raw (f32) and keep (bool) written once over the canvas."""
    return (4 * n_px + 13 * canvas_cells,
            (OPS_FAST + OPS_NMS + OPS_BLUR) * n_px)


def match_cost(uva, ma, uvb, mb, radius: float):
    """`match_window` of N rows against M columns: each input read once
    (41 B a row or column: 32 B of bits, 8 of uv, 1 of mask), idx, dist
    and valid written once; the window test on every pair, the distance
    and top-2 on the pairs inside the window (counted on these inputs)."""
    N, M = uva.shape[0], uvb.shape[0]
    win = (((uva[:, None, 0] - uvb[None, :, 0]).abs() <= radius)
           & ((uva[:, None, 1] - uvb[None, :, 1]).abs() <= radius)
           & ma[:, None] & mb[None, :])
    return (41 * (N + M) + 9 * N,
            OPS_MATCH_PAIR * N * M + OPS_MATCH_IN_WINDOW * int(win.sum()))


def pose_cost(n_points: int):
    """`optimize_pose_fused` on N observations: X, uv, inverse sigma², mask
    (26 B a point) and the start pose read once, the pose, inliers and
    count written once; 18 evaluations of every point."""
    return (26 * n_points + 48 + 68,
            POSE_EVALS * OPS_POSE_POINT * n_points)


def card(device) -> dict:
    """The card's `name` and `power.limit` as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them, for
    the card behind `device`; both None for a CPU run."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"name": None, "power.limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    name, limit = lines[dev.index or 0].rsplit(",", 1)
    return {"name": name.strip(), "power.limit": limit.strip()}
