"""FAST-9/16 corner score and 3x3 non-max suppression, plain torch.

Port of `orb_slam3_ros2_tpu/ops/fast.py`. The score is the exact corner
score (the largest threshold at which the segment test still passes): the
max over the 16 arcs of the min over 9 ring differences, for both polarities.
"""

from __future__ import annotations

import torch

# Bresenham circle of radius 3, 16 offsets (dy, dx), clockwise from 12 o'clock.
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9  # FAST-9
BORDER = 3


def _ring(img: torch.Tensor) -> torch.Tensor:
    """(16, H, W): out[i, y, x] = img[y+dy_i, x+dx_i], wrap-around rolls;
    callers mask a BORDER-pixel frame."""
    return torch.stack(
        [torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))
         for dy, dx in CIRCLE_OFFSETS], dim=0)


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """Per-pixel FAST-9 score of an (H, W) f32 image; border pixels 0."""
    d_bright = _ring(img) - img[None]
    d_dark = -d_bright

    def windowed_max_min(d):
        dpad = torch.cat([d, d[:ARC_LEN - 1]], dim=0)  # (24, H, W)
        best = torch.full(img.shape, float("-inf"), dtype=img.dtype,
                          device=img.device)
        for k in range(16):
            best = torch.maximum(best, dpad[k:k + ARC_LEN].amin(dim=0))
        return best

    score = torch.maximum(windowed_max_min(d_bright),
                          windowed_max_min(d_dark)).clamp(min=0.0)
    h, w = img.shape
    mask = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    mask[BORDER:h - BORDER, BORDER:w - BORDER] = True
    return torch.where(mask, score, torch.zeros_like(score))


def nms3x3(score: torch.Tensor, pad_value: float = -1.0) -> torch.Tensor:
    """3x3 NMS: strict local maxima, ties broken in raster order (strict `>`
    against the earlier neighbours, `>=` against the later ones). Cells
    outside the image count as `pad_value` (the kernels' zero padding: 0)."""
    h, w = score.shape
    pad = torch.nn.functional.pad(score, (1, 1, 1, 1), value=pad_value)
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neigh = pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            if (dy, dx) < (0, 0) or (dy, dx) == (0, -1):
                keep &= score > neigh
            else:
                keep &= score >= neigh
    return keep
