"""Image pyramid + Gaussian blur.

Port of `orb_slam3_ros2_tpu/ops/pyramid.py`. `jax.image.resize(...,
"bilinear")` antialiases when it downsamples: every output pixel is a
triangle-filter average whose width grows with the scale. The same weights
are built here in numpy (`_resize_weights`, after JAX's
`compute_weight_mat`), so each level is the plain matrix product
`Wy @ img @ Wx^T`.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch


# level_shapes, _gauss_kernel1d and features_per_level are numpy-only and
# copied verbatim from orb_slam3_ros2_tpu/ops/pyramid.py:24-96.
def level_shapes(height: int, width: int, n_levels: int, scale_factor: float
                 ) -> List[Tuple[int, int]]:
    """Static (H, W) per level; level 0 is the input resolution."""
    shapes = []
    for lvl in range(n_levels):
        s = scale_factor ** lvl
        shapes.append((max(int(round(height / s)), 32), max(int(round(width / s)), 32)))
    return shapes


@functools.lru_cache(maxsize=None)
def _gauss_kernel1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def features_per_level(n_features: int, n_levels: int, scale_factor: float
                       ) -> List[int]:
    """Geometric feature budget per level, summing to n_features."""
    inv = 1.0 / scale_factor
    total = (1.0 - inv ** n_levels) / (1.0 - inv)
    base = n_features * (1.0 - inv) / (1.0 - inv ** n_levels)
    counts = []
    acc = 0
    for lvl in range(n_levels - 1):
        c = int(round(base * inv ** lvl))
        counts.append(c)
        acc += c
    counts.append(max(n_features - acc, 0))
    del total
    return counts


def scale_factors(n_levels: int, scale_factor: float) -> np.ndarray:
    return np.asarray([scale_factor ** i for i in range(n_levels)], dtype=np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0,
                  mode: str = "reflect") -> torch.Tensor:
    """Separable Gaussian blur, rows then columns; img (H, W) float32.
    `mode` pads as torch's `pad` does: "reflect", or "constant" (zeros,
    the kernels' padding)."""
    k = [float(v) for v in _gauss_kernel1d(ksize, sigma)]
    r = ksize // 2
    H, W = img.shape
    x = torch.nn.functional.pad(img[None, None], (0, 0, r, r),
                                mode=mode)[0, 0]
    v = sum(k[i] * x[i:i + H, :] for i in range(ksize))
    y = torch.nn.functional.pad(v[None, None], (r, r, 0, 0),
                                mode=mode)[0, 0]
    return sum(k[i] * y[:, i:i + W] for i in range(ksize))


@functools.lru_cache(maxsize=None)
def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) f32 antialiased triangle-filter weights.

    Same arithmetic as JAX's `compute_weight_mat` for a pure scale with
    translation 0: sample positions (i + 0.5)/scale - 0.5, triangle kernel
    widened by 1/scale when downsampling, columns normalized to sum 1, and
    samples outside [-0.5, in - 0.5] zeroed."""
    scale = out_size / in_size
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.0) * inv_scale - np.float32(0.5))
    x = (np.abs(sample_f[None, :]
                - np.arange(in_size, dtype=np.float32)[:, None])
         / kernel_scale)
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, 0).astype(np.float32)
    return np.ascontiguousarray(w.T)


def resize(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize of an (H, W) image, as jax.image.resize."""
    h, w = img.shape
    out = img
    if shape[0] != h:
        Wy = torch.from_numpy(_resize_weights(h, shape[0])).to(img.device)
        out = Wy @ out
    if shape[1] != w:
        Wx = torch.from_numpy(_resize_weights(w, shape[1])).to(img.device)
        out = out @ Wx.T
    return out


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float
                  ) -> List[torch.Tensor]:
    """Per-level images, each resized from the previous level."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for lvl in range(1, n_levels):
        levels.append(resize(levels[-1], shapes[lvl]))
    return levels
