"""Steered BRIEF-256 descriptors + intensity-centroid orientation.

Port of the exact path of `orb_slam3_ros2_tpu/ops/orb_descriptor.py`: patch
gather by index arithmetic, orientation from disc moments, exact per-keypoint
steering with bilinear sampling, and bit packing. The TPU-only layout work
there (`_gather_patches_block`, `_describe_binned`) is not ported; the exact
path is the oracle.

Packed descriptors are (N, 8) int32 tensors holding the bits of the JAX
package's uint32 words (torch's uint32 lacks shifts and bitwise ops);
`np.ndarray.view(np.int32)` converts at the boundary.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PATCH = 31  # gathered patch edge (±15 around the keypoint)
PATCH_R = PATCH // 2
PATTERN_R = 13.0  # sampling pattern disc radius; rotation-safe inside PATCH
N_BITS = 256
ORI_RADIUS = 15


# copied verbatim from orb_slam3_ros2_tpu/ops/orb_descriptor.py:37-48 —
# the pattern is part of the descriptor format
@functools.lru_cache(maxsize=None)
def brief_pattern() -> np.ndarray:
    """(256, 2, 2) float32: per bit, two (y, x) offsets inside the disc."""
    rng = np.random.default_rng(1769)  # fixed seed — pattern is part of the format
    pts = []
    while len(pts) < N_BITS * 2:
        cand = rng.normal(scale=PATTERN_R / 2.0, size=(N_BITS, 2))
        r = np.linalg.norm(cand, axis=-1)
        ok = cand[r <= PATTERN_R - 0.5]
        pts.extend(ok.tolist())
    arr = np.asarray(pts[: N_BITS * 2], dtype=np.float32).reshape(N_BITS, 2, 2)
    return arr


@functools.lru_cache(maxsize=None)
def _orientation_weights() -> np.ndarray:
    """(PATCH*PATCH, 2) disc-masked (y, x) moment weights."""
    yy, xx = np.mgrid[-PATCH_R:PATCH_R + 1, -PATCH_R:PATCH_R + 1]
    mask = ((yy * yy + xx * xx) <= ORI_RADIUS * ORI_RADIUS).astype(np.float32)
    return np.stack([(mask * yy).ravel(), (mask * xx).ravel()],
                    axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _on_device(make, device: torch.device) -> torch.Tensor:
    """The constant array `make()` on `device`, uploaded once: an upload on
    every frame would make the host wait for the copy. Read-only."""
    return torch.from_numpy(make()).to(device)


def gather_patches(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """(N, PATCH, PATCH) patches centered at integer coords yx (N, 2).

    Window starts follow `lax.dynamic_slice` in the JAX version: a negative
    start wraps by the image size, then starts are clamped into the image.
    The extractor keeps keypoints PATCH_R inside, where neither applies."""
    H, W = img.shape
    start = yx.to(torch.int64) - PATCH_R
    sy, sx = start[:, 0], start[:, 1]
    sy = torch.where(sy < 0, sy + H, sy).clamp(0, H - PATCH)
    sx = torch.where(sx < 0, sx + W, sx).clamp(0, W - PATCH)
    d = torch.arange(PATCH, device=img.device)
    rows = (sy[:, None] + d[None, :])[:, :, None]
    cols = (sx[:, None] + d[None, :])[:, None, :]
    return img.reshape(-1)[rows * W + cols]


def gather_patches_multi(imgs, yx: torch.Tensor):
    """The same (N, PATCH, PATCH) windows from several same-shape images."""
    return tuple(gather_patches(im, yx) for im in imgs)


def orientations(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle per patch: (N, P, P) -> (N,) radians."""
    wts = _on_device(_orientation_weights, patches.device)
    m = patches.reshape(patches.shape[0], -1) @ wts
    return torch.atan2(m[:, 0], m[:, 1])


def moment_maps(img: torch.Tensor):
    """Full-image IC moments: (m01, m10) of the radius-15 disc at every
    pixel, from two row cumsums and 31 shifted-difference adds.

    Port of `orb_slam3_ros2_tpu/ops/orb_descriptor.py:185` (same padding:
    zero rows above and below, edge columns beside). Per disc row dy the
    mask covers |dx| <= u(dy) = floor(sqrt(R² − dy²)), so the row's
    contribution is a prefix-sum difference. The prefix sums and the adds
    run in float64: the x-weighted prefix sum of a 752-wide row reaches
    ~7e7, where float32 rounding alone would exceed the moments' tolerance
    (rtol 2e-4, atol 2) at full width. Exact on the interior (>= 15 px from
    the border); returns float32 maps."""
    H, W = img.shape
    R = ORI_RADIUS
    x = img.to(torch.float64)
    xs = torch.arange(W, dtype=torch.float64, device=img.device)

    def prefix(v):
        # leading zero column, R zero rows each side, then R edge columns
        # left and R + 1 right so x ± u(dy) indexing stays in bounds
        P = torch.nn.functional.pad(torch.cumsum(v, dim=1), (1, 0, R, R))
        return torch.cat([P[:, :1].expand(-1, R), P,
                          P[:, -1:].expand(-1, R + 1)], dim=1)

    S = prefix(x)
    C = prefix(x * xs[None, :])
    x0 = R  # column offset of image x=0 in the padded prefix arrays
    m01 = torch.zeros((H, W), dtype=torch.float64, device=img.device)
    msum = torch.zeros_like(m01)
    mxw = torch.zeros_like(m01)
    for dy in range(-R, R + 1):
        u = int(np.floor(np.sqrt(R * R - dy * dy)))
        rows = slice(R + dy, R + dy + H)
        hi = slice(x0 + u + 1, x0 + u + 1 + W)
        lo = slice(x0 - u, x0 - u + W)
        rs = S[rows, hi] - S[rows, lo]
        m01 = m01 + dy * rs
        msum = msum + rs
        mxw = mxw + (C[rows, hi] - C[rows, lo])
    m10 = mxw - msum * xs[None, :]
    return m01.to(torch.float32), m10.to(torch.float32)


def _bilinear_sample(flat: torch.Tensor, y: torch.Tensor, x: torch.Tensor):
    """Bilinear samples of flattened (N, P*P) patches at (N, S) coords."""
    y = (y + PATCH_R).clamp(0.0, PATCH - 1.001)
    x = (x + PATCH_R).clamp(0.0, PATCH - 1.001)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    fy = y - y0
    fx = x - x0
    idx = y0.to(torch.int64) * PATCH + x0.to(torch.int64)
    v00 = torch.gather(flat, 1, idx)
    v01 = torch.gather(flat, 1, idx + 1)
    v10 = torch.gather(flat, 1, idx + PATCH)
    v11 = torch.gather(flat, 1, idx + PATCH + 1)
    return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)


def _describe_exact(patches: torch.Tensor, angles: torch.Tensor):
    """Exact-angle steered BRIEF samples: (N, 256, 2) values."""
    pat = _on_device(brief_pattern, patches.device)
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    # rotate by +angle in image coords (y down): y' = s·x + c·y, x' = c·x − s·y
    py = pat[:, :, 0][None]
    px = pat[:, :, 1][None]
    ry = sin[:, None, None] * px + cos[:, None, None] * py
    rx = cos[:, None, None] * px - sin[:, None, None] * py
    N = patches.shape[0]
    vals = _bilinear_sample(patches.reshape(N, -1), ry.reshape(N, -1),
                            rx.reshape(N, -1))
    return vals.reshape(N, N_BITS, 2)


def describe(patches: torch.Tensor, angles: torch.Tensor):
    """Steered BRIEF-256 of blurred patches at angles (N,).

    Returns (signs (N, 256) f32 in {-1, +1}, bits (N, 8) int32)."""
    vals = _describe_exact(patches, angles)
    bits_bool = (vals[:, :, 0] - vals[:, :, 1]) < 0  # tau test: v_s0 < v_s1
    signs = torch.where(bits_bool, 1.0, -1.0).to(torch.float32)
    return signs, pack_bits(bits_bool)


def pack_bits(bits_bool: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool -> (N, 8) int32 (little-endian within each word)."""
    b = bits_bool.to(torch.int64).reshape(-1, 8, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=b.device)
    words = torch.sum(b << shifts, dim=-1)  # in [0, 2^32)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 -> (N, 256) bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], N_BITS).to(torch.bool)


def signs_from_bits(packed: torch.Tensor) -> torch.Tensor:
    return torch.where(unpack_bits(packed), 1.0, -1.0).to(torch.float32)
