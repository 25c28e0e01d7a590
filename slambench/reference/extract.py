"""Plain ORB extraction, the reference that the program's features are
held to: pyramid, FAST-9 score, 3x3 NMS, 7x7 Gaussian blur, per-cell grid
selection, intensity-centroid angle, steered BRIEF-256, and the radtan
undistortion of the keypoints.

A frozen copy of the plain torch versions in `orb_slam3_ros2_tpu_torch`
(`ops/pyramid.py`: `level_shapes`, `_gauss_kernel1d`, `features_per_level`,
`scale_factors`, `gaussian_blur`, `_resize_weights`, `resize`,
`build_pyramid`; `ops/fast.py`: `fast_score`, `nms3x3`;
`frontend/extractor.py`: `_first_argmax`, `_level_grid_select` and the
body of `make_extractor`; `ops/orb_descriptor.py`: `brief_pattern`,
`_orientation_weights`, `gather_patches`, `orientations`,
`_bilinear_sample`, `_describe_exact`, `pack_bits`;
`models/cameras.py`: `_unproject_pinhole`). The levels are scored and
blurred one by one, as the program's plain `frontend_pass_packed_ref`
does, with no packed canvas. It imports nothing of the program.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

CELL, PER_CELL, EDGE = 32, 5, 19
PATCH, PATTERN_R, N_BITS, ORI_RADIUS = 31, 13.0, 256, 15
PATCH_R = PATCH // 2
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN, BORDER = 9, 3


def level_shapes(height, width, n_levels, scale_factor):
    shapes = []
    for lvl in range(n_levels):
        s = scale_factor ** lvl
        shapes.append((max(int(round(height / s)), 32),
                       max(int(round(width / s)), 32)))
    return shapes


@functools.lru_cache(maxsize=None)
def _gauss_kernel1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def features_per_level(n_features, n_levels, scale_factor) -> List[int]:
    inv = 1.0 / scale_factor
    base = n_features * (1.0 - inv) / (1.0 - inv ** n_levels)
    counts, acc = [], 0
    for lvl in range(n_levels - 1):
        c = int(round(base * inv ** lvl))
        counts.append(c)
        acc += c
    counts.append(max(n_features - acc, 0))
    return counts


def gaussian_blur(img: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    k = [float(v) for v in _gauss_kernel1d(ksize, sigma)]
    r = ksize // 2
    H, W = img.shape
    x = torch.nn.functional.pad(img[None, None], (0, 0, r, r),
                                mode="reflect")[0, 0]
    v = sum(k[i] * x[i:i + H, :] for i in range(ksize))
    y = torch.nn.functional.pad(v[None, None], (r, r, 0, 0),
                                mode="reflect")[0, 0]
    return sum(k[i] * y[:, i:i + W] for i in range(ksize))


@functools.lru_cache(maxsize=None)
def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
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
    h, w = img.shape
    out = img
    if shape[0] != h:
        out = torch.from_numpy(_resize_weights(h, shape[0])).to(
            img.device, img.dtype) @ out
    if shape[1] != w:
        out = out @ torch.from_numpy(_resize_weights(w, shape[1])).to(
            img.device, img.dtype).T
    return out


def build_pyramid(img, n_levels, scale_factor):
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for lvl in range(1, n_levels):
        levels.append(resize(levels[-1], shapes[lvl]))
    return levels


def fast_score(img: torch.Tensor) -> torch.Tensor:
    ring = torch.stack([torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))
                        for dy, dx in CIRCLE_OFFSETS], dim=0)
    d_bright = ring - img[None]

    def windowed_max_min(d):
        dpad = torch.cat([d, d[:ARC_LEN - 1]], dim=0)
        best = torch.full(img.shape, float("-inf"), dtype=img.dtype,
                          device=img.device)
        for k in range(16):
            best = torch.maximum(best, dpad[k:k + ARC_LEN].amin(dim=0))
        return best

    score = torch.maximum(windowed_max_min(d_bright),
                          windowed_max_min(-d_bright)).clamp(min=0.0)
    h, w = img.shape
    mask = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    mask[BORDER:h - BORDER, BORDER:w - BORDER] = True
    return torch.where(mask, score, torch.zeros_like(score))


def nms3x3(score: torch.Tensor, pad_value: float = -1.0) -> torch.Tensor:
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


def _first_argmax(x: torch.Tensor):
    mx = x.amax(dim=1)
    col = torch.arange(x.shape[1], device=x.device)
    idx = torch.where(x == mx[:, None], col, x.shape[1]).amin(dim=1)
    return mx, idx


def _level_grid_select(score, keep, ini_th, min_th, budget):
    h, w = score.shape
    dev = score.device
    cand = keep & (score > min_th)
    BONUS = 1e4
    rank = torch.where(cand, score + torch.where(score > ini_th, BONUS, 0.0),
                       -1.0)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    interior = (ys >= EDGE) & (ys < h - EDGE) & (xs >= EDGE) & (xs < w - EDGE)
    rank = torch.where(interior, rank, -1.0)
    ph = -(-h // CELL) * CELL
    pw = -(-w // CELL) * CELL
    rp = torch.nn.functional.pad(rank, (0, pw - w, 0, ph - h), value=-1.0)
    cells = rp.reshape(ph // CELL, CELL, pw // CELL, CELL).permute(0, 2, 1, 3)
    cells = cells.reshape(-1, CELL * CELL)
    col = torch.arange(cells.shape[1], device=dev)[None, :]
    ranks, idxs = [], []
    for _ in range(PER_CELL):
        mx, i = _first_argmax(cells)
        ranks.append(mx)
        idxs.append(i)
        cells = torch.where(col == i[:, None], -1.0, cells)
    cell_rank = torch.stack(ranks, dim=1)
    cell_idx = torch.stack(idxs, dim=1)
    n_cells_x = pw // CELL
    cell_ids = torch.arange((ph // CELL) * n_cells_x, device=dev)
    cy = (cell_ids // n_cells_x)[:, None]
    cx = (cell_ids % n_cells_x)[:, None]
    py = (cy * CELL + cell_idx // CELL).reshape(-1)
    px = (cx * CELL + cell_idx % CELL).reshape(-1)
    flat_rank = cell_rank.reshape(-1)
    k = min(budget, flat_rank.shape[0])
    order = torch.sort(flat_rank, descending=True, stable=True).indices[:k]
    top_rank = flat_rank[order]
    yx = torch.stack([py[order], px[order]], dim=-1).to(torch.int32)
    valid = top_rank > 0.0
    yi = yx[:, 0].long().clamp(1, h - 2)
    xi = yx[:, 1].long().clamp(1, w - 2)
    s0 = score[yi, xi]
    sym, syp = score[yi - 1, xi], score[yi + 1, xi]
    sxm, sxp = score[yi, xi - 1], score[yi, xi + 1]
    dy = 0.5 * (sym - syp) / torch.clamp(sym - 2 * s0 + syp, max=-1e-6)
    dx = 0.5 * (sxm - sxp) / torch.clamp(sxm - 2 * s0 + sxp, max=-1e-6)
    offset = torch.stack([dy.clamp(-0.5, 0.5), dx.clamp(-0.5, 0.5)], dim=-1)
    if k < budget:
        pad = budget - k
        yx = torch.nn.functional.pad(yx, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
        offset = torch.nn.functional.pad(offset, (0, 0, 0, pad))
    return yx, valid, offset


@functools.lru_cache(maxsize=None)
def brief_pattern() -> np.ndarray:
    rng = np.random.default_rng(1769)
    pts = []
    while len(pts) < N_BITS * 2:
        cand = rng.normal(scale=PATTERN_R / 2.0, size=(N_BITS, 2))
        r = np.linalg.norm(cand, axis=-1)
        pts.extend(cand[r <= PATTERN_R - 0.5].tolist())
    return np.asarray(pts[: N_BITS * 2], dtype=np.float32).reshape(
        N_BITS, 2, 2)


@functools.lru_cache(maxsize=None)
def _orientation_weights() -> np.ndarray:
    yy, xx = np.mgrid[-PATCH_R:PATCH_R + 1, -PATCH_R:PATCH_R + 1]
    mask = ((yy * yy + xx * xx) <= ORI_RADIUS * ORI_RADIUS).astype(np.float32)
    return np.stack([(mask * yy).ravel(), (mask * xx).ravel()],
                    axis=-1).astype(np.float32)


def gather_patches(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    H, W = img.shape
    start = yx.to(torch.int64) - PATCH_R
    sy = torch.where(start[:, 0] < 0, start[:, 0] + H,
                     start[:, 0]).clamp(0, H - PATCH)
    sx = torch.where(start[:, 1] < 0, start[:, 1] + W,
                     start[:, 1]).clamp(0, W - PATCH)
    d = torch.arange(PATCH, device=img.device)
    rows = (sy[:, None] + d[None, :])[:, :, None]
    cols = (sx[:, None] + d[None, :])[:, None, :]
    return img.reshape(-1)[rows * W + cols]


def orientations(patches: torch.Tensor) -> torch.Tensor:
    wts = torch.from_numpy(_orientation_weights()).to(patches.device,
                                                       patches.dtype)
    m = patches.reshape(patches.shape[0], -1) @ wts
    return torch.atan2(m[:, 0], m[:, 1])


def _bilinear_sample(flat, y, x):
    y = (y + PATCH_R).clamp(0.0, PATCH - 1.001)
    x = (x + PATCH_R).clamp(0.0, PATCH - 1.001)
    y0, x0 = torch.floor(y), torch.floor(x)
    fy, fx = y - y0, x - x0
    idx = y0.to(torch.int64) * PATCH + x0.to(torch.int64)
    v00 = torch.gather(flat, 1, idx)
    v01 = torch.gather(flat, 1, idx + 1)
    v10 = torch.gather(flat, 1, idx + PATCH)
    v11 = torch.gather(flat, 1, idx + PATCH + 1)
    return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)


def describe_bits(patches: torch.Tensor, angles: torch.Tensor):
    pat = torch.from_numpy(brief_pattern()).to(patches.device,
                                               patches.dtype)
    cos, sin = torch.cos(angles), torch.sin(angles)
    py, px = pat[:, :, 0][None], pat[:, :, 1][None]
    ry = sin[:, None, None] * px + cos[:, None, None] * py
    rx = cos[:, None, None] * px - sin[:, None, None] * py
    N = patches.shape[0]
    vals = _bilinear_sample(patches.reshape(N, -1), ry.reshape(N, -1),
                            rx.reshape(N, -1)).reshape(N, N_BITS, 2)
    return pack_bits((vals[:, :, 0] - vals[:, :, 1]) < 0)


def pack_bits(bits_bool: torch.Tensor) -> torch.Tensor:
    b = bits_bool.to(torch.int64).reshape(-1, 8, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=b.device)
    words = torch.sum(b << shifts, dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def undistort(params: Sequence[float], uv: torch.Tensor,
              iters: int = 8) -> torch.Tensor:
    """Raw pixels -> undistorted pinhole pixels of the same intrinsics
    (radtan, fixed-point)."""
    fx, fy, cx, cy, k1, k2, p1, p2, k3 = [float(v) for v in params]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    a, b = xd, yd
    for _ in range(iters):
        r2 = a * a + b * b
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * a * b + p2 * (r2 + 2.0 * a * a)
        dy = p1 * (r2 + 2.0 * b * b) + 2.0 * p2 * a * b
        a = (xd - dx) / radial
        b = (yd - dy) / radial
    return torch.stack([fx * a + cx, fy * b + cy], dim=-1)


def extract(img: torch.Tensor, n_features: int, n_levels: int,
            scale_factor: float, ini_th: float, min_th: float,
            cam_params: Sequence[float]) -> dict:
    """Features of one (H, W) f32 image in the program's fixed order:
    {"uv" (N, 2) undistorted, "level" (N,), "bits" (N, 8), "mask" (N,)}."""
    dev = img.device
    budgets = features_per_level(n_features, n_levels, scale_factor)
    levels = build_pyramid(img, n_levels, scale_factor)
    uv_all, lvl_all, mask_all, bits_all = [], [], [], []
    for lvl, (im_l, budget) in enumerate(zip(levels, budgets)):
        if budget <= 0:
            continue
        h, w = im_l.shape
        score = fast_score(im_l)
        keep = nms3x3(score)
        yx, valid, sub = _level_grid_select(score, keep, ini_th, min_th,
                                            budget)
        yx = torch.stack([yx[:, 0].clamp(EDGE, h - EDGE - 1),
                          yx[:, 1].clamp(EDGE, w - EDGE - 1)], dim=-1)
        s = float(np.float32(scale_factor ** lvl))
        uv_all.append(torch.stack([(yx[:, 1].float() + sub[:, 1]) * s,
                                   (yx[:, 0].float() + sub[:, 0]) * s],
                                  dim=-1))
        lvl_all.append(torch.full((budget,), lvl, dtype=torch.int32,
                                  device=dev))
        mask_all.append(valid)
        raw = gather_patches(im_l, yx)
        blur = gather_patches(gaussian_blur(im_l), yx)
        bits_all.append(describe_bits(blur, orientations(raw)))
    uv = torch.cat(uv_all)
    return dict(uv=undistort(cam_params, uv), level=torch.cat(lvl_all),
                bits=torch.cat(bits_all), mask=torch.cat(mask_all))


def mismatch(prog: dict, ref: dict, uv_tol: float = 1e-3) -> Tuple[int, int]:
    """(features that differ, features valid on either side): a feature
    differs when its validity, level or descriptor differ, or its
    undistorted position by more than `uv_tol` px."""
    valid = prog["mask"] | ref["mask"]
    same = ((prog["mask"] == ref["mask"]) & (prog["level"] == ref["level"])
            & (prog["bits"] == ref["bits"]).all(-1)
            & ((prog["uv"] - ref["uv"]).abs().amax(-1) <= uv_tol))
    return int((valid & ~same).sum()), int(valid.sum())
