"""ORB feature extraction: pyramid → packed FAST/NMS/blur → per-cell grid
select → orientation → steered BRIEF, with fixed output capacity.

Port of `orb_slam3_ros2_tpu/frontend/extractor.py`. Each level is divided
into CELL×CELL cells; per cell the PER_CELL best NMS survivors are kept, with
a ranking bonus for clearing the high threshold (the iniThFAST→minThFAST
fallback without control flow), then a global top-`budget` per level.

Tie order follows the JAX version exactly: the per-cell argmax takes the
first maximum, and the per-level top-k is a stable descending sort, so equal
ranks keep the lower index first as `lax.top_k` does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from orb_slam3_ros2_tpu_torch.ops import frontend_packed as fp
from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as desc_ops
from orb_slam3_ros2_tpu_torch.ops import pyramid as pyr_ops

CELL = 32  # spatial-uniformity cell size in pixels
PER_CELL = 5  # candidates kept per cell before the global budget top-k
EDGE = 19  # extraction margin: patch radius 15 + blur/fast slack


@dataclasses.dataclass(frozen=True)
class ExtractorConfig:
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    height: int = 480
    width: int = 752


@dataclasses.dataclass
class Features:
    """Fixed-capacity feature set for one frame. All tensors have length N.

    uv (N, 2) f32 level-0 pixel coords (x, y); level (N,) int32; angle (N,)
    f32 radians; score (N,) f32; signs (N, 256) f32 ±1; bits (N, 8) int32
    packed descriptor; mask (N,) bool validity."""

    uv: torch.Tensor
    level: torch.Tensor
    angle: torch.Tensor
    score: torch.Tensor
    signs: torch.Tensor
    bits: torch.Tensor
    mask: torch.Tensor


def _first_argmax(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row max and the lowest column index that reaches it."""
    mx = x.amax(dim=1)
    col = torch.arange(x.shape[1], device=x.device)
    idx = torch.where(x == mx[:, None], col, x.shape[1]).amin(dim=1)
    return mx, idx


def _level_grid_select(score: torch.Tensor, keep: torch.Tensor, ini_th: float,
                       min_th: float, budget: int):
    """Select up to `budget` keypoints on one level.

    Returns (yx (budget, 2) int32, score (budget,), valid (budget,),
    subpixel offset (budget, 2))."""
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
    raw_score = torch.where(top_rank > BONUS / 2, top_rank - BONUS, top_rank)

    # sub-pixel refinement: 1-D parabola fit on the score along each axis
    yi = yx[:, 0].long().clamp(1, h - 2)
    xi = yx[:, 1].long().clamp(1, w - 2)
    s0 = score[yi, xi]
    sym = score[yi - 1, xi]
    syp = score[yi + 1, xi]
    sxm = score[yi, xi - 1]
    sxp = score[yi, xi + 1]
    dy = 0.5 * (sym - syp) / torch.clamp(sym - 2 * s0 + syp, max=-1e-6)
    dx = 0.5 * (sxm - sxp) / torch.clamp(sxm - 2 * s0 + sxp, max=-1e-6)
    offset = torch.stack([dy.clamp(-0.5, 0.5), dx.clamp(-0.5, 0.5)], dim=-1)
    if k < budget:
        pad = budget - k
        yx = torch.nn.functional.pad(yx, (0, 0, 0, pad))
        raw_score = torch.nn.functional.pad(raw_score, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
        offset = torch.nn.functional.pad(offset, (0, 0, 0, pad))
    return yx, raw_score, valid, offset


@functools.lru_cache(maxsize=8)
def make_extractor(cfg: ExtractorConfig):
    """Build extract(img (H, W) f32 tensor) -> Features for a static config.

    N = sum of the per-level budgets; the image's device is used throughout.
    """
    budgets = pyr_ops.features_per_level(cfg.n_features, cfg.n_levels,
                                         cfg.scale_factor)
    scales = pyr_ops.scale_factors(cfg.n_levels, cfg.scale_factor)

    def extract(img: torch.Tensor) -> Features:
        dev = img.device
        levels = pyr_ops.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
        score_c, keep_c, blur_c, raw_c, layout = fp.frontend_pass_packed(levels)
        uv_all, lvl_all, sc_all, yx_all, mask_all = [], [], [], [], []
        for lvl, ((r0, h, w), budget) in enumerate(zip(layout, budgets)):
            if budget <= 0:
                continue
            yx, sc, valid, subpix = _level_grid_select(
                score_c[r0:r0 + h, :w], keep_c[r0:r0 + h, :w],
                cfg.ini_th_fast, cfg.min_th_fast, budget)
            # clamp coords (invalid entries may sit at the border)
            yx = torch.stack([yx[:, 0].clamp(EDGE, h - EDGE - 1),
                              yx[:, 1].clamp(EDGE, w - EDGE - 1)], dim=-1)
            s = float(scales[lvl])
            uv = torch.stack(
                [(yx[:, 1].float() + subpix[:, 1]) * s,
                 (yx[:, 0].float() + subpix[:, 0]) * s], dim=-1)
            uv_all.append(uv)
            lvl_all.append(torch.full((budget,), lvl, dtype=torch.int32,
                                      device=dev))
            sc_all.append(sc)
            yx_all.append(torch.stack([yx[:, 0] + r0, yx[:, 1]], dim=-1))
            mask_all.append(valid)

        yx_packed = torch.cat(yx_all, dim=0)
        patches_raw, patches_desc = desc_ops.gather_patches_multi(
            (raw_c, blur_c), yx_packed)
        angle = desc_ops.orientations(patches_raw)
        signs, bits = desc_ops.describe(patches_desc, angle)
        return Features(
            uv=torch.cat(uv_all, dim=0),
            level=torch.cat(lvl_all, dim=0),
            angle=angle,
            score=torch.cat(sc_all, dim=0),
            signs=signs,
            bits=bits,
            mask=torch.cat(mask_all, dim=0),
        )

    return extract


def total_capacity(cfg: ExtractorConfig) -> int:
    return sum(pyr_ops.features_per_level(cfg.n_features, cfg.n_levels,
                                          cfg.scale_factor))
