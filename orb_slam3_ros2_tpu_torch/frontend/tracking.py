"""Per-frame tracking against the map: search-by-projection, widened retry,
robust pose LM, tight re-match, second pose LM.

Port of `orb_slam3_ros2_tpu/frontend/tracking.py:39-267` (the tracking
half; the mapping half comes with the rest of the System). Features enter
with packed int32 descriptors (`Features.bits`), which is what the matching
kernel reads.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused
from orb_slam3_ros2_tpu_torch.geom import lie
from orb_slam3_ros2_tpu_torch.ops import fused_match


class TrackMatch(NamedTuple):
    obs_lm: torch.Tensor  # (N,) landmark id per feature, -1 = none
    n_matches: torch.Tensor  # () int32
    lm_visible_inc: torch.Tensor  # (L,) int32 — predicted-visible counter bump
    lm_found_inc: torch.Tensor  # (L,) int32 — matched counter bump


def project_map(m: ms.MapState, R, t, fx, fy, cx, cy, width, height):
    """Project all landmarks into pose (R, t). Returns (uv (L,2), vis (L,))."""
    x_c = lie.se3_apply(R, t, m.lm_X)
    z = x_c[:, 2]
    zs = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    uv = torch.stack([fx * x_c[:, 0] / zs + cx, fy * x_c[:, 1] / zs + cy],
                     dim=-1)
    vis = ((z > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < width)
           & (uv[:, 1] >= 0) & (uv[:, 1] < height) & m.lm_valid)
    return uv, vis


def gather_visible_landmarks(m: ms.MapState, lm_uv, lm_vis, cap: int):
    """Compact the frustum-visible landmarks into a fixed-capacity buffer:
    visible first, then ascending id (the keys are distinct integers, so
    `torch.topk` and `lax.top_k` agree).

    Returns (idx (cap,), sub_uv (cap, 2), sub_bits (cap, 8), sub_valid)."""
    L = lm_vis.shape[0]
    key = lm_vis.to(torch.float32) * 2.0 * L - torch.arange(
        L, dtype=torch.float32, device=lm_vis.device)
    idx = torch.topk(key, cap).indices
    return idx.to(torch.int32), lm_uv[idx], m.lm_bits[idx], lm_vis[idx]


def match_to_map(m: ms.MapState, feat_uv, feat_bits, feat_mask, R_pred,
                 t_pred, fx, fy, cx, cy, width, height, radius: float = 15.0,
                 max_dist: float = 50.0,
                 cap_visible: Optional[int] = None) -> TrackMatch:
    """Search-by-projection against the landmark array (all L landmarks,
    or the `cap_visible` frustum-visible ones when set and < L)."""
    lm_uv, lm_vis = project_map(m, R_pred, t_pred, fx, fy, cx, cy, width,
                                height)
    L = m.lm_valid.shape[0]
    if cap_visible is not None and cap_visible < L:
        idx, sub_uv, sub_bits, sub_valid = gather_visible_landmarks(
            m, lm_uv, lm_vis, cap_visible)
        res = fused_match.match_window(
            feat_bits, feat_mask, feat_uv, sub_bits, sub_valid, sub_uv,
            radius=radius, max_dist=max_dist, ratio=0.9, mutual=True)
        obs_lm = torch.where(res.idx >= 0,
                             idx[torch.clamp(res.idx, min=0).long()], -1)
    else:
        res = fused_match.match_window(
            feat_bits, feat_mask, feat_uv, m.lm_bits, lm_vis, lm_uv,
            radius=radius, max_dist=max_dist, ratio=0.9, mutual=True)
        obs_lm = res.idx
    # unmatched features add into the spare slot L, which is then dropped
    found_inc = torch.zeros((L + 1,), dtype=torch.int32,
                            device=feat_uv.device).index_add_(
        0, torch.where(obs_lm >= 0, obs_lm, L).long(),
        torch.ones_like(obs_lm))[:L]
    return TrackMatch(
        obs_lm=obs_lm,
        n_matches=torch.sum(obs_lm >= 0).to(torch.int32),
        lm_visible_inc=lm_vis.to(torch.int32),
        lm_found_inc=found_inc,
    )


def track_pose(m: ms.MapState, obs_lm, feat_uv, feat_level, R0, t0, fx, fy,
               cx, cy, scale_factor: float = 1.2):
    """Pose-only LM on current associations. Returns PoseOptResult and the
    association vector with chi²-outliers removed."""
    has = obs_lm >= 0
    X = m.lm_X[torch.where(has, obs_lm, 0).long()]
    inv_s2 = scale_factor ** (-2.0 * feat_level.to(torch.float32))
    res = pose_opt_fused.optimize_pose_fused(
        R0, t0, X, feat_uv, inv_s2, has, fx, fy, cx, cy)
    return res, torch.where(res.inliers, obs_lm, -1)


def track_frame(m: ms.MapState, feat_uv, feat_bits, feat_mask, feat_level,
                R_pred, t_pred, fx, fy, cx, cy, width, height,
                scale_factor: float = 1.2, min_matches: int = 20,
                min_stage1: int = 10, cap_visible: Optional[int] = None):
    """The whole per-frame tracking step after extraction: match at 15 px,
    retry at 30 px if fewer than `min_matches`, pose LM, re-match at 7 px
    from the optimized pose, second pose LM, keep the better stage.

    Returns (tm, res, obs_clean, summary) with summary = [R(9), t(3),
    n_matches, n_inliers, n_kf, median inlier depth] as one (16,) tensor."""
    def matcher(R, t, radius):
        return match_to_map(m, feat_uv, feat_bits, feat_mask, R, t, fx, fy,
                            cx, cy, width, height, radius=radius,
                            cap_visible=cap_visible)

    tm = matcher(R_pred, t_pred, 15.0)
    # The JAX version's lax.cond becomes a Python branch: one host sync per
    # frame on the match count.
    if int(tm.n_matches) < min_matches:
        tm = matcher(R_pred, t_pred, 30.0)
    res, obs_clean = track_pose(m, tm.obs_lm, feat_uv, feat_level, R_pred,
                                t_pred, fx, fy, cx, cy,
                                scale_factor=scale_factor)
    tm2 = matcher(res.R, res.t, 7.0)
    res2, obs2 = track_pose(m, tm2.obs_lm, feat_uv, feat_level, res.R, res.t,
                            fx, fy, cx, cy, scale_factor=scale_factor)
    # stage 2 is kept only if stage 1 cleared the low bar and stage 2 did
    # at least as well (upstream two-threshold Tracking semantics)
    accept = ((res.n_inliers >= min_stage1)
              & (tm2.n_matches >= res.n_inliers)
              & (res2.n_inliers >= res.n_inliers))

    def sel(a, b):
        return torch.where(accept, b, a)

    tm_f = TrackMatch(*(sel(a, b) for a, b in zip(tm, tm2)))
    res_f = type(res)(*(sel(a, b) for a, b in zip(res, res2)))
    obs_f = sel(obs_clean, obs2)
    has_f = obs_f >= 0
    Xo = m.lm_X[torch.where(has_f, obs_f, 0).long()]
    z = (Xo @ res_f.R.T + res_f.t)[:, 2]
    # nanquantile(0.5) averages the two middle values, as jnp.nanmedian
    # does (torch.nanmedian would return the lower one)
    z_med = torch.nanquantile(torch.where(has_f, z, float("nan")), 0.5)
    z_med = torch.where(torch.isfinite(z_med), z_med, 1e3)
    summary = torch.cat([
        res_f.R.reshape(-1), res_f.t,
        torch.stack([tm_f.n_matches.to(torch.float32),
                     res_f.n_inliers.to(torch.float32),
                     m.n_kf.to(torch.float32),
                     z_med.to(torch.float32)]),
    ])
    return tm_f, res_f, obs_f, summary
