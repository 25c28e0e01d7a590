"""Tracking against the map and the keyframe mapping steps.

Port of `orb_slam3_ros2_tpu/frontend/tracking.py`. The tracking half
(search-by-projection, widened retry, robust pose LM, tight re-match,
second pose LM) runs per frame; the mapping half (triangulation, local-BA
window, local BA, SearchAndFuse, landmark culling) per keyframe. Features
enter with packed int32 descriptors (`Features.bits`), which is what the
matching kernel reads.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod
from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused
from orb_slam3_ros2_tpu_torch.geom import lie
from orb_slam3_ros2_tpu_torch.ops import fused_match, matcher
from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as desc_ops


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
    """The whole per-frame tracking step after extraction: match at 15 px
    and at 30 px, keep the 30 px match if the 15 px one has fewer than
    `min_matches` (the JAX `lax.cond`, selected on the device, so the step
    makes no host sync), pose LM, re-match at 7 px from the optimized pose,
    second pose LM, keep the better stage.

    Returns (tm, res, obs_clean, summary) with summary = [R(9), t(3),
    n_matches, n_inliers, n_kf, median inlier depth] as one (16,) tensor."""
    def matcher(R, t, radius):
        return match_to_map(m, feat_uv, feat_bits, feat_mask, R, t, fx, fy,
                            cx, cy, width, height, radius=radius,
                            cap_visible=cap_visible)

    tm = matcher(R_pred, t_pred, 15.0)
    wide = matcher(R_pred, t_pred, 30.0)
    retry = tm.n_matches < min_matches
    tm = TrackMatch(*(torch.where(retry, b, a) for a, b in zip(tm, wide)))
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


# ---------------------------------------------------------------- mapping half
#
# Port of `orb_slam3_ros2_tpu/frontend/tracking.py:270-651`. Keyframe ids
# may be 0-dim device tensors; rows are read with `ms.row`, so none of
# these functions makes a host sync.


def triangulate_between(
    m: ms.MapState,
    kf_a,  # () int — new keyframe id
    kf_b,  # () int — covisible keyframe id
    fx, fy, cx, cy,
    max_dist: float = 50.0,
    min_parallax_cos: float = 0.9998,
    reproj_th: float = 2.0,
    min_z: float = 0.05,
    max_z_factor: float = 40.0,
    scale_factor: float = 1.2,
    max_level_diff: int = 2,
    min_baseline_depth: float = 0.01,
):
    """Match unassociated features of kf_a against kf_b and triangulate.

    Returns (X (N,3) world, bits (N,8), accept (N,), feat_a ids, feat_b ids)
    sized by the feature capacity N of a keyframe.

    Beyond the epipolar gate, three alias gates of upstream
    LocalMapping::CreateNewMapPoints: candidate pairs within
    `max_level_diff` octaves; the triangulated point's camera-distance ratio
    consistent with the octave-implied scale ratio; and the whole pair
    refused when the baseline is under `min_baseline_depth` of kf_b's median
    scene depth. On self-similar texture, aliases that pass the epipolar
    gate triangulate to a consistent but wrong depth; these gates took the
    JAX package's hard seed-2 mono ATE from 0.26 to 0.017."""
    row = ms.row
    sa = desc_ops.signs_from_bits(row(m.kf_bits, kf_a))
    sb = desc_ops.signs_from_bits(row(m.kf_bits, kf_b))
    obs_a, obs_b = row(m.kf_obs_lm, kf_a), row(m.kf_obs_lm, kf_b)
    fv_a, fv_b = row(m.kf_feat_valid, kf_a), row(m.kf_feat_valid, kf_b)
    free_a = fv_a & (obs_a < 0)
    free_b = fv_b & (obs_b < 0)
    lvl_a, lvl_b = row(m.kf_level, kf_a), row(m.kf_level, kf_b)
    uva, uvb_all = row(m.kf_uv, kf_a), row(m.kf_uv, kf_b)

    # epipolar gate: distance of b-feature to the epipolar line of a-feature
    Ra, ta = row(m.kf_R, kf_a), row(m.kf_t, kf_a)
    Rb, tb = row(m.kf_R, kf_b), row(m.kf_t, kf_b)
    Rab, tab = lie.se3_compose(Rb, tb, *lie.se3_inverse(Ra, ta))
    E = lie.hat(tab) @ Rab
    Kinv = torch.tensor([[1.0 / fx, 0.0, -cx / fx], [0.0, 1.0 / fy, -cy / fy],
                         [0.0, 0.0, 1.0]], dtype=torch.float32,
                        device=uva.device)
    F = Kinv.T @ E @ Kinv
    ha = torch.cat([uva, torch.ones_like(uva[:, :1])], dim=-1)
    hb = torch.cat([uvb_all, torch.ones_like(uvb_all[:, :1])], dim=-1)
    lines_b = ha @ F.T  # (N, 3) epipolar lines in image b
    d = (lines_b @ hb.T).abs() / torch.sqrt(
        (lines_b[:, None, 0] ** 2 + lines_b[:, None, 1] ** 2).clamp(
            min=1e-12))  # (Na, Nb)
    lvl_close = (lvl_a[:, None] - lvl_b[None, :]).abs() <= max_level_diff
    gate = (d < 3.0) & lvl_close

    res = matcher.match(sa, free_a, sb, free_b, max_dist=max_dist, ratio=0.8,
                        gate=gate, mutual=True)
    idx_b = torch.where(res.valid, res.idx, 0).long()

    # DLT triangulation in the world frame
    uvb = uvb_all[idx_b]

    def ray(uv):
        return torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy,
                            torch.ones_like(uv[:, 0])], dim=-1)

    xa, xb = ray(uva), ray(uvb)
    Pa = torch.cat([Ra, ta[:, None]], dim=1)
    Pb = torch.cat([Rb, tb[:, None]], dim=1)

    def rows(P, x):
        r1 = x[:, 0:1, None] * P[None, 2:3] - P[None, 0:1]
        r2 = x[:, 1:2, None] * P[None, 2:3] - P[None, 1:2]
        return torch.cat([r1, r2], dim=1)

    A = torch.cat([rows(Pa, xa), rows(Pb, xb)], dim=1)  # (N, 4, 4)
    Xh = torch.linalg.svd(A).Vh[:, -1]
    w = Xh[:, 3:]
    X = Xh[:, :3] / torch.where(w.abs() < 1e-10, torch.full_like(w, 1e-10), w)

    # vetting
    xca = lie.se3_apply(Ra, ta, X)
    xcb = lie.se3_apply(Rb, tb, X)
    za, zb = xca[:, 2], xcb[:, 2]

    def reproj(xc, z, uv):
        zs = z.clamp(min=1e-8)
        return torch.stack([fx * xc[:, 0] / zs + cx,
                            fy * xc[:, 1] / zs + cy], dim=-1) - uv

    ea, eb = reproj(xca, za, uva), reproj(xcb, zb, uvb)
    ca = -Ra.T @ ta  # camera centres (world)
    cb = -Rb.T @ tb
    ra, rb = X - ca, X - cb
    dist_a = torch.linalg.norm(ra, dim=-1)
    dist_b = torch.linalg.norm(rb, dim=-1)
    cos_par = (ra * rb).sum(-1) / (dist_a * dist_b).clamp(min=1e-12)
    baseline = torch.linalg.norm(cb - ca)
    # octave scale consistency: dist_b/dist_a ≈ scale^(lvl_a - lvl_b)
    ratio_factor = 1.5 * scale_factor
    ratio_octave = scale_factor ** (lvl_a - lvl_b[idx_b]).to(torch.float32)
    ratio_dist = dist_b / dist_a.clamp(min=1e-12)
    scale_ok = ((ratio_dist < ratio_octave * ratio_factor)
                & (ratio_dist * ratio_factor > ratio_octave))
    # baseline / median-scene-depth gate on the pair
    z_obs = lie.se3_apply(Rb, tb, m.lm_X[obs_b.clamp(min=0).long()])[:, 2]
    ok_obs = (obs_b >= 0) & fv_b
    med_depth = torch.nanquantile(
        torch.where(ok_obs, z_obs, float("nan")), 0.5)
    med_depth = torch.where(torch.isnan(med_depth),
                            torch.zeros_like(med_depth), med_depth)
    baseline_ok = baseline > min_baseline_depth * med_depth
    accept = baseline_ok & (
        res.valid
        & (za > min_z) & (zb > min_z)
        & (za < baseline * max_z_factor) & (zb < baseline * max_z_factor)
        & (torch.linalg.norm(ea, dim=-1) < reproj_th)
        & (torch.linalg.norm(eb, dim=-1) < reproj_th)
        & (cos_par < min_parallax_cos)
        & scale_ok
    )
    N = uva.shape[0]
    return (X, row(m.kf_bits, kf_a), accept,
            torch.arange(N, dtype=torch.int32, device=X.device),
            idx_b.to(torch.int32))


def select_local_window(m: ms.MapState, new_kf, n_window: int,
                        n_fixed_ring: int):
    """Covisibility-driven local-BA window (upstream LocalBundleAdjustment:
    the anchor plus its top covisible keyframes optimize, the second ring
    of observers participates fixed).

    Returns (ids (n_window + n_fixed_ring,) int32, fixed (same,) bool).
    Unused slots pad with the anchor id (local_ba deactivates duplicates).
    Keyframe 0 is always fixed when selected; with no fixed ring at all, the
    window's lowest-id member is pinned. Ties in covisibility weight take
    the lowest keyframe id first, as `lax.top_k` does."""
    C = ms.covisibility_matrix(m).to(torch.float32)
    K = C.shape[0]
    dev = C.device
    ids_all = torch.arange(K, device=dev)
    new_kf = torch.as_tensor(new_kf, device=dev).reshape(()).long()

    w_new = torch.where(m.kf_valid & (ids_all != new_kf), ms.row(C, new_kf),
                        -1.0)
    top_w, top_ids = matcher.top_k_stable(w_new, n_window - 1)
    sel_ok = top_w > 0
    sel = torch.cat([new_kf[None], torch.where(sel_ok, top_ids, new_kf)])
    sel_active = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                            sel_ok])

    in_sel = torch.zeros((K,), dtype=torch.bool, device=dev)
    in_sel[sel] = True  # every write is True
    ring_w = (C[sel] * sel_active[:, None]).sum(0)
    ring_w = torch.where(in_sel | ~m.kf_valid, -1.0, ring_w)
    ring_top_w, ring_ids = matcher.top_k_stable(ring_w, n_fixed_ring)
    ring_ok = ring_top_w > 0
    ring = torch.where(ring_ok, ring_ids, new_kf)

    ids = torch.cat([sel, ring])
    fixed = torch.cat([torch.zeros((n_window,), dtype=torch.bool, device=dev),
                       torch.ones((n_fixed_ring,), dtype=torch.bool,
                                  device=dev)])
    fixed = fixed | (ids == 0)
    no_ring = ~ring_ok.any()
    oldest = matcher.first_argmin(torch.where(sel_active, sel, K), 0)
    fixed = fixed | ((torch.arange(ids.shape[0], device=dev) == oldest)
                     & no_ring)
    return ids.to(torch.int32), fixed


def best_covisible(m: ms.MapState, kf_id, exclude: torch.Tensor):
    """Most covisible valid keyframe with `kf_id`, excluding the ids in
    `exclude`; kf_id - 1 when nothing shares landmarks. Returns a 0-dim
    int32 tensor (no host sync)."""
    C = ms.covisibility_matrix(m)
    K = C.shape[0]
    dev = C.device
    kf_id = torch.as_tensor(kf_id, device=dev).reshape(()).long()
    ids_all = torch.arange(K, device=dev)
    w = torch.where(m.kf_valid & (ids_all != kf_id), ms.row(C, kf_id), -1)
    excl = (ids_all[:, None] == exclude.to(dev)[None, :]).any(-1)
    w = torch.where(excl, -1, w)
    mx = w.max()
    best = torch.where(w == mx, ids_all, K).min()  # first maximum
    return torch.where(mx > 0, best, (kf_id - 1).clamp(min=0)).to(torch.int32)


def local_ba(m: ms.MapState, window_ids: torch.Tensor,
             fix_ids_mask: torch.Tensor, fx, fy, cx, cy,
             n_iters: int = 8) -> ms.MapState:
    """Windowed BA over the dense observation table; writes results back.

    Duplicate window ids (short-map padding) are deactivated past their
    first occurrence, so the pose write-back has one writer per keyframe."""
    W = window_ids.shape[0]
    dev = window_ids.device
    same = window_ids[None, :] == window_ids[:, None]
    earlier = torch.ones((W, W), dtype=torch.bool, device=dev).tril(-1)
    first_occurrence = ~(same & earlier).any(dim=1)
    uv_t, w_t, kf_ok = ms.observation_table(m, window_ids)
    active = kf_ok & first_occurrence
    ids = window_ids.long()
    p = ba_mod.BAProblem(
        R=m.kf_R[ids], t=m.kf_t[ids], X=m.lm_X, uv=uv_t,
        w=w_t * active[:, None], fixed=fix_ids_mask | ~active,
        point_valid=m.lm_valid)
    out = ba_mod.bundle_adjust(p, fx, fy, cx, cy, n_iters=n_iters)
    K = m.kf_R.shape[0]
    write_ids = torch.where(active, ids, K)
    kf_R = ms._scatter_drop(m.kf_R, write_ids, out.R)
    kf_t = ms._scatter_drop(m.kf_t, write_ids, out.t)
    # landmarks: only those observed by the window moved
    moved = (w_t * active[:, None]).sum(0) > 0
    lm_X = torch.where(moved[:, None], out.X, m.lm_X)
    return m._replace(kf_R=kf_R, kf_t=kf_t, lm_X=lm_X)


def fuse_map_points(
    m: ms.MapState,
    kf_id,  # () int — keyframe to fuse into (usually the newest)
    fx, fy, cx, cy, width, height,
    radius: float = 4.0,
    max_dist: float = 45.0,
    merge_max_dist: float = 30.0,
    merge_rel_3d: float = 0.02,
):
    """SearchAndFuse: project the map into keyframe `kf_id`, match features
    by descriptor in a tight window (the match kernel's third call site),
    then (a) adopt landmarks for unassociated features and (b) merge
    duplicate landmarks where a feature's association disagrees with the
    projection match, keeping the landmark with more observations (upstream
    ORBmatcher::Fuse + MapPoint::Replace).

    Returns (m2, n_adopted, n_merged)."""
    row = ms.row
    R, t = row(m.kf_R, kf_id), row(m.kf_t, kf_id)
    lm_uv, lm_vis = project_map(m, R, t, fx, fy, cx, cy, width, height)
    # no ratio test and no mutual check: a feature must be able to match a
    # landmark that duplicates its current association — that tie is the
    # merge signal (upstream Fuse uses plain TH_LOW)
    res = fused_match.match_window(
        row(m.kf_bits, kf_id), row(m.kf_feat_valid, kf_id),
        row(m.kf_uv, kf_id), m.lm_bits, lm_vis, lm_uv, radius=radius,
        max_dist=max_dist, ratio=None, mutual=False)
    lm_match = res.idx
    cur = row(m.kf_obs_lm, kf_id)
    L = m.lm_valid.shape[0]

    # (a) adopt — never a landmark this keyframe already observes through
    # another feature (upstream Fuse skips MapPoints IsInKeyFrame)
    match_safe = lm_match.clamp(0, L - 1).long()
    already = ms._scatter_drop(torch.zeros_like(m.lm_valid),
                               torch.where(cur >= 0, cur, L), True)
    adopt = (lm_match >= 0) & (cur < 0) & ~already[match_safe]
    row_obs = torch.where(adopt, lm_match, cur)

    # (b) merge: stricter guards than adoption — near-identical descriptors
    # and 3-D proximity relative to scene depth
    conflict = (lm_match >= 0) & (cur >= 0) & (lm_match != cur)
    conflict = conflict & (res.dist <= merge_max_dist)
    cur_safe = cur.clamp(0, L - 1).long()
    d3 = torch.linalg.norm(m.lm_X[cur_safe] - m.lm_X[match_safe], dim=-1)
    depth = (m.lm_X[cur_safe] @ R.T + t)[:, 2]
    conflict = conflict & (d3 <= merge_rel_3d * depth.clamp(min=1e-3))
    a = torch.where(conflict, lm_match, 0).long()
    b = torch.where(conflict, cur, 0).long()
    keep_a = m.lm_n_obs[a] >= m.lm_n_obs[b]
    keep_lm = torch.where(keep_a, a, b)
    drop_lm = torch.where(keep_a, b, a)
    # one-step remap old -> merged. Two conflicts can drop the same landmark
    # towards different survivors: the last feature's write wins, as in
    # XLA's CPU scatter. Chains collapse conservatively: associations that
    # land on a dropped landmark are nulled below.
    drop_w = torch.where(conflict, drop_lm, L)
    remap = ms.scatter_last(torch.arange(L, dtype=torch.int32, device=a.device),
                            drop_w, torch.where(conflict, keep_lm, 0))
    lm_valid = ms._scatter_drop(m.lm_valid, drop_w, False)

    obs_all = ms.put_row(m.kf_obs_lm, kf_id, row_obs)
    obs_safe = obs_all.clamp(0, L - 1).long()
    obs_r = torch.where(obs_all >= 0, remap[obs_safe], -1)
    # null dangling associations (a target that was itself merged away)
    obs_r = torch.where(
        (obs_r >= 0) & lm_valid[obs_r.clamp(0, L - 1).long()], obs_r, -1)
    m2 = ms.dedupe_observations(m._replace(kf_obs_lm=obs_r,
                                           lm_valid=lm_valid))
    return (m2, adopt.sum().to(torch.int32),
            conflict.sum().to(torch.int32))


def global_ba_window(n_kf: int, max_kf: int, device):
    """The keyframe window of a global BA: (ids (B,) int32, fix (B,) bool)
    over the n_kf live keyframes padded to the next power of 2 (at least
    2, at most max_kf; the pad ids repeat the last keyframe and local_ba
    deactivates them), keyframe 0 fixed as the gauge anchor. The solve
    follows the map, not its capacity."""
    B = min(max(1 << (n_kf - 1).bit_length(), 2), max_kf)
    ar = torch.arange(B, device=device)
    return torch.clamp(ar, max=n_kf - 1).to(torch.int32), ar == 0


def global_ba(m: ms.MapState, n_kf: int, fx, fy, cx, cy,
              n_iters: int = 10) -> ms.MapState:
    """Bundle adjustment over the n_kf live keyframes (the reference's
    GlobalBundleAdjustment after a loop correction; the JAX version runs
    every keyframe slot, which the pad makes the same solve), keyframe 0
    fixed."""
    ids, fix = global_ba_window(n_kf, m.kf_valid.shape[0],
                                m.kf_valid.device)
    return local_ba(m, ids, fix, fx, fy, cx, cy, n_iters=n_iters)


def cull_landmarks(m: ms.MapState, min_found_ratio: float = 0.25,
                   min_obs: int = 2, grace_obs: int = 3) -> ms.MapState:
    """Invalidate weak landmarks (upstream MapPointCulling): found/visible
    ratio below threshold, or too few keyframe observations, once past the
    creation grace period."""
    ratio = m.lm_found.to(torch.float32) / m.lm_visible.to(
        torch.float32).clamp(min=1.0)
    past_grace = m.lm_visible > grace_obs
    bad = ((ratio < min_found_ratio) | (m.lm_n_obs < min_obs)) & past_grace
    return m._replace(lm_valid=m.lm_valid & ~bad)
