"""Cross-map place recognition and map merging.

Port of `orb_slam3_ros2_tpu/atlas/merging.py`. A BoW hit in a non-active
Atlas map is verified by a Sim(3) between the two worlds from 3D-3D
landmark pairs (`detect_cross_map`), refined by a robust PnP of the old
keyframe on the duplicate landmarks (`refine_weld_pnp`: reprojection is
pixel-accurate where mono triangulation depth is not), and the old map is
transported into the active world and welded in (`merge_maps`), aliasing
the verified duplicates so the merged map carries cross-map observations.
Merging is a rare host-side event: it runs in numpy over the map's arrays
and returns a `MapState` on the active map's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused
from orb_slam3_ros2_tpu_torch.loop import closing
from orb_slam3_ros2_tpu_torch.loop import sim3 as sim3_mod


class MergeCandidate(NamedTuple):
    ok: bool
    old_kf: int
    # Sim3 active <- old: x_active = s R x_old + t
    R: np.ndarray
    t: np.ndarray
    s: float
    n_inliers: int
    # Sim3-inlier duplicate landmarks: rows (active_lm_id, old_lm_id)
    lm_pairs: np.ndarray = np.zeros((0, 2), np.int32)


def cross_map_pairs(active: ms.MapState, new_kf: int, old: ms.MapState,
                    old_kf: int):
    """Matched landmark pairs between keyframe `new_kf` of `active` and
    `old_kf` of `old`: (pa (N, 3), pb (N, 3), pair_ids (N, 2), mask (N,))."""
    idx = closing.match_features(
        active.kf_bits[new_kf],
        active.kf_feat_valid[new_kf] & (active.kf_obs_lm[new_kf] >= 0),
        old.kf_bits[old_kf],
        old.kf_feat_valid[old_kf] & (old.kf_obs_lm[old_kf] >= 0),
    ).cpu().numpy()
    obs_a = active.kf_obs_lm[new_kf].cpu().numpy()
    obs_b = old.kf_obs_lm[old_kf].cpu().numpy()
    Xa, Xb = active.lm_X.cpu().numpy(), old.lm_X.cpu().numpy()
    va, vb = active.lm_valid.cpu().numpy(), old.lm_valid.cpu().numpy()
    N = idx.shape[0]
    j = np.where(idx >= 0, idx, 0)
    la, lb = obs_a, obs_b[j]
    mask = ((idx >= 0) & (la >= 0) & (lb >= 0)
            & va[np.maximum(la, 0)] & vb[np.maximum(lb, 0)])
    pa = np.where(mask[:, None], Xa[np.maximum(la, 0)], 0.0).astype(
        np.float32)
    pb = np.where(mask[:, None], Xb[np.maximum(lb, 0)], 0.0).astype(
        np.float32)
    pair_ids = np.where(mask[:, None], np.stack([la, lb], axis=-1),
                        -1).astype(np.int32).reshape(N, 2)
    return pa, pb, pair_ids, mask


def verify_cross_from_samples(pa, pb, pair_ids, mask, idx, old_kf: int,
                              fix_scale: bool, min_inliers: int, device):
    """The Sim3 check of `detect_cross_map` on given RANSAC samples."""
    def t(a):
        return torch.as_tensor(a, device=device)

    # x_active = s R x_old + t: solve_sim3 maps its second set onto its
    # first
    res = sim3_mod.solve_sim3_from_samples(
        t(idx), t(pa), t(pb), t(mask), fix_scale=fix_scale,
        min_inliers=min_inliers)
    if not bool(res.ok):
        return None
    inl = res.inliers.cpu().numpy() & mask
    return MergeCandidate(ok=True, old_kf=old_kf, R=res.R.cpu().numpy(),
                          t=res.t.cpu().numpy(), s=float(res.s),
                          n_inliers=int(res.n_inliers),
                          lm_pairs=pair_ids[inl])


def detect_cross_map(active: ms.MapState, new_kf: int, old: ms.MapState,
                     old_kf: int, gen: torch.Generator,
                     fix_scale: bool = False,
                     min_inliers: int = 20) -> Optional[MergeCandidate]:
    """Verify a cross-map BoW hit by a 3D-3D Sim3 between the two worlds,
    its RANSAC samples drawn from `gen`."""
    pa, pb, pair_ids, mask = cross_map_pairs(active, new_kf, old, old_kf)
    if mask.sum() < min_inliers:
        return None
    idx = sim3_mod.sample_triples(gen, torch.as_tensor(mask,
                                                       device=gen.device))
    return verify_cross_from_samples(pa, pb, pair_ids, mask, idx, old_kf,
                                     fix_scale, min_inliers,
                                     active.lm_X.device)


def merge_maps(active: ms.MapState, old: ms.MapState, R_ao: np.ndarray,
               t_ao: np.ndarray, s_ao: float, cfg: ms.MapConfig,
               lm_alias: Optional[np.ndarray] = None
               ) -> Tuple[ms.MapState, np.ndarray, int]:
    """Weld `old`, transformed by the Sim3 active <- old, into `active`:
    R_cw' = R_cw_o Rᵀ, t_cw' = s·t_cw_o − R_cw' t for its keyframes, X' =
    s R X + t for its landmarks. The most recent old keyframes fill the
    free keyframe slots; the most observed old landmarks the free landmark
    slots. `lm_alias` ((L,) int32, -1 none) marks old landmarks that
    duplicate an active one: they are not copied, and the old map's
    observations of them point at the active landmark. Returns (merged
    map, kept old keyframe ids in order, the slot of the first one)."""
    # writable copies (on the CPU, to_numpy shares the tensors' memory)
    A = {k: np.array(v) for k, v in ms.to_numpy(active).items()}
    O = ms.to_numpy(old)
    n_kf_a, n_kf_o = int(A["n_kf"]), int(O["n_kf"])
    K, L = cfg.max_kf, cfg.max_lm
    take_kf = min(n_kf_o, K - n_kf_a)
    kept_kf = np.arange(n_kf_o - take_kf, n_kf_o)

    lm_valid_o = O["lm_valid"].copy()
    if lm_alias is None:
        lm_alias = np.full(L, -1, np.int32)
    lm_valid_o[lm_alias >= 0] = False
    lm_ids_o = np.where(lm_valid_o)[0]
    room_lm = L - int(A["lm_valid"].sum())
    if len(lm_ids_o) > room_lm:
        order = np.argsort(-O["lm_n_obs"][lm_ids_o])
        lm_ids_o = lm_ids_o[order[:room_lm]]
    free_slots = np.where(~A["lm_valid"])[0][: len(lm_ids_o)]
    lm_remap = np.where(lm_alias >= 0, lm_alias, np.full(L, -1, np.int32))
    lm_remap[lm_ids_o] = free_slots
    dup = lm_alias >= 0
    for f in ("lm_n_obs", "lm_found", "lm_visible"):
        np.add.at(A[f], lm_alias[dup], O[f][dup])

    R_ao = np.asarray(R_ao, np.float32)
    t_ao = np.asarray(t_ao, np.float32)
    s = float(s_ao)
    X_t = s * O["lm_X"] @ R_ao.T + t_ao
    R_cw_t = O["kf_R"] @ R_ao.T[None]
    t_cw_t = s * O["kf_t"] - np.einsum("kij,j->ki", R_cw_t, t_ao)

    kn = n_kf_a + np.arange(take_kf)
    A["kf_R"][kn] = R_cw_t[kept_kf]
    A["kf_t"][kn] = t_cw_t[kept_kf]
    A["kf_valid"][kn] = True
    for f in ("kf_time", "kf_uv", "kf_level", "kf_bits", "kf_feat_valid"):
        A[f][kn] = O[f][kept_kf]
    obs = O["kf_obs_lm"][kept_kf]
    A["kf_obs_lm"][kn] = np.where(obs >= 0,
                                  lm_remap[np.clip(obs, 0, L - 1)], -1)

    kf_off = n_kf_a - (n_kf_o - take_kf)  # new id = old id + kf_off
    A["lm_X"][free_slots] = X_t[lm_ids_o]
    A["lm_valid"][free_slots] = True
    A["lm_bits"][free_slots] = O["lm_bits"][lm_ids_o]
    A["lm_ref_kf"][free_slots] = np.clip(
        O["lm_ref_kf"][lm_ids_o].astype(np.int64) + kf_off, 0, K - 1)
    for f in ("lm_n_obs", "lm_found", "lm_visible"):
        A[f][free_slots] = O[f][lm_ids_o]
    A["n_kf"] = np.asarray(n_kf_a + take_kf, np.int32)
    A["n_lm"] = np.asarray(max(int(A["n_lm"]), int(free_slots.max()) + 1
                               if len(free_slots) else 0), np.int32)
    merged = ms.from_numpy(A, active.lm_X.device)
    # observation counts from the surviving association table
    return ms.recount_observations(merged), kept_kf, n_kf_a


def refine_weld_pnp(active: ms.MapState, old: ms.MapState,
                    cand: MergeCandidate, fx: float, fy: float, cx: float,
                    cy: float) -> MergeCandidate:
    """Refine a 3D-3D Sim3 weld by a robust PnP of the old keyframe on the
    duplicate landmarks (active 3-D position <- old 2-D feature): first
    ungated (Huber only; the seed can start tens of px off), then with the
    normal gate. The rotation and translation are backed out of the
    refined pose, the scale re-estimated as the median depth ratio of the
    inlier pairs, and only the PnP inliers stay as landmark aliases."""
    if cand.lm_pairs.shape[0] < 12:
        return cand
    old_kf = cand.old_kf
    obs = old.kf_obs_lm[old_kf].cpu().numpy()
    uv_kf = old.kf_uv[old_kf].cpu().numpy()
    lookup = {int(lb): int(la) for la, lb in cand.lm_pairs}
    N = obs.shape[0]
    X = np.zeros((N, 3), np.float32)
    uv = np.zeros((N, 2), np.float32)
    mask = np.zeros((N,), bool)
    Xa = active.lm_X.cpu().numpy()
    for j in range(N):
        la = lookup.get(int(obs[j]))
        if la is not None:
            X[j], uv[j], mask[j] = Xa[la], uv_kf[j], True
    if mask.sum() < 12:
        return cand
    R_o = old.kf_R[old_kf].cpu().numpy()
    t_o = old.kf_t[old_kf].cpu().numpy()
    s = float(cand.s)
    R0 = R_o @ cand.R.T
    t0 = s * t_o - R0 @ cand.t
    dev = active.lm_X.device

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    Xt, uvt, ones = t(X), t(uv), t(np.ones((N,)))
    maskt = torch.as_tensor(mask, device=dev)
    res1 = pose_opt_fused.optimize_pose_fused(
        t(R0), t(t0), Xt, uvt, ones, maskt, fx, fy, cx, cy, n_rounds=2,
        iters_per_round=8, chi2_th=1e9)
    res2 = pose_opt_fused.optimize_pose_fused(
        res1.R, res1.t, Xt, uvt, ones, maskt, fx, fy, cx, cy, n_rounds=3,
        iters_per_round=5)
    if int(res2.n_inliers) < 12:
        return cand
    R_a = res2.R.cpu().numpy()
    t_a = res2.t.cpu().numpy()
    inl = res2.inliers.cpu().numpy() & mask
    if inl.sum() >= 12:
        Xo = old.lm_X.cpu().numpy()
        z_a = X[inl] @ R_a.T[:, 2] + t_a[2]
        z_o = Xo[obs[inl]] @ R_o.T[:, 2] + t_o[2]
        ok = (z_o > 0.1) & (z_a > 0.1)
        if ok.sum() >= 12:
            s = float(np.median(z_a[ok] / z_o[ok]))
    R_new = R_a.T @ R_o
    t_new = R_a.T @ (s * t_o - t_a)
    kept_lb = {int(obs[j]) for j in np.where(inl)[0]}
    pairs = np.asarray([(la, lb) for la, lb in cand.lm_pairs
                        if int(lb) in kept_lb], np.int32).reshape(-1, 2)
    return cand._replace(R=R_new, t=t_new, s=s,
                         n_inliers=int(res2.n_inliers), lm_pairs=pairs)
