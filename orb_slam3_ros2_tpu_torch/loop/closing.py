"""Loop closing: candidate verification, essential-graph correction and
landmark transport.

Port of `orb_slam3_ros2_tpu/loop/closing.py`. A BoW candidate is verified
by matching the two keyframes' landmark-bearing features (Hamming
distance, ratio 0.8, mutual) and a Sim(3) RANSAC on the implied 3-D
landmark pairs; an accepted loop builds the essential graph (the odometry
chain plus covisibility edges of weight >= 20, plus the loop edge) over the
live keyframes padded to a power of 2, optimizes it over Sim(3) and
transports every landmark through its reference keyframe's correction.
The odometry edges are measured on the pre-correction poses, so the drift
stays in them as relative constraints.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
from orb_slam3_ros2_tpu_torch.geom import lie
from orb_slam3_ros2_tpu_torch.loop import pose_graph as pg
from orb_slam3_ros2_tpu_torch.loop import sim3 as sim3_mod
from orb_slam3_ros2_tpu_torch.ops import matcher
from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as desc_ops


class LoopCandidate(NamedTuple):
    ok: bool
    cand_kf: int
    R: np.ndarray  # Sim3 correction: x_old ≈ s R x_new + t (world-to-world)
    t: np.ndarray
    s: float
    n_inliers: int


def match_features(bits_a, valid_a, bits_b, valid_b) -> torch.Tensor:
    """(N,) int32 feature match a -> b (-1 none): Hamming distance <= 50,
    ratio 0.8, mutual; the JAX `_match_kf_pair` / `merging._match_cross`."""
    res = matcher.match(desc_ops.signs_from_bits(bits_a), valid_a,
                        desc_ops.signs_from_bits(bits_b), valid_b,
                        max_dist=50.0, ratio=0.8, mutual=True)
    return res.idx


def matched_landmark_pairs(m: ms.MapState, kf_a: int, kf_b: int):
    """3D-3D landmark correspondences implied by a feature match between
    two keyframes: (pairs_a (N, 3), pairs_b (N, 3), mask (N,)), numpy."""
    va = m.kf_feat_valid[kf_a] & (m.kf_obs_lm[kf_a] >= 0)
    vb = m.kf_feat_valid[kf_b] & (m.kf_obs_lm[kf_b] >= 0)
    idx = match_features(m.kf_bits[kf_a], va, m.kf_bits[kf_b],
                         vb).cpu().numpy()
    obs_a = m.kf_obs_lm[kf_a].cpu().numpy()
    obs_b = m.kf_obs_lm[kf_b].cpu().numpy()
    lm_X = m.lm_X.cpu().numpy()
    lm_valid = m.lm_valid.cpu().numpy()
    valid = idx >= 0
    la = obs_a
    lb = obs_b[np.where(valid, idx, 0)]
    mask = (valid & (la >= 0) & (lb >= 0)
            & lm_valid[np.maximum(la, 0)] & lm_valid[np.maximum(lb, 0)])
    pairs_a = np.where(mask[:, None], lm_X[np.maximum(la, 0)], 0.0).astype(
        np.float32)
    pairs_b = np.where(mask[:, None], lm_X[np.maximum(lb, 0)], 0.0).astype(
        np.float32)
    return pairs_a, pairs_b, mask


def verify_from_samples(pairs_a, pairs_b, mask, idx, cand_kf: int,
                        fix_scale: bool, min_inliers: int, device):
    """The Sim3 check of `detect_and_verify` on given RANSAC samples."""
    def t(a):
        return torch.as_tensor(a, device=device)

    res = sim3_mod.solve_sim3_from_samples(
        t(idx), t(pairs_b), t(pairs_a), t(mask), fix_scale=fix_scale,
        min_inliers=min_inliers)
    if not bool(res.ok):
        return None
    return LoopCandidate(ok=True, cand_kf=cand_kf, R=res.R.cpu().numpy(),
                         t=res.t.cpu().numpy(), s=float(res.s),
                         n_inliers=int(res.n_inliers))


def detect_and_verify(m: ms.MapState, new_kf: int, cand_kf: int,
                      gen: torch.Generator, fix_scale: bool = False,
                      min_inliers: int = 20) -> Optional[LoopCandidate]:
    """Geometric verification of a BoW candidate by a 3D-3D Sim3 RANSAC
    whose samples come from `gen`."""
    pairs_a, pairs_b, mask = matched_landmark_pairs(m, new_kf, cand_kf)
    if mask.sum() < min_inliers:
        return None
    idx = sim3_mod.sample_triples(gen, torch.as_tensor(mask,
                                                       device=gen.device))
    return verify_from_samples(pairs_a, pairs_b, mask, idx, cand_kf,
                               fix_scale, min_inliers, m.lm_X.device)


def _rel_se3_batch(R_old, t_old, ei, ej):
    """Relative SE3 measurements S_ij = T_i ∘ T_j⁻¹ for every edge."""
    Ri, ti = R_old[ei], t_old[ei]
    Rj, tj = R_old[ej], t_old[ej]
    R_rel = torch.einsum("eab,ecb->eac", Ri, Rj)
    t_rel = ti - torch.einsum("eab,eb->ea", R_rel, tj)
    return R_rel, t_rel


def essential_graph_edges(covis: np.ndarray, n_kf: int, covis_th: int = 20,
                          max_covis_edges: Optional[int] = None):
    """Edge index lists of the essential graph, the loop edge not included:
    the odometry chain plus covisibility edges of weight >= covis_th
    (upper triangle, skipping consecutive pairs), heaviest first when
    capped (copied from the JAX module, numpy)."""
    odo_i = np.arange(1, n_kf, dtype=np.int32)
    odo_j = odo_i - 1
    C = covis[:n_kf, :n_kf]
    ii, jj = np.nonzero(np.triu(C, k=2) >= covis_th)
    if max_covis_edges is not None and ii.size > max_covis_edges:
        keep = np.argsort(-C[ii, jj], kind="stable")[:max_covis_edges]
        ii, jj = ii[keep], jj[keep]
    return (np.concatenate([odo_i, ii.astype(np.int32)]),
            np.concatenate([odo_j, jj.astype(np.int32)]))


def close_loop(m: ms.MapState, new_kf: int, cand: LoopCandidate,
               covis: Optional[np.ndarray] = None, fix_scale: bool = False,
               n_iters: int = 12, covis_th: int = 20) -> ms.MapState:
    """Pose-graph correction over the live keyframes (bucketed to a power of
    2) and landmark transport after an accepted loop."""
    dev = m.kf_R.device
    K = m.kf_R.shape[0]
    n_kf = int(m.n_kf)
    B = min(max(1 << max(n_kf - 1, 1).bit_length(), 2), K)
    R_old = m.kf_R
    t_old = m.kf_t
    if covis is None:
        covis = ms.covisibility_matrix(m).cpu().numpy()
    ei_np, ej_np = essential_graph_edges(covis, n_kf, covis_th=covis_th,
                                         max_covis_edges=B)
    E_cap = 2 * B + 8
    n_e = min(len(ei_np), E_cap - 1)
    ei = np.zeros((E_cap,), np.int32)
    ej = np.zeros((E_cap,), np.int32)
    ev = np.zeros((E_cap,), bool)
    ei[:n_e], ej[:n_e], ev[:n_e] = ei_np[:n_e], ej_np[:n_e], True
    # the loop edge: corrected pose of the new KF = S_new_old ∘ S_corr⁻¹
    one = torch.ones((), device=dev)
    S_corr_inv = lie.sim3_inverse(torch.as_tensor(cand.R, device=dev),
                                  torch.as_tensor(cand.t, device=dev),
                                  torch.as_tensor(cand.s, device=dev,
                                                  dtype=torch.float32))
    R_newc, t_newc, s_newc = lie.sim3_compose(R_old[new_kf], t_old[new_kf],
                                              one, *S_corr_inv)
    R_loop, t_loop, s_loop = lie.sim3_compose(
        R_newc, t_newc, s_newc,
        *lie.sim3_inverse(R_old[cand.cand_kf], t_old[cand.cand_kf], one))
    e = n_e
    ei[e], ej[e], ev[e] = new_kf, cand.cand_kf, True
    ei_t = torch.as_tensor(ei, device=dev).long()
    ej_t = torch.as_tensor(ej, device=dev).long()
    Rm, tm = _rel_se3_batch(R_old, t_old, ei_t, ej_t)
    Rm[e], tm[e] = R_loop, t_loop
    sm = torch.ones((E_cap,), device=dev)
    sm[e] = s_loop
    loop_w = np.ones((E_cap,), np.float32)
    loop_w[e] = float(max(n_kf - 1, 1))  # the loop edge outweighs one odo
    fixed = np.zeros((B,), bool)
    fixed[cand.cand_kf] = True
    fixed[0] = True
    fixed[n_kf:] = True  # unused slots held, so the solve stays posed
    ev_t = torch.as_tensor(ev, device=dev)
    out = pg.optimize_pose_graph(
        R_old[:B], t_old[:B], torch.ones((B,), device=dev), ei_t, ej_t, Rm,
        tm, sm, ev_t, torch.as_tensor(fixed, device=dev),
        edge_weight=torch.as_tensor(loop_w, device=dev) * ev_t,
        n_iters=n_iters, fix_scale=fix_scale)
    R_new, t_new = R_old.clone(), t_old.clone()
    s_new = torch.ones((K,), device=dev)
    R_new[:B], t_new[:B], s_new[:B] = out.R, out.t, out.s
    return _apply_correction(m, R_old, t_old, R_new, t_new, s_new)


def _apply_correction(m: ms.MapState, R_old, t_old, R_new, t_new, s_new):
    """Transport landmarks through their reference keyframe's correction and
    turn the corrected Sim3 poses back into SE(3) ([R | t/s])."""
    ref = m.lm_ref_kf.clamp(0, R_old.shape[0] - 1).long()
    x_r = lie.se3_apply(R_old[ref], t_old[ref], m.lm_X)
    Rn, tn, sn = lie.sim3_inverse(R_new[ref], t_new[ref], s_new[ref])
    X_corr = lie.sim3_apply(Rn, tn, sn, x_r)
    lm_X = torch.where(m.lm_valid[:, None], X_corr, m.lm_X)
    kf_t_se3 = t_new / s_new[:, None].clamp(min=1e-8)
    kf_R = torch.where(m.kf_valid[:, None, None], R_new, m.kf_R)
    kf_t = torch.where(m.kf_valid[:, None], kf_t_se3, m.kf_t)
    return m._replace(kf_R=kf_R, kf_t=kf_t, lm_X=lm_X)
