"""Distributed multi-process SLAM session: per-process tracking + Atlas
exchange + global-mesh refinement.

Port of `orb_slam3_ros2_tpu/parallel/distributed_session.py`. Protocol,
one OS process per host, in a `torch.distributed` group:

1. **Per-host feeder + tracking**: each process tracks its own camera
   segment (a deterministic slice of a rendered trajectory, with an
   overlap seam) with the full `System` on its device.
2. **Atlas exchange**: the fixed-capacity `MapState` is all-gathered, one
   `all_gather` per map array (`parallel/mesh.process_allgather`): fixed
   shapes, no serialization protocol.
3. **Deterministic cross-map weld**: every process folds the gathered maps
   identically: per-keyframe descriptor signatures score all (kf_a, kf_b)
   pairs in one matmul, the best pairs are verified with the 3D-3D Sim3
   (`atlas/merging.detect_cross_map`), refined by PnP and welded into the
   process-0 map (`atlas/merging.merge_maps`).
4. **Global distributed GBA**: the welded map is refined by the
   landmark-sharded Schur solver over the GLOBAL shard mesh of every
   process (`parallel/distributed_map.distributed_map_ba`).

Run one process per host:

    python -m orb_slam3_ros2_tpu_torch.parallel.distributed_session \\
        --process-id 0 --num-processes 2 --coordinator 127.0.0.1:9902 \\
        --out report.json

(`--device cpu --local-devices 4` on the CPU; `--coordinator` may be a
file:// path; the backend defaults as in `parallel/multiproc.py`.)
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


# --------------------------------------------------------------------------
# map signatures + deterministic weld (step 3)
# --------------------------------------------------------------------------

def kf_signatures(m) -> np.ndarray:
    """(K, 256) L2-normalized mean descriptor sign per keyframe: a cheap
    global-image signature in the spirit of a BoW vector, which needs no
    shared vocabulary across hosts."""
    from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as desc_ops

    K, N = m.kf_bits.shape[:2]
    signs = desc_ops.signs_from_bits(m.kf_bits.reshape(K * N, 8)).reshape(
        K, N, 256).cpu().numpy()
    valid = (m.kf_feat_valid & (m.kf_obs_lm >= 0)).cpu().numpy()  # (K, N)
    cnt = np.maximum(valid.sum(-1, keepdims=True), 1)
    sig = (signs * valid[:, :, None]).sum(1) / cnt
    nrm = np.linalg.norm(sig, axis=-1, keepdims=True)
    sig = sig / np.maximum(nrm, 1e-6)
    sig[~m.kf_valid.cpu().numpy()] = 0.0
    return sig.astype(np.float32)


def weld_peer(active, peer, cfg, seed: int, top_pairs: int = 5,
              min_inliers: int = 20, intrinsics=None):
    """Fold `peer` into `active`: signature-scored candidate pairs ->
    Sim3 verification (its RANSAC draw seeded with seed + 131 ka + kp) ->
    PnP refinement when `intrinsics` = (fx, fy, cx, cy) -> merge.
    Returns (merged_or_active, welded: bool)."""
    from orb_slam3_ros2_tpu_torch.atlas import merging as merging_mod

    sig_a = kf_signatures(active)
    sig_p = kf_signatures(peer)
    score = sig_a @ sig_p.T  # (Ka, Kp)
    n_kf_a = int(active.n_kf)
    n_kf_p = int(peer.n_kf)
    score[n_kf_a:, :] = -1.0
    score[:, n_kf_p:] = -1.0
    flat = np.argsort(-score, axis=None)[:top_pairs]
    dev = active.lm_X.device
    for f in flat:
        ka, kp = int(f // score.shape[1]), int(f % score.shape[1])
        if score[ka, kp] <= 0:
            break
        gen = torch.Generator(device=dev).manual_seed(seed + ka * 131 + kp)
        cand = merging_mod.detect_cross_map(
            active, ka, peer, kp, gen, fix_scale=False,
            min_inliers=min_inliers)
        if cand is None:
            continue
        if intrinsics is not None:
            fx, fy, cx, cy = intrinsics
            cand = merging_mod.refine_weld_pnp(active, peer, cand,
                                               fx, fy, cx, cy)
        # duplicate landmarks (Sim3-inlier pairs) alias onto the active
        # map's ids: the weld's rigidity then comes from cross-map
        # observations in the global BA, not from the raw 3D-3D Sim3
        alias = np.full(peer.lm_X.shape[0], -1, np.int32)
        if cand.lm_pairs.size:
            alias[cand.lm_pairs[:, 1]] = cand.lm_pairs[:, 0]
        merged, _, _ = merging_mod.merge_maps(
            active, peer, cand.R, cand.t, cand.s, cfg, lm_alias=alias)
        return merged, True
    return active, False


def merge_gathered(maps, cfg, seed: int = 0, intrinsics=None,
                   unwelded: list | None = None):
    """Deterministically weld maps[1:] into maps[0]; every process runs it
    on identical gathered data. Returns (merged, n_welded). A peer whose
    weld fails verification is appended to `unwelded` as (process index,
    map), and a warning is printed."""
    merged = maps[0]
    n = 0
    for p, peer in enumerate(maps[1:], start=1):
        merged, ok = weld_peer(merged, peer, cfg, seed=seed + 1000 * p,
                               intrinsics=intrinsics)
        if ok:
            n += 1
        else:
            print(f"[distributed_session] WARNING: peer map from process "
                  f"{p} failed Sim3 weld verification; retained as a "
                  f"separate (unmerged) map", flush=True)
            if unwelded is not None:
                unwelded.append((p, peer))
    return merged, n


def kernel_launches() -> dict:
    """This process's launches of the three kernels of the tracking path
    (each wrapper's counter)."""
    from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused
    from orb_slam3_ros2_tpu_torch.ops import frontend_packed, fused_match

    return dict(frontend_packed=frontend_packed.frontend_pass_packed.launches,
                fused_match=fused_match.match_window.launches,
                pose_opt_fused=pose_opt_fused.optimize_pose_fused.launches)


def gather_maps(m, device) -> list:
    """Every process's MapState (step 2), on `device`, in rank order."""
    from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
    from orb_slam3_ros2_tpu_torch.parallel import mesh as mesh_mod

    g = mesh_mod.process_allgather(ms.to_numpy(m))
    n = next(iter(g.values())).shape[0]
    return [ms.from_numpy({k: v[p] for k, v in g.items()}, device)
            for p in range(n)]


# --------------------------------------------------------------------------
# the worker (steps 1-4)
# --------------------------------------------------------------------------

def run_worker(process_id: int, num_processes: int, coordinator: str,
               local_devices: int, out_path: str, n_frames: int = 44,
               overlap: int = 10, ba_iters: int = 8, device=None,
               backend=None) -> dict:
    import torch.distributed as dist

    from orb_slam3_ros2_tpu_torch.parallel import multiproc

    device = torch.device("cuda" if device is None else device)
    backend = multiproc.join_group(process_id, num_processes, coordinator,
                                   device, backend)
    try:
        return _session(process_id, num_processes, local_devices, out_path,
                        n_frames, overlap, ba_iters, device, backend)
    finally:
        dist.destroy_process_group()


def _session(process_id, num_processes, local_devices, out_path, n_frames,
             overlap, ba_iters, device, backend) -> dict:
    from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
    from orb_slam3_ros2_tpu_torch.frontend import tracking as trk
    from orb_slam3_ros2_tpu_torch.io import synthetic
    from orb_slam3_ros2_tpu_torch.parallel import distributed_map
    from orb_slam3_ros2_tpu_torch.parallel import mesh as mesh_mod
    from orb_slam3_ros2_tpu_torch.parallel import multiproc
    from orb_slam3_ros2_tpu_torch.runtime.system import Sensor, System

    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    settings = os.path.join(repo, "tests", "data", "synth_cam.yaml")
    cfg = ms.MapConfig(max_kf=32, max_lm=2048, n_feat=600)

    # ---- 1. per-host feeder: deterministic shared scene, disjoint slices
    # with an overlap seam (the revisited place where the weld happens)
    images, R_gt, t_gt, ts = synthetic.render_sequence(
        n_frames=n_frames, width=320, height=240, fx=260.0, fy=260.0,
        fps=10.0, seed=1, plane_depths=(6.0, 9.0), traj_scale=1.6,
    )
    half = n_frames // 2
    lo = 0 if process_id == 0 else half - overlap
    hi = half if process_id == 0 else n_frames
    sys_ = System(None, settings, Sensor.MONOCULAR, map_cfg=cfg,
                  device=device)
    t_track0 = time.perf_counter()
    for k in range(lo, hi):
        sys_.track_monocular(images[k], float(ts[k]))
    track_wall = time.perf_counter() - t_track0
    n_kf_local = int(sys_.map.n_kf)

    # ---- 2. Atlas exchange: one all_gather per map array ----
    maps = gather_maps(sys_.map, device)

    # ---- 3. deterministic weld (identical on every process) ----
    cam = sys_.cam
    unwelded: list = []
    merged, n_welded = merge_gathered(
        maps, cfg, seed=7, intrinsics=(cam.fx, cam.fy, cam.cx, cam.cy),
        unwelded=unwelded)

    # ---- 4. global distributed GBA over every process's shards ----
    mesh = mesh_mod.make_mesh(
        devices=multiproc.shard_devices(device, local_devices))
    ids, fix = trk.global_ba_window(int(merged.n_kf), cfg.max_kf, device)
    t_gba0 = time.perf_counter()
    refined = distributed_map.distributed_map_ba(
        merged, ids, fix, mesh, cam.fx, cam.fy, cam.cx, cam.cy,
        n_iters=ba_iters)
    multiproc._sync(device)
    gba_wall = time.perf_counter() - t_gba0

    # ---- report: keyframe ATE of the welded+refined map vs groundtruth
    kf_ate = _kf_ate(refined, ts, R_gt, t_gt)
    kf_ate_merged = _kf_ate(merged, ts, R_gt, t_gt)
    report = {
        "process_id": process_id,
        "processes": num_processes,
        "global_devices": mesh.size,
        "backend": backend,
        "device": str(device),
        "n_kf_local": n_kf_local,
        "n_kf_merged": int(merged.n_kf),
        "n_maps_welded": n_welded + 1,
        "unwelded_processes": [p for p, _ in unwelded],
        "kf_ate_merged_m": round(kf_ate_merged, 4),
        "kf_ate_refined_m": round(kf_ate, 4),
        "track_wall_s": round(track_wall, 2),
        "gba_wall_s": round(gba_wall, 2),
        "track_fps": round((hi - lo) / track_wall, 2),
        "track_ms_per_frame": round(1e3 * track_wall / (hi - lo), 3),
        "launches": kernel_launches(),
    }
    if process_id == 0:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return report


def _kf_ate(m, ts, R_gt, t_gt) -> float:
    """Sim3-aligned ATE of keyframe camera centers against the groundtruth
    poses at the matching timestamps (mono world scale is free)."""
    from orb_slam3_ros2_tpu_torch.io import synthetic

    n_kf = int(m.n_kf)
    kf_R = m.kf_R[:n_kf].cpu().numpy()
    kf_t = m.kf_t[:n_kf].cpu().numpy()
    kf_time = m.kf_time[:n_kf].cpu().numpy()
    idx = np.abs(ts[None, :] - kf_time[:, None]).argmin(1)
    est = -np.einsum("kji,kj->ki", kf_R, kf_t)
    gt = -np.einsum("kji,kj->ki", R_gt[idx], t_gt[idx])
    return float(synthetic.ate_rmse(est, gt))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", default="127.0.0.1:9902",
                    help="host:port, or a file:// path for a file store")
    ap.add_argument("--out", required=True)
    ap.add_argument("--local-devices", type=int, default=0)
    ap.add_argument("--n-frames", type=int, default=44)
    ap.add_argument("--ba-iters", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    run_worker(args.process_id, args.num_processes, args.coordinator,
               args.local_devices, args.out, n_frames=args.n_frames,
               ba_iters=args.ba_iters, device=args.device,
               backend=args.backend)


if __name__ == "__main__":
    main()
