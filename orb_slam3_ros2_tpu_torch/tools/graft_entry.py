"""The port's top-level entry points: the flagship per-frame step and the
multi-shard dry run.

    python -m orb_slam3_ros2_tpu_torch.tools.graft_entry [--dryrun N]
        [--device cuda|cpu]

Port of `__graft_entry__.py`:

- `entry(device)` returns the per-frame step (ORB extraction -> map
  matching -> robust pose LM) and its example tensors: a 240x320 texture
  (`_texture`, seed 0), 512 features over 4 levels, and a
  `MapConfig(max_kf=16, max_lm=1024)` map whose landmarks are that image's
  own features backprojected at depths in U(3, 8) from `default_rng(0)`,
  so the step makes a real match (hundreds of inliers) and pose solve at
  the identity. On the card one step launches `frontend_pass_packed`,
  `match_window` and `optimize_pose_fused` once each.
- `dryrun_multichip(n, devices)` runs the JAX function's checks in its
  order on an n-shard mesh: `System(mesh=...)`'s global BA lowers the pose
  error; one landmark-sharded BA step stays finite; the edge-sharded Sim3
  pose graph at least halves the pose error; the sharded VI BA lowers the
  pose error with the gyro-bias error under 5e-3; for n >= 2 the
  covisibility-partitioned block BA on the (kf, lm) mesh, whose cut
  fraction must be under 0.6x the contiguous one when the kf axis has 2
  or more shards. `devices` gives one entry per shard (the tests pass
  `["cpu"] * n`); by default the n shards are dealt over the visible
  cards in turn, so one card holds all of them.

The JAX module's `_devices_for` picks an XLA platform and forces virtual
CPU devices through `XLA_FLAGS`; a torch mesh takes its shards' devices as
they are given, so it has no counterpart here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.tools.cli import (REPO, add_device,
                                                check_device, device_of)

SETTINGS = os.path.join(REPO, "tests", "data", "synth_cam.yaml")

H, W = 240, 320
FX = FY = 260.0
CX, CY = W / 2.0, H / 2.0


def entry(device="cuda"):
    """(step, (img, m)): `step(img, m)` returns (R, t, n_inliers) as
    tensors on `device`."""
    from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
    from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
    from orb_slam3_ros2_tpu_torch.frontend import tracking as trk
    from orb_slam3_ros2_tpu_torch.io.synthetic import _texture

    dev = check_device(device)
    cfg = ex.ExtractorConfig(n_features=512, n_levels=4, height=H, width=W)
    extract = ex.make_extractor(cfg)
    mcfg = ms.MapConfig(max_kf=16, max_lm=1024,
                        n_feat=ex.total_capacity(cfg))

    # Self-consistent map: the image's own features backprojected at
    # varied depths, so the step matches for real at the identity pose.
    rng = np.random.default_rng(0)
    img = torch.from_numpy(_texture(H, W, seed=0).astype(np.float32)).to(dev)
    feats0 = extract(img)
    uv0 = feats0.uv.cpu().numpy()
    valid = feats0.mask.cpu().numpy()
    z = rng.uniform(3.0, 8.0, uv0.shape[0]).astype(np.float32)
    X = np.stack([(uv0[:, 0] - CX) / FX * z, (uv0[:, 1] - CY) / FY * z, z],
                 axis=-1).astype(np.float32)
    L = min(int(valid.sum()), mcfg.max_lm)
    idx = torch.from_numpy(np.flatnonzero(valid)[:L]).to(dev)
    m = ms.empty_map(mcfg, dev)
    lm_X, lm_valid, lm_bits = (m.lm_X.clone(), m.lm_valid.clone(),
                               m.lm_bits.clone())
    lm_X[:L] = torch.from_numpy(X).to(dev)[idx]
    lm_valid[:L] = True
    lm_bits[:L] = feats0.bits[idx]
    m = m._replace(lm_X=lm_X, lm_valid=lm_valid, lm_bits=lm_bits)
    R0 = torch.eye(3, device=dev)
    t0 = torch.zeros(3, device=dev)

    def step(img, m):
        feats = extract(img)
        tm = trk.match_to_map(m, feats.uv, feats.bits, feats.mask, R0, t0,
                              FX, FY, CX, CY, W, H)
        res, _ = trk.track_pose(m, tm.obs_lm, feats.uv, feats.level, R0, t0,
                                FX, FY, CX, CY)
        return res.R, res.t, res.n_inliers

    return step, (img, m)


def _shard_devices(n: int, devices: Optional[Sequence]) -> list:
    if devices is not None:
        if len(devices) < n:
            raise ValueError(f"dryrun_multichip({n}): {len(devices)} devices "
                             "given")
        return [torch.device(d) for d in devices[:n]]
    check_device("cuda")
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=dev)


def _mean_err(t, t_gt) -> float:
    t = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return float(np.linalg.norm(t - t_gt, axis=-1).mean())


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None
                     ) -> dict:
    """The JAX `dryrun_multichip`'s checks on an n-shard mesh; raises
    AssertionError when one fails. Returns the numbers it prints."""
    from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
    from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod
    from orb_slam3_ros2_tpu_torch.geom import lie
    from orb_slam3_ros2_tpu_torch.imu import preintegration as pre_mod
    from orb_slam3_ros2_tpu_torch.io import synthetic
    from orb_slam3_ros2_tpu_torch.parallel import mesh as mesh_mod
    from orb_slam3_ros2_tpu_torch.parallel import sharded_ba
    from orb_slam3_ros2_tpu_torch.parallel import sharded_pose_graph as spg
    from orb_slam3_ros2_tpu_torch.parallel import sharded_vi_ba
    from orb_slam3_ros2_tpu_torch.runtime import system as sys_mod

    devs = _shard_devices(n_devices, devices)
    dev = devs[0]
    mesh = mesh_mod.make_mesh(n_devices, devices=devs)
    assert mesh.devices.size == n_devices, mesh.devices.shape
    out = {}

    # ---- 1. the System's global BA through the landmark-sharded solver
    K = 32
    L = 128 * n_devices  # divisible by the lm axis
    eng = sys_mod.System(
        None, SETTINGS, sys_mod.Sensor.MONOCULAR,
        # n_feat must equal the synth_cam extractor capacity (600)
        map_cfg=ms.MapConfig(max_kf=K, max_lm=L, n_feat=600),
        mesh=mesh, device=dev)
    cam = eng.cam
    sc = synthetic.make_scene(n_frames=K, n_points=L, noise_px=0.3, seed=0,
                              fps=2.0, fx=cam.fx, fy=cam.fy, cx=cam.cx,
                              cy=cam.cy)
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.01, (K, 6)).astype(np.float32)
    xi[0] = 0.0
    R0, t0 = lie.se3_retract(_f32(sc.R_cw, dev), _f32(sc.t_cw, dev),
                             _f32(xi, dev))
    n_feat = eng.map_cfg.n_feat
    obs = np.full((K, n_feat), -1, np.int32)
    fv = np.zeros((K, n_feat), bool)
    uv_feat = np.zeros((K, n_feat, 2), np.float32)
    for k in range(K):
        vis_ids = np.flatnonzero(sc.vis[k] > 0)[:n_feat]
        obs[k, : len(vis_ids)] = vis_ids
        fv[k, : len(vis_ids)] = True
        uv_feat[k, : len(vis_ids)] = sc.uv[k, vis_ids]
    eng.map = eng.map._replace(
        kf_valid=torch.ones(K, dtype=torch.bool, device=dev),
        kf_R=R0, kf_t=t0, kf_uv=_f32(uv_feat, dev),
        kf_obs_lm=torch.from_numpy(obs).to(dev),
        kf_feat_valid=torch.from_numpy(fv).to(dev),
        lm_X=_f32(sc.X + rng.normal(0, 0.03, sc.X.shape), dev),
        lm_valid=torch.ones(L, dtype=torch.bool, device=dev),
        n_kf=torch.tensor(K, dtype=torch.int32, device=dev),
        n_lm=torch.tensor(L, dtype=torch.int32, device=dev))
    err_before = _mean_err(eng.map.kf_t, sc.t_cw)
    eng._run_global_ba(n_iters=4)
    err_after = _mean_err(eng.map.kf_t, sc.t_cw)
    assert bool(torch.isfinite(eng.map.kf_t).all())
    assert err_after < err_before, (err_after, err_before)
    assert eng.n_mesh_solves == 1, eng.n_mesh_solves
    out["system_global_ba"] = dict(err_before=err_before,
                                   err_after=err_after)
    print(f"dryrun_multichip({n_devices}): SYSTEM-level distributed global "
          f"BA OK (pose err {err_before:.4f} -> {err_after:.4f} over "
          f"{K} kf x {L} lm on the {n_devices}-device lm mesh)")

    # ---- 2. one landmark-sharded BA step (solver-level check)
    fixed = torch.zeros(K, dtype=torch.bool, device=dev)
    fixed[:2] = True
    p = ba_mod.BAProblem(
        R=R0, t=t0, X=_f32(sc.X, dev), uv=_f32(sc.uv, dev),
        w=_f32(sc.vis, dev), fixed=fixed,
        point_valid=torch.ones(L, dtype=torch.bool, device=dev))
    ba = sharded_ba.make_sharded_ba(mesh, sc.fx, sc.fy, sc.cx, sc.cy,
                                    n_iters=4)
    res = ba(sharded_ba.shard_problem(p, mesh))
    assert bool(torch.isfinite(res.t).all())
    out["sharded_ba_cost"] = float(res.cost)
    print(f"dryrun_multichip({n_devices}): distributed BA step OK, "
          f"cost={float(res.cost):.3f}")

    # ---- 3. the edge-sharded Sim3 pose graph: edges from the ground-truth
    # relative poses, nodes from the perturbed R0/t0, so the solve must
    # reduce the pose error
    Rgt, tgt = _f32(sc.R_cw, dev), _f32(sc.t_cw, dev)
    ei_l = list(range(1, K)) + [K - 1, K - 2, K // 2]
    ej_l = list(range(0, K - 1)) + [0, 0, 0]
    E = -(-len(ei_l) // n_devices) * n_devices
    while len(ei_l) < E:
        ei_l.append(1)
        ej_l.append(0)
    ei = torch.tensor(ei_l, dtype=torch.int32, device=dev)
    ej = torch.tensor(ej_l, dtype=torch.int32, device=dev)
    Rm = torch.einsum("eab,ecb->eac", Rgt[ei.long()], Rgt[ej.long()])
    tm = (torch.einsum("eab,eb->ea", Rm, -tgt[ej.long()])
          + tgt[ei.long()])
    fixed_pg = torch.zeros(K, dtype=torch.bool, device=dev)
    fixed_pg[0] = True
    opt = spg.make_sharded_pose_graph(mesh, K, n_iters=8)
    pgres = opt(R0, t0, torch.ones(K, device=dev), ei, ej, Rm, tm,
                torch.ones(E, device=dev),
                torch.ones(E, dtype=torch.bool, device=dev), fixed_pg)
    assert bool(torch.isfinite(pgres.t).all())
    pg_err0 = _mean_err(t0, sc.t_cw)
    pg_err1 = _mean_err(pgres.t / pgres.s[:, None], sc.t_cw)
    assert pg_err1 < 0.5 * pg_err0, (pg_err0, pg_err1)
    out["pose_graph"] = dict(err_before=pg_err0, err_after=pg_err1,
                             cost=float(pgres.cost))
    print(f"dryrun_multichip({n_devices}): distributed pose-graph step OK, "
          f"pose err {pg_err0:.4f} -> {pg_err1:.4f}, "
          f"cost={float(pgres.cost):.5f}")

    # ---- 4. the landmark-sharded visual-inertial BA: sharded Schur
    # reduction + replicated preintegration factors
    Kv = 6
    # at least 128 landmarks whatever the mesh size, rounded to it
    Lv = -(-128 // n_devices) * n_devices
    scv = synthetic.make_scene(n_frames=Kv, n_points=Lv, noise_px=0.3,
                               seed=9, fps=2.0)
    # make_scene(seed=s) flies default_trajectory(s+1); the IMU rides it
    traj = synthetic.default_trajectory(seed=10)
    true_bg = np.array([0.015, -0.01, 0.02])
    pres = []
    for i in range(Kv - 1):
        _, gy, ac = synthetic.make_imu(
            traj, scv.timestamps[i], scv.timestamps[i + 1], rate=200.0,
            gyro_bias=true_bg, gyro_noise=1e-4, acc_noise=1e-3, seed=i)
        nn = len(gy)
        pres.append(pre_mod.preintegrate(
            _f32(gy, dev), _f32(ac, dev),
            torch.full((nn,), 1.0 / 200.0, device=dev),
            torch.ones(nn, dtype=torch.bool, device=dev)))
    pres = pre_mod.stack(pres)
    h = 1e-4
    v_gt = np.stack([(traj.position(tt + h) - traj.position(tt - h))
                     / (2 * h) for tt in scv.timestamps])
    xiv = rng.normal(0, 0.015, (Kv, 6)).astype(np.float32)
    xiv[0] = 0.0
    Rv, tv = lie.se3_retract(_f32(scv.R_cw, dev), _f32(scv.t_cw, dev),
                             _f32(xiv, dev))
    fixed_v = torch.zeros(Kv, dtype=torch.bool, device=dev)
    fixed_v[0] = True
    pv = ba_mod.BAProblem(
        R=Rv, t=tv, X=_f32(scv.X + rng.normal(0, 0.04, scv.X.shape), dev),
        uv=_f32(scv.uv, dev), w=_f32(scv.vis, dev), fixed=fixed_v,
        point_valid=torch.ones(Lv, dtype=torch.bool, device=dev))
    viba = sharded_vi_ba.make_sharded_vi_ba(
        mesh, scv.fx, scv.fy, scv.cx, scv.cy, n_iters=8,
        prior_bg=1e1, prior_ba=1e0)
    vout = viba(sharded_vi_ba.shard_vi_problem(pv, mesh), pres,
                _f32(v_gt + rng.normal(0, 0.1, v_gt.shape), dev),
                torch.zeros(3, device=dev), torch.zeros(3, device=dev))
    vi_err0 = _mean_err(tv, scv.t_cw)
    vi_err1 = _mean_err(vout.t, scv.t_cw)
    bg_err = float(np.linalg.norm(vout.bg.cpu().numpy() - true_bg))
    assert bool(torch.isfinite(vout.t).all())
    assert vi_err1 < vi_err0, (vi_err0, vi_err1)
    assert bg_err < 5e-3, bg_err
    out["vi_ba"] = dict(err_before=vi_err0, err_after=vi_err1,
                        bg_err=bg_err)
    print(f"dryrun_multichip({n_devices}): distributed VIBA step OK "
          f"(pose err {vi_err0:.4f} -> {vi_err1:.4f}, gyro-bias err "
          f"{bg_err:.4f}, landmark-sharded visual Schur + replicated "
          f"inertial factors)")

    # ---- 5. the (kf, lm) mesh: covisibility-partitioned map blocks over
    # kf, landmarks over lm, on a trajectory that passes twice through
    # n_places places (contiguous chunking splits each place at every
    # revisit; covisibility partitioning groups the revisits)
    if n_devices >= 2:
        from orb_slam3_ros2_tpu_torch.parallel import block_ba, partition

        mesh2 = mesh_mod.make_mesh(
            n_devices, axis_names=(mesh_mod.KF_AXIS, mesh_mod.LM_AXIS),
            devices=devs)
        nk, nl = mesh2.devices.shape
        K2 = 128 * nk
        Lb = 64 * nl
        n_places = max(2 * nk, 4)
        passes = 2
        seg = K2 // (n_places * passes)
        place_of_kf = (np.arange(K2) // max(seg, 1)) % n_places
        place_of_lm = (np.arange(Lb) * n_places) // Lb
        # keyframe k sees its place's landmarks and the next place's (a
        # seam shared by consecutive places, as corridors have)
        vis = (place_of_lm[None, :] == place_of_kf[:, None]) | (
            place_of_lm[None, :] == ((place_of_kf[:, None] + 1) % n_places))
        vis = vis.astype(np.float64)
        sc2 = synthetic.make_scene(n_frames=K2, n_points=Lb, noise_px=0.3,
                                   seed=4, fps=1.0)
        sc2 = dataclasses.replace(sc2, vis=vis.astype(np.float32))
        covis = vis @ vis.T
        assign = partition.partition_keyframes(covis, nk)
        idx, valid = partition.shard_indices(assign, nk, pad_to=K2 // nk + 1)
        boundary = partition.boundary_keyframes(covis, assign)
        assign_contig = np.arange(K2) * nk // K2

        xi2 = rng.normal(0, 0.01, (K2, 6)).astype(np.float32)
        R2, t2 = lie.se3_retract(_f32(sc2.R_cw, dev), _f32(sc2.t_cw, dev),
                                 _f32(xi2, dev))
        R2, t2 = R2.cpu().numpy(), t2.cpu().numpy()
        # each block solves its covisible keyframe set with the boundary
        # keyframes held fixed, so blocks need no communication
        w_b = sc2.vis[idx] * valid[:, :, None]
        pb = ba_mod.BAProblem(
            R=_f32(R2[idx], dev), t=_f32(t2[idx], dev),
            X=_f32(np.broadcast_to(sc2.X, (nk,) + sc2.X.shape), dev),
            uv=_f32(sc2.uv[idx], dev), w=_f32(w_b, dev),
            fixed=torch.from_numpy(
                boundary[idx] | (np.arange(idx.shape[1]) == 0)[None, :]
            ).to(dev),
            point_valid=torch.from_numpy(w_b.any(1)).to(dev))
        bba = block_ba.make_block_sharded_ba(mesh2, sc2.fx, sc2.fy, sc2.cx,
                                             sc2.cy, n_iters=3)
        outb = bba(block_ba.shard_block_problem(pb, mesh2))
        assert bool(torch.isfinite(outb.t).all())
        cut = partition.cut_fraction(covis, assign)
        cut_contig = partition.cut_fraction(covis, assign_contig)
        # a 1-wide kf axis has no cuts to compare
        if nk >= 2:
            assert cut < 0.6 * cut_contig, (
                f"covis partitioning must beat contiguous chunking on the "
                f"revisit trajectory: {cut:.3f} vs {cut_contig:.3f}")
        out["block_ba"] = dict(mesh=[int(nk), int(nl)], keyframes=K2,
                               cut=cut, cut_contiguous=cut_contig)
        print(f"dryrun_multichip({n_devices}): covisibility-partitioned "
              f"block BA on {nk}x{nl} (kf, lm) mesh OK over {K2} kf "
              f"(2-pass revisit trajectory: cut fraction {cut:.3f} vs "
              f"{cut_contig:.3f} contiguous baseline)")
    return out


def main(argv=None) -> dict:
    """One step of `entry()` (and `dryrun_multichip(N)` with `--dryrun N`);
    prints and returns the result as a dict."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun", type=int, default=0,
                    help="also run dryrun_multichip on this many shards")
    add_device(ap)
    args = ap.parse_args(argv)
    dev = device_of(ap, args)
    step, ex_args = entry(dev)
    R, t, n = step(*ex_args)
    blob = {"R": R.cpu().tolist(), "t": t.cpu().tolist(),
            "n_inliers": int(n)}
    if args.dryrun:
        blob["dryrun"] = dryrun_multichip(
            args.dryrun, None if dev.type == "cuda" else [dev] * args.dryrun)
    print(json.dumps(blob))
    return blob


if __name__ == "__main__":
    main()
