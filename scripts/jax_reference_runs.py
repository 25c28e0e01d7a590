#!/usr/bin/env python3
"""The JAX System on the clips of the port's `chip_smoke.py` phases 8, 9
and 10, on the CPU: the reference figures beside the port's.

    python scripts/jax_reference_runs.py [--config euroc_reloc|synth_loopy|
                                          euroc_vi|euroc_vi_pipelined ...]

euroc_reloc: the 752x480 EuRoC clip rendered through the radtan distortion
of `config/Monocular/EuRoC.yaml` (`system_run.render_euroc_distorted`), 40
frames through the JAX `System.track_monocular` on that file as published,
then the scenarios of `system_run.run_reloc` (blackout and frame 10
re-shown, a blank frame, the Atlas saved and reloaded, noise frames after
the recovery and on a fresh copy). synth_loopy: the evaluation's row,
`runtime/bench_eval.run_loop_closure_case` at 280 frames (ATE with loop
closing on and off). synth_loopy_events (not in the default list): the
same clip with loop closing on, frame by frame, in the JAX System, the
port on the CPU and the port writing its BoW rows at the JAX System's
slots: the frames on which each lost tracking, spawned a map, closed a
loop or merged maps. euroc_vi (not in the default list): phase 10's clip
(`system_run.render_euroc_vi`: 120 frames at 600x350 with a 200 Hz IMU)
through the JAX `System.track_monocular` in IMU_MONOCULAR mode on
`config/Monocular-Inertial/EuRoC.yaml` as published, with the measures of
`system_run.vi_metrics`. euroc_vi_pipelined (not in the default list):
the same with `System(pipelined=True)`, and the frames that took the
pipelined path (a frame in flight after the call, as `bench.py` counts
them). vi_rigs (not in the default list): phase 10b's
IMU_STEREO and IMU_RGBD clips; with `--features PATH`, the stereo clip
on the feature sets that the port extracted (`tools/vi_rig_diff.py
--save-features`), in place of the JAX extraction.
Prints one JSON object per configuration.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def euroc_reloc() -> dict:
    from orb_slam3_ros2_tpu.runtime.system import Sensor, System, TrackingState
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    settings = os.path.join(ROOT, sr.EUROC)
    imgs, R_gt, t_gt, ts = sr.render_euroc_distorted()
    slam = System(None, settings, Sensor.MONOCULAR)
    t0 = time.perf_counter()
    for k in range(sr.N_FRAMES):
        slam.track_monocular(imgs[k], float(ts[k]))
    wall = time.perf_counter() - t0
    tracked = [k for k, r in enumerate(slam.tracking_log)
               if r["state"] == int(TrackingState.OK)]
    traj = slam.get_frame_trajectory()
    from orb_slam3_ros2_tpu_torch.io import synthetic

    est = np.array([_centre(traj[k][1]) for k in tracked])
    gt = np.array([-R_gt[k].T @ t_gt[k] for k in tracked])
    out = dict(config="euroc_reloc", n_kf=int(slam.map.n_kf),
               bow_rows=int(slam.bow_db.n), n_tracked=len(tracked),
               init_frame=tracked[0] if tracked else None,
               ate_m=synthetic.ate_rmse(est, gt), wall_s=wall)

    def blackout(s):
        s.state = TrackingState.LOST
        s.atlas.create_new_map()
        s._spawn_state_reset()
        s.state = TrackingState.LOST

    k = sr.RELOC_SHOW_FRAME
    a = copy.deepcopy(slam)
    pose_k = a.get_trajectory()[k][1]
    blackout(a)
    T = a.track_monocular(imgs[k], float(ts[-1]) + 1.0)
    out["blackout"] = dict(state=a.state.name, active=a.atlas.active,
                           n_maps=a.atlas.n_maps(),
                           centre_err_m=float(np.linalg.norm(
                               _centre(T) - _centre(pose_k))))
    b = copy.deepcopy(slam)
    blackout(b)
    b.track_monocular(np.zeros_like(imgs[0]), float(ts[-1]) + 2.0)
    out["blank"] = dict(state=b.state.name, n_maps=b.atlas.n_maps())
    with tempfile.TemporaryDirectory() as tmp:
        path = slam.save_atlas(os.path.join(tmp, "atlas.npz"))
        c = System(None, settings, Sensor.MONOCULAR, load_atlas=path)
    n = 0
    for j in range(sr.RELOC_RETRIES):
        n += 1
        c.track_monocular(imgs[j], float(ts[j]) + 100.0)
        if c.state == TrackingState.OK:
            break
    out["reload"] = dict(state=c.state.name, frames_to_recover=n,
                         n_kf=int(c.map.n_kf), n_maps=c.atlas.n_maps())

    def noise_run(d, t):
        rng = np.random.default_rng(0)
        n_maps, lost = d.atlas.n_maps(), 0
        for _ in range(d.LOST_FRAMES_NEW_MAP + 8):
            t += 0.1
            lost += d.state != TrackingState.OK
            d.track_monocular(
                rng.uniform(0, 255, imgs[0].shape).astype(np.float32), t)
            if (d.atlas.n_maps() != n_maps
                    or d.state == TrackingState.NOT_INITIALIZED):
                break
        return dict(n_maps=d.atlas.n_maps(), state=d.state.name,
                    map0_n_kf=int(d.atlas.maps[0].n_kf), lost_frames=lost)

    out["new_map"] = noise_run(a, float(ts[-1]) + 3.0)
    out["restart"] = noise_run(copy.deepcopy(slam), float(ts[-1]))
    return out


def synth_loopy() -> dict:
    from orb_slam3_ros2_tpu.runtime import bench_eval

    return bench_eval.run_loop_closure_case(
        {"name": "synth_loopy", "n_frames": 280, "seed": 3})


def _event_run(slam, imgs, ts) -> dict:
    """Track the clip frame by frame and note the frames on which tracking
    was lost, a map was spawned, a loop closed or two maps merged."""
    ev = dict(lost=[], map_spawned=[], loop_closed=[], maps_merged=[])
    prev = (1, 1, 0, 0)
    for k in range(len(imgs)):
        slam.track_monocular(imgs[k], float(ts[k]))
        cur = (int(slam.state), slam.atlas.n_maps(), slam.n_loops_closed,
               slam.n_maps_merged)
        if cur[0] == 2 and prev[0] != 2:
            ev["lost"].append(k)
        if cur[1] > prev[1]:
            ev["map_spawned"].append(k)
        if cur[2] > prev[2]:
            ev["loop_closed"].append(k)
        if cur[3] > prev[3]:
            ev["maps_merged"].append(k)
        prev = cur
    ev["n_tracked"] = sum(r["state"] == 1 for r in slam.tracking_log)
    ev["n_kf"] = int(slam.map.n_kf)
    ev["bow_rows"] = int(slam.bow_db.n)
    return ev


def synth_loopy_events() -> dict:
    """synth_loopy with loop closing on, frame by frame, in three Systems:
    the JAX System; the port on the CPU; the port on the CPU writing its
    BoW rows as the JAX System does (none for the initializer's keyframes,
    then slot `db.n`). Which event each has (an in-map loop or a merge),
    and whether the port's slot rule decides it."""
    from orb_slam3_ros2_tpu.runtime import bench_eval
    from orb_slam3_ros2_tpu.runtime.system import Sensor, System
    from orb_slam3_ros2_tpu_torch.loop import vocab as tvocab
    from orb_slam3_ros2_tpu_torch.runtime import system as tsys
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    imgs, _, _, ts = sr.render_loopy()
    out = {}
    with tempfile.TemporaryDirectory() as td:
        c = sr.LOOPY
        settings = bench_eval._write_settings(
            td, c["width"], c["height"], c["fx"], c["fx"], c["fps"], 0.0)
        slam = System(None, settings, Sensor.MONOCULAR)
        slam.settings.loop_closing = True
        out["jax"] = _event_run(slam, imgs, ts)
        path = os.path.join(td, "loopy.yaml")
        with open(path, "w") as f:
            f.write(sr.loopy_settings(True))
        out["port"] = _event_run(
            tsys.System(None, path, tsys.Sensor.MONOCULAR, device="cpu"),
            imgs, ts)

        def jax_rows(self, kf_id, feats):
            if kf_id >= 2:
                self.bow_db = tvocab.add_keyframe(
                    self.bow_db, self.vocab, feats.signs, feats.mask,
                    slot=int(self.bow_db.n))

        own = tsys.System._add_bow_row
        tsys.System._add_bow_row = jax_rows
        try:
            out["port_jax_slots"] = _event_run(
                tsys.System(None, path, tsys.Sensor.MONOCULAR,
                            device="cpu"), imgs, ts)
        finally:
            tsys.System._add_bow_row = own
    return dict(config="synth_loopy_events", **out)


def euroc_vi(pipelined: bool = False) -> dict:
    from orb_slam3_ros2_tpu.runtime.system import Sensor, System
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    images, R_gt, t_gt, ts, imu = sr.render_euroc_vi()
    slam = System(None, os.path.join(ROOT, sr.EUROC_VI), Sensor.IMU_MONOCULAR,
                  pipelined=pipelined)
    init_frame, t_prev, n_piped = None, -1.0, 0
    t0 = time.perf_counter()
    for k in range(len(images)):
        slam.track_monocular(images[k], float(ts[k]),
                             sr.imu_points(imu, t_prev, float(ts[k])))
        if init_frame is None and slam.is_imu_initialized():
            init_frame = k
        # a frame in flight after the call: it took the pipelined path
        n_piped += slam._pend is not None
        t_prev = float(ts[k])
    r = dict(config="euroc_vi_pipelined" if pipelined else "euroc_vi",
             state=slam.get_tracking_state().name,
             vi_init_frame=init_frame, wall_s=time.perf_counter() - t0,
             **sr.vi_metrics(slam, R_gt, t_gt, sr.VI_TRUE_BG))
    if pipelined:
        r["pipelined_frames"] = n_piped
    r["failed_bars"] = sr.vi_failures(r)
    return r


def replay_features(slam, path: str) -> None:
    """Feed the JAX `slam` the feature sets of a file written by the port's
    `tools/vi_rig_diff.py --save-features`, in order, instead of
    extracting."""
    import jax.numpy as jnp
    from orb_slam3_ros2_tpu.frontend.extractor import Features
    from orb_slam3_ros2_tpu.ops.orb_descriptor import signs_from_bits

    d = dict(np.load(path))
    calls = iter(range(len(d["mask"])))

    def replay(img):
        i = next(calls)
        bits = jnp.asarray(d["bits"][i].view(np.uint32))
        return Features(uv=jnp.asarray(d["uv"][i]),
                        level=jnp.asarray(d["level"][i]),
                        angle=jnp.asarray(d["angle"][i]),
                        score=jnp.asarray(d["score"][i]),
                        signs=signs_from_bits(bits), bits=bits,
                        mask=jnp.asarray(d["mask"][i]))

    slam._extract = replay


def vi_rigs(features=None) -> dict:
    """The IMU_STEREO and IMU_RGBD clips of phase 10b (the JAX inertial
    e2e tests') through the JAX System, with `system_run.vi_rig_metrics`;
    with `features` (a file of the port's `vi_rig_diff --save-features`),
    the stereo clip alone, fed those feature sets instead of extracting."""
    from orb_slam3_ros2_tpu.runtime.system import Sensor, System
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    out = {}
    for name, rig in sr.VI_RIGS.items():
        if features and rig.sensor != sr.sysm.Sensor.IMU_STEREO:
            continue
        frames = sr.render_vi_rig(rig)
        slam = System(None, os.path.join(ROOT, rig.settings),
                      Sensor(int(rig.sensor)))
        slam.VI_INIT_KFS = 6
        if features:
            replay_features(slam, features)
        for k in range(rig.n_frames):
            sr.track_vi_rig(slam, rig, frames, k)
        out[name] = sr.vi_rig_metrics(slam, rig, frames[2], frames[3])
        out[name]["features"] = features
        print(json.dumps({name: out[name]}), flush=True)
    return dict(config="vi_rigs", **out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", nargs="+",
                    default=["euroc_reloc", "synth_loopy"],
                    choices=["euroc_reloc", "synth_loopy",
                             "synth_loopy_events", "euroc_vi",
                             "euroc_vi_pipelined", "vi_rigs"])
    ap.add_argument("--features", help="vi_rigs: run the stereo clip on "
                    "the feature sets of this file (`tools/vi_rig_diff.py "
                    "--save-features`) instead of extracting")
    args = ap.parse_args(argv)
    runs = dict(euroc_reloc=euroc_reloc, synth_loopy=synth_loopy,
                synth_loopy_events=synth_loopy_events, euroc_vi=euroc_vi,
                euroc_vi_pipelined=lambda: euroc_vi(pipelined=True),
                vi_rigs=lambda: vi_rigs(args.features))
    for name in args.config:
        print(json.dumps(runs[name]()), flush=True)


if __name__ == "__main__":
    main()
