"""Run the monocular System over a rendered EuRoC-intrinsics clip: the
configuration of `chip_smoke.py` phase 4, which imports it from here.

    python -m orb_slam3_ros2_tpu_torch.tools.system_run [--device DEV]
        [--profile] [--cpu-inputs] [--init-offsets K ...]

--profile     (CUDA) trace frames 16-24, then the first keyframe insertion
              from frame 25 on, with torch.profiler; print for each the wall
              and device time, kernel launches, copy and synchronize calls,
              and the operators with the most device time.
--cpu-inputs  extract each frame's features and draw the initializer's
              samples on the CPU, then move them to the device: the run on
              the device then starts from the same inputs as a `--device cpu`
              run, so the two differ only downstream of extraction and
              sampling.
--init-offsets  run the System once for each K, with K added to the seed
              of every initialization attempt (the System seeds attempt
              n with n): how the result varies with the initializer's draw.

Prints one JSON object per report, and one per run with its result:
initializing frame, keyframe and landmark counts, tracked frames,
Sim3-aligned ATE of `get_frame_trajectory()` and `get_trajectory()`,
per-frame ms.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
from orb_slam3_ros2_tpu_torch.frontend import initializer as init_mod
from orb_slam3_ros2_tpu_torch.io import synthetic
from orb_slam3_ros2_tpu_torch.runtime import system as sysm

# EuRoC cam0 (config/Monocular/EuRoC.yaml) and the renderer settings of
# tests/test_e2e_mono.py
N_FRAMES = 40
WIDTH, HEIGHT = 752, 480
FX, FY, CX, CY = 458.654, 457.296, 367.215, 248.375
FPS, TRAJ_SCALE, PLANE_DEPTHS, SEED = 10.0, 1.6, (6.0, 9.0), 1


def render():
    """(images, R_gt, t_gt, timestamps) of the clip."""
    return synthetic.render_sequence(
        n_frames=N_FRAMES, width=WIDTH, height=HEIGHT, fx=FX, fy=FY, fps=FPS,
        seed=SEED, plane_depths=PLANE_DEPTHS, traj_scale=TRAJ_SCALE, cx=CX,
        cy=CY)


def write_settings(path: Path) -> str:
    """EuRoC cam0 as a rectified camera (the frames are rendered without
    distortion), 1000 features over 8 levels, loop closing off."""
    path.write_text(
        "%YAML:1.0\nCamera.type: \"Rectified\"\n"
        f"Camera1.fx: {FX}\nCamera1.fy: {FY}\nCamera1.cx: {CX}\n"
        f"Camera1.cy: {CY}\nCamera.width: {WIDTH}\nCamera.height: {HEIGHT}\n"
        f"Camera.fps: {int(FPS)}\nORBextractor.nFeatures: 1000\n"
        "ORBextractor.scaleFactor: 1.2\nORBextractor.nLevels: 8\n"
        "ORBextractor.iniThFAST: 20\nORBextractor.minThFAST: 7\n"
        "loopClosing: 0\n")
    return str(path)


def make_system(device) -> sysm.System:
    with tempfile.TemporaryDirectory() as tmp:
        return sysm.System(None, write_settings(Path(tmp) / "euroc.yaml"),
                           sysm.Sensor.MONOCULAR, device=device)


def tracked_frames(slam: sysm.System) -> list:
    return [k for k, r in enumerate(slam.tracking_log)
            if r["state"] == int(sysm.TrackingState.OK)]


def ate(slam: sysm.System, traj, R_gt, t_gt) -> float:
    """Sim3-aligned ATE (m) of the camera centres of `traj` over the frames
    tracked OK."""
    tracked = tracked_frames(slam)
    est = np.array([-T[:3, :3].T @ T[:3, 3] for k, (_, T) in enumerate(traj)
                    if k in tracked])
    gt = np.array([-R_gt[k].T @ t_gt[k] for k in tracked])
    return synthetic.ate_rmse(est, gt)


def patch_inputs(slam: sysm.System, cpu_inputs: bool, init_offset: int):
    """Shift every initialization attempt's seed by `init_offset`; with
    `cpu_inputs`, route `slam`'s extraction and the initializer's sampling
    through the CPU and move the results to `slam.device`. Returns the
    function that undoes the module-level patch."""
    extract = ex.make_extractor(slam.ex_cfg)

    def extract_on_cpu(img):
        f = extract(img.cpu())
        f = dataclasses.replace(f, uv=sysm.undistort(slam.cam, f.uv))
        return dataclasses.replace(f, **{
            fl.name: getattr(f, fl.name).to(slam.device)
            for fl in dataclasses.fields(f)})

    initialize = init_mod.initialize

    def initialize_patched(gen, uv1, uv2, mask, *args, **kwargs):
        seed = gen.initial_seed() + init_offset
        where = "cpu" if cpu_inputs else gen.device
        g = torch.Generator(device=where).manual_seed(seed)
        m = mask.to(where)
        idx_h = init_mod.sample_indices(g, m, init_mod.N_HYPO, 4)
        idx_f = init_mod.sample_indices(g, m, init_mod.N_HYPO, 8)
        return init_mod.initialize_from_samples(
            uv1, uv2, mask, idx_h.to(mask.device), idx_f.to(mask.device),
            *args, **kwargs)

    if cpu_inputs:
        slam._extract_undistorted = extract_on_cpu
    init_mod.initialize = initialize_patched
    return lambda: setattr(init_mod, "initialize", initialize)


def profile_summary(prof, wall_ms: float, label: str, top: int) -> dict:
    """Wall and device time, launches and copy/sync calls of a trace."""
    ka = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in ka)
    launches = sum(e.count for e in ka if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    copies = sum(e.count for e in ka if "Synchronize" in e.key
                 or e.key == "cudaMemcpyAsync")
    rows = sorted(ka, key=lambda e: -e.self_device_time_total)[:top]
    return dict(label=label, wall_ms=wall_ms, device_ms=dev_us / 1e3,
                device_busy=dev_us / 1e3 / wall_ms, kernel_launches=launches,
                memcpy_or_sync_calls=copies,
                top=[(e.key[:60], e.count, e.self_device_time_total / 1e3)
                     for e in rows])


def run(device, profile: bool = False, cpu_inputs: bool = False,
        init_offset: int = 0) -> dict:
    from torch.profiler import ProfilerActivity, profile as trace

    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    imgs, R_gt, t_gt, ts = render()
    slam = make_system(device)
    restore = patch_inputs(slam, cpu_inputs, init_offset)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    insert = slam._insert_keyframe_fused

    def traced_insert(*args, **kwargs):
        slam._insert_keyframe_fused = insert  # the first insertion only
        sync()
        with trace(activities=activities) as p:
            t0 = time.perf_counter()
            insert(*args, **kwargs)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        print(json.dumps(profile_summary(
            p, wall, "one keyframe insertion (mapping_step + fetch)", 20)))

    frame_ms = []
    try:
        for k in range(N_FRAMES):
            if profile and k == 16:
                sync()
                window = trace(activities=activities)
                window.__enter__()
                t_win = time.perf_counter()
            if profile and k == 25:
                slam._insert_keyframe_fused = traced_insert
            sync()
            t0 = time.perf_counter()
            slam.track_monocular(imgs[k], float(ts[k]))
            sync()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            if profile and k == 24:
                wall = (time.perf_counter() - t_win) * 1e3
                window.__exit__(None, None, None)
                print(json.dumps(profile_summary(
                    window, wall, "frames 16-24", 14)))
    finally:
        restore()
    tracked = tracked_frames(slam)
    return dict(device=str(device), cpu_inputs=cpu_inputs,
                init_offset=init_offset,
                init_frame=tracked[0] if tracked else None,
                state=slam.get_tracking_state().name,
                n_kf=int(slam.map.n_kf), n_lm=int(slam.map.lm_valid.sum()),
                n_tracked=len(tracked),
                ate_m=ate(slam, slam.get_frame_trajectory(), R_gt, t_gt),
                ate_raw_m=ate(slam, slam.get_trajectory(), R_gt, t_gt),
                frame_ms=frame_ms,
                median_frame_ms=statistics.median(frame_ms))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available()
                    else "cpu")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--cpu-inputs", action="store_true")
    ap.add_argument("--init-offsets", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)
    if args.profile and torch.device(args.device).type != "cuda":
        ap.error("--profile traces a CUDA device")
    for k in args.init_offsets:
        print(json.dumps(run(args.device, args.profile, args.cpu_inputs, k)))


if __name__ == "__main__":
    main()
