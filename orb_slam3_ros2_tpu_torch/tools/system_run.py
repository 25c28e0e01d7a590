"""Run the System over a rendered clip of one of the configurations of
`chip_smoke.py` phases 4-7, which import them from here.

    python -m orb_slam3_ros2_tpu_torch.tools.system_run [--device DEV]
        [--config NAME] [--profile] [--cpu-inputs] [--init-offsets K ...]

--config      euroc_mono (the default: `track_monocular`, phase 4),
              kitti_stereo, tum1_rgbd or tumvi_stereo (`track_stereo` /
              `track_rgbd`, phases 5-7; see `RIGS`). The three options
              below apply to euroc_mono only.

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
Sim3-aligned ATE of `get_frame_trajectory()` and `get_trajectory()` (for a
rig configuration: of `get_trajectory()`, and the unaligned trajectory
length against the ground truth's), per-frame ms.

The rig configurations take a published settings file's widths unchanged:
image size, intrinsics, feature count, levels, FAST thresholds, baseline
and `Stereo.ThDepth`. What each cuts (`reduced`): rendered frames instead
of a recorded sequence, a 22-30-frame clip of it, fps 10 where the source
says 20 or 30, loop closing off; TUM1 drops its radtan distortion (the
frames are rendered without it, so the settings say `Rectified`), and
TUM-VI's `Stereo.T_c1_c2` keeps only its x translation (the renderer's rig
is a translation along x). KITTI and TUM-VI fly through the textured room
of `render_room_sequence_kb8` (walls, floor and ceiling; photometric
noise), TUM1 past the fronto-parallel planes of `render_sequence`, which
also renders its depth.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import tempfile
import time
from pathlib import Path
from typing import Callable, Tuple

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
from orb_slam3_ros2_tpu_torch.frontend import initializer as init_mod
from orb_slam3_ros2_tpu_torch.io import settings as settings_mod
from orb_slam3_ros2_tpu_torch.io import synthetic
from orb_slam3_ros2_tpu_torch.models import cameras
from orb_slam3_ros2_tpu_torch.runtime import system as sysm

REPO = Path(__file__).resolve().parents[2]

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


# ------------------------------------------------- stereo and RGB-D rigs

def _yaml_value(v) -> str:
    if isinstance(v, np.ndarray):
        data = ", ".join(repr(float(x)) for x in v.reshape(-1))
        return (f"!!opencv-matrix\n  rows: {v.shape[0]}\n  cols: {v.shape[1]}"
                f"\n  dt: f\n  data: [{data}]")
    if isinstance(v, str):
        return f'"{v}"'
    return repr(v)


def derived_settings(source: str, overrides: dict, drop=()) -> str:
    """The OpenCV-YAML text of `source` (a path under the repository) with
    `overrides` applied and the keys in `drop` removed."""
    d = settings_mod.load_opencv_yaml(str(REPO / source))
    d.update(overrides)
    return "%YAML:1.0\n" + "".join(f"{k}: {_yaml_value(v)}\n"
                                    for k, v in d.items() if k not in drop)


def _kb8(d: dict, prefix: str, width: int, height: int) -> cameras.Camera:
    return cameras.make_camera(
        "KannalaBrandt8", d[f"{prefix}.fx"], d[f"{prefix}.fy"],
        d[f"{prefix}.cx"], d[f"{prefix}.cy"],
        [d[f"{prefix}.k{i}"] for i in (1, 2, 3, 4)], width, height)


@dataclasses.dataclass(frozen=True)
class Rig:
    """A stereo or RGB-D configuration: `settings()` gives the YAML text,
    `render()` the clip as (images, right images or depth maps, R_gt, t_gt,
    timestamps), and the bounds are those of the JAX e2e test it mirrors."""

    name: str
    sensor: sysm.Sensor
    source: str
    n_frames: int
    settings: Callable[[], str]
    render: Callable[[], Tuple]
    min_tracked: int  # tracked frames must exceed this
    ate_max_m: float  # Sim3-aligned ATE of get_trajectory()
    length_tol: float  # |unaligned length / ground truth's - 1|


KITTI = "config/Stereo/KITTI00-02.yaml"
TUM1 = "config/Monocular/TUM1.yaml"
TUMVI = "config/Stereo/TUM-VI.yaml"
TUMVI_BASELINE = 0.1010611  # the x translation of TUM-VI's Stereo.T_c1_c2


def _kitti_render():
    """The textured room seen through KITTI's rectified left camera. At
    this width the fronto-parallel planes of `tests/test_e2e_stereo.py`
    give a length ratio that falls below the bound for some sub-gray-level
    perturbations of the images, in the JAX System as in the port
    (PERF.md §6); the room's stays within 3%."""
    d = settings_mod.load_opencv_yaml(str(REPO / KITTI))
    cam = cameras.make_camera("Rectified", d["Camera1.fx"], d["Camera1.fy"],
                              d["Camera1.cx"], d["Camera1.cy"], (),
                              d["Camera.width"], d["Camera.height"])
    return synthetic.render_room_sequence_kb8(
        n_frames=30, cam=cam, fps=10.0, seed=2, traj_scale=1.4,
        noise_dn=2.0, stereo_baseline=d["Stereo.b"])


def _tum1_settings() -> str:
    return derived_settings(TUM1, {"Camera.type": "Rectified",
                                   "Camera.fps": 10.0, "loopClosing": 0},
                            drop=("Camera1.k1", "Camera1.k2", "Camera1.p1",
                                  "Camera1.p2", "Camera1.k3"))


def _tum1_render():
    d = settings_mod.load_opencv_yaml(str(REPO / TUM1))
    return synthetic.render_sequence(
        n_frames=30, width=d["Camera.width"], height=d["Camera.height"],
        fx=d["Camera1.fx"], fy=d["Camera1.fy"], fps=10.0, seed=2,
        plane_depths=(5.0, 8.0), traj_scale=1.4, return_depth=True,
        cx=d["Camera1.cx"], cy=d["Camera1.cy"])


def _tumvi_settings() -> str:
    T = np.eye(4)
    T[0, 3] = TUMVI_BASELINE
    return derived_settings(TUMVI, {"Camera.fps": 10.0, "Stereo.T_c1_c2": T,
                                    "loopClosing": 0})


def _tumvi_render():
    d = settings_mod.load_opencv_yaml(str(REPO / TUMVI))
    W, H = d["Camera.width"], d["Camera.height"]
    return synthetic.render_room_sequence_kb8(
        n_frames=22, cam=_kb8(d, "Camera1", W, H),
        cam2=_kb8(d, "Camera2", W, H), fps=10.0, seed=4, traj_scale=0.8,
        noise_dn=2.0, stereo_baseline=TUMVI_BASELINE)


RIGS = {r.name: r for r in (
    # tests/test_e2e_stereo.py's bounds at KITTI00-02 width, on the room
    Rig("kitti_stereo", sysm.Sensor.STEREO, KITTI, 30,
        lambda: derived_settings(KITTI, {"loopClosing": 0}), _kitti_render,
        min_tracked=15, ate_max_m=0.08, length_tol=0.12),
    # tests/test_e2e_rgbd.py's at TUM1's intrinsics
    Rig("tum1_rgbd", sysm.Sensor.RGBD, TUM1, 30, _tum1_settings,
        _tum1_render, min_tracked=15, ate_max_m=0.08, length_tol=0.10),
    # tests/test_e2e_fisheye.py's stereo test at TUM-VI's KB8 rig
    Rig("tumvi_stereo", sysm.Sensor.STEREO, TUMVI, 22, _tumvi_settings,
        _tumvi_render, min_tracked=22 - 8 - 1, ate_max_m=0.10,
        length_tol=0.10),
)}


def make_rig_system(rig: Rig, device) -> sysm.System:
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / f"{rig.name}.yaml"
        path.write_text(rig.settings())
        return sysm.System(None, str(path), rig.sensor, device=device)


def track_rig(slam: sysm.System, rig: Rig, frames, k: int):
    """Feed frame k of a rendered rig clip to its entry point."""
    images, second, _, _, ts = frames
    if rig.sensor == sysm.Sensor.RGBD:
        return slam.track_rgbd(images[k], second[k], float(ts[k]))
    return slam.track_stereo(images[k], second[k], float(ts[k]))


def rig_metrics(slam: sysm.System, R_gt, t_gt) -> dict:
    """The JAX e2e tests' measures on get_trajectory(): tracked frames,
    Sim3-aligned ATE, and the unaligned trajectory length against the
    ground truth's."""
    tracked = tracked_frames(slam)
    traj = slam.get_trajectory()
    est = np.array([-traj[k][1][:3, :3].T @ traj[k][1][:3, 3]
                    for k in tracked])
    gt = np.array([-R_gt[k].T @ t_gt[k] for k in tracked])
    if len(tracked) < 2:
        return dict(n_tracked=len(tracked), ate_m=None, length_ratio=None)
    len_est = np.linalg.norm(np.diff(est, axis=0), axis=1).sum()
    len_gt = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    return dict(n_tracked=len(tracked), ate_m=synthetic.ate_rmse(est, gt),
                length_ratio=float(len_est / len_gt))


def run_rig(name: str, device) -> dict:
    device = torch.device(device)
    rig = RIGS[name]
    frames = rig.render()
    slam = make_rig_system(rig, device)
    frame_ms = []
    for k in range(rig.n_frames):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        track_rig(slam, rig, frames, k)
        if device.type == "cuda":
            torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    return dict(config=name, device=str(device),
                state=slam.get_tracking_state().name,
                n_kf=int(slam.map.n_kf), n_lm=int(slam.map.lm_valid.sum()),
                **rig_metrics(slam, frames[2], frames[3]), frame_ms=frame_ms,
                median_frame_ms=statistics.median(frame_ms))


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
    ap.add_argument("--config", default="euroc_mono",
                    choices=["euroc_mono", *RIGS])
    args = ap.parse_args(argv)
    if args.config != "euroc_mono":
        if args.profile or args.cpu_inputs or args.init_offsets != [0]:
            ap.error("--profile, --cpu-inputs and --init-offsets apply to "
                     "euroc_mono only")
        print(json.dumps(run_rig(args.config, args.device)))
        return
    if args.profile and torch.device(args.device).type != "cuda":
        ap.error("--profile traces a CUDA device")
    for k in args.init_offsets:
        print(json.dumps(run(args.device, args.profile, args.cpu_inputs, k)))


if __name__ == "__main__":
    main()
