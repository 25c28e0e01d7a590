"""Run the System over a rendered clip of one of the configurations of
`chip_smoke.py` phases 4-9, which import them from here.

    python -m orb_slam3_ros2_tpu_torch.tools.system_run [--device DEV]
        [--config NAME] [--profile] [--cpu-inputs] [--init-offsets K ...]

--device      cuda (the default; without a card the run stops with an
              error) or cpu.
--config      euroc_mono (the default: `track_monocular`, phase 4),
              kitti_stereo, tum1_rgbd or tumvi_stereo (`track_stereo` /
              `track_rgbd`, phases 5-7; see `RIGS`), euroc_reloc (phase 8:
              the euroc_mono clip through the stock
              `config/Monocular/EuRoC.yaml`, then four lost-and-recovered
              scenarios; `run_reloc`) or synth_loopy (phase 9: the
              leave-and-return room clip with loop closing on and off;
              `run_loopy`) or euroc_vi (phase 10: `track_monocular` in
              IMU_MONOCULAR mode on `config/Monocular-Inertial/EuRoC.yaml`
              as published, 120 frames of the hard room at 600x350 with a
              200 Hz IMU; `run_euroc_vi`) or vi_rigs (phase 10b: the
              IMU_STEREO and IMU_RGBD clips of the JAX inertial e2e tests;
              `run_vi_rigs`). The three options below apply to euroc_mono
              only, but for --cpu-inputs, which vi_rigs takes too.

--profile     (CUDA) trace frames 16-24, then the first keyframe insertion
              from frame 25 on, with torch.profiler; print for each the wall
              and device time, kernel launches, copy and synchronize calls,
              and the operators with the most device time.
--cpu-inputs  extract each image's features and draw the initializer's
              samples on the CPU, then move them to the device: the run on
              the device then starts from the same inputs as a `--device cpu`
              run, so the two differ only downstream of extraction and
              sampling (`tools/vi_rig_diff.py` goes further for vi_rigs).
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
says 20 or 30; TUM1 drops its radtan distortion (the
frames are rendered without it, so the settings say `Rectified`), and
TUM-VI's `Stereo.T_c1_c2` keeps only its x translation (the renderer's rig
is a translation along x). KITTI and TUM-VI fly through the textured room
of `render_room_sequence_kb8` (walls, floor and ceiling; photometric
noise), TUM1 past the fronto-parallel planes of `render_sequence`, which
also renders its depth.

euroc_reloc takes `config/Monocular/EuRoC.yaml` as published (radtan
distortion, fps 20, loop closing on by default), and the euroc_mono clip is
rendered through that distortion (`render_euroc_distorted`). synth_loopy is
the JAX evaluation's `synth_loopy` row (`scripts/eval_ate.py`,
`runtime/bench_eval.run_loop_closure_case`): 280 frames at 640x480, fx 450,
fps 10, seed 3, on `render_room_sequence` along `_loop_trajectory`, with
the settings template of `runtime/bench_eval.py`.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import statistics
import tempfile
import time
from pathlib import Path
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
from orb_slam3_ros2_tpu_torch.frontend import initializer as init_mod
from orb_slam3_ros2_tpu_torch.io import settings as settings_mod
from orb_slam3_ros2_tpu_torch.io import synthetic
from orb_slam3_ros2_tpu_torch.models import cameras
from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as desc_ops
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
    distortion), 1000 features over 8 levels."""
    path.write_text(
        "%YAML:1.0\nCamera.type: \"Rectified\"\n"
        f"Camera1.fx: {FX}\nCamera1.fy: {FY}\nCamera1.cx: {CX}\n"
        f"Camera1.cy: {CY}\nCamera.width: {WIDTH}\nCamera.height: {HEIGHT}\n"
        f"Camera.fps: {int(FPS)}\nORBextractor.nFeatures: 1000\n"
        "ORBextractor.scaleFactor: 1.2\nORBextractor.nLevels: 8\n"
        "ORBextractor.iniThFAST: 20\nORBextractor.minThFAST: 7\n")
    return str(path)


def make_system(device, pipelined: bool = False) -> sysm.System:
    with tempfile.TemporaryDirectory() as tmp:
        return sysm.System(None, write_settings(Path(tmp) / "euroc.yaml"),
                           sysm.Sensor.MONOCULAR, pipelined=pipelined,
                           device=device)


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
                                   "Camera.fps": 10.0},
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
    return derived_settings(TUMVI, {"Camera.fps": 10.0, "Stereo.T_c1_c2": T})


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
        lambda: derived_settings(KITTI, {}), _kitti_render,
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


# ------------------------------------------ relocalization (phase 8)

EUROC = "config/Monocular/EuRoC.yaml"
RELOC_SHOW_FRAME = 10  # the frame re-shown after the blackout
RELOC_RETRIES = 10  # frames a reloaded Atlas may take to relocalize
RELOC_CENTRE_M = 0.1  # recovered centre against the tracked one


def render_euroc_distorted():
    """The euroc_mono clip through EuRoC cam0's radtan distortion: each raw
    pixel samples a padded pinhole render at its undistorted position,
    which the camera model of the stock settings computes (the System
    undistorts keypoints with the same model)."""
    import cv2

    cam = settings_mod.load_settings(str(REPO / EUROC)).camera
    vv, uu = np.mgrid[0:cam.height, 0:cam.width].astype(np.float32)
    rays = cameras.unproject(cam, torch.from_numpy(
        np.stack([uu, vv], -1))).numpy()
    u_p = cam.fx * rays[..., 0] + cam.cx
    v_p = cam.fy * rays[..., 1] + cam.cy
    pad = int(np.ceil(max(-u_p.min(), u_p.max() - cam.width + 1,
                          -v_p.min(), v_p.max() - cam.height + 1, 0))) + 2
    imgs, R_gt, t_gt, ts = synthetic.render_sequence(
        n_frames=N_FRAMES, width=cam.width + 2 * pad,
        height=cam.height + 2 * pad, fx=cam.fx, fy=cam.fy, fps=FPS,
        seed=SEED, plane_depths=PLANE_DEPTHS, traj_scale=TRAJ_SCALE,
        cx=cam.cx + pad, cy=cam.cy + pad)
    out = np.stack([cv2.remap(im, u_p + pad, v_p + pad, cv2.INTER_LINEAR)
                    for im in imgs])
    return out, R_gt, t_gt, ts


def _lost_frame(slam: sysm.System, image, t: float) -> dict:
    """One frame given to a lost System: its host time (device
    synchronized) and the match and pose launches it made."""
    from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused
    from orb_slam3_ros2_tpu_torch.ops import fused_match

    counters = (fused_match.match_window, pose_opt_fused.optimize_pose_fused)
    before = [fn.launches for fn in counters]
    sync = (torch.cuda.synchronize if slam.device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    slam.track_monocular(image, t)
    sync()
    return dict(ms=(time.perf_counter() - t0) * 1e3,
                recovered=slam.get_tracking_state() == sysm.TrackingState.OK,
                match_launches=fused_match.match_window.launches - before[0],
                pose_launches=(pose_opt_fused.optimize_pose_fused.launches
                               - before[1]))


def _blackout(slam: sysm.System):
    """Tracking dies and a junk map spawns (as the JAX Atlas tests force
    it): the next frames relocalize."""
    slam.state = sysm.TrackingState.LOST
    slam.atlas.create_new_map()
    slam._spawn_state_reset()
    slam.state = sysm.TrackingState.LOST


def _centre(T) -> np.ndarray:
    return -T[:3, :3].T @ T[:3, 3]


def run_reloc(device, frames=None, tmp_dir=None) -> dict:
    """The euroc_mono clip through the stock EuRoC settings from a blank
    map, then the four scenarios of the JAX Atlas tests, each on its own
    copy of the System: (blackout) a junk map, frame RELOC_SHOW_FRAME
    re-shown; (blank) a blank frame after the blackout; (reload) the Atlas
    saved and loaded by a new System through `System.LoadAtlasFromFile`,
    fed the clip's first frames; (new_map) LOST_FRAMES_NEW_MAP + 8 noise
    frames after the blackout's recovery, whose resumed map is protected,
    so it is frozen behind a new map. A fresh copy given the same noise
    (restart) shows the tiny-map policy: a map of fewer than
    MIN_KFS_KEEP_MAP keyframes restarts in place (with the stock fps of 20
    the 40-frame map has about 6). Returns the results and every lost
    frame's time and launches; the bars are checked by the caller."""
    device = torch.device(device)
    imgs, R_gt, t_gt, ts = frames if frames is not None \
        else render_euroc_distorted()
    slam = sysm.System(None, str(REPO / EUROC), sysm.Sensor.MONOCULAR,
                       device=device)
    frame_ms = []
    for k in range(N_FRAMES):
        t0 = time.perf_counter()
        slam.track_monocular(imgs[k], float(ts[k]))
        if device.type == "cuda":
            torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    tracked = tracked_frames(slam)
    n_kf = int(slam.map.n_kf)
    out = dict(config="euroc_reloc", source=EUROC, device=str(device),
               loop_closing=bool(slam.settings.loop_closing),
               state=slam.get_tracking_state().name,
               init_frame=tracked[0] if tracked else None, n_kf=n_kf,
               n_lm=int(slam.map.lm_valid.sum()), n_tracked=len(tracked),
               bow_rows=int(slam.bow_db.n),
               ate_m=ate(slam, slam.get_frame_trajectory(), R_gt, t_gt),
               median_frame_ms=statistics.median(frame_ms))
    t_end = float(ts[-1])

    k = RELOC_SHOW_FRAME
    a = copy.deepcopy(slam)
    pose_k = a.get_trajectory()[k][1]
    _blackout(a)
    lost = _lost_frame(a, imgs[k], t_end + 1.0)
    out["blackout"] = dict(
        show_frame=k, show_frame_tracked=k in tracked,
        state=a.get_tracking_state().name, active=a.atlas.active,
        n_maps=a.atlas.n_maps(), protected=a._map_protected,
        centre_err_m=float(np.linalg.norm(
            _centre(a.Tcw) - _centre(pose_k))), frame=lost)

    b = copy.deepcopy(slam)
    _blackout(b)
    lost = _lost_frame(b, np.zeros_like(imgs[0]), t_end + 2.0)
    out["blank"] = dict(state=b.get_tracking_state().name,
                        n_maps=b.atlas.n_maps(), frame=lost)

    with tempfile.TemporaryDirectory(dir=tmp_dir) as tmp:
        path = slam.save_atlas(str(Path(tmp) / "atlas.npz"))
        cfg = Path(tmp) / "euroc_resume.yaml"
        cfg.write_text((REPO / EUROC).read_text()
                       + f'\nSystem.LoadAtlasFromFile: "{path}"\n')
        c = sysm.System(None, str(cfg), sysm.Sensor.MONOCULAR,
                        device=device)
    start = c.get_tracking_state().name
    reload_frames = []
    for j in range(RELOC_RETRIES):
        reload_frames.append(_lost_frame(c, imgs[j], float(ts[j]) + 100.0))
        if reload_frames[-1]["recovered"]:
            break
    out["reload"] = dict(start_state=start, state=c.get_tracking_state().name,
                         frames_to_recover=len(reload_frames),
                         n_kf=int(c.map.n_kf), n_maps=c.atlas.n_maps(),
                         frames=reload_frames)

    def noise_run(d, t):
        """Noise frames until the Atlas changes: the frames lost, and the
        state after."""
        rng = np.random.default_rng(0)
        n_maps, lost = d.atlas.n_maps(), []
        for _ in range(d.LOST_FRAMES_NEW_MAP + 8):
            t += 0.1
            noise = rng.uniform(0, 255, imgs[0].shape).astype(np.float32)
            if d.get_tracking_state() == sysm.TrackingState.OK:
                d.track_monocular(noise, t)  # the frame that loses tracking
            else:
                lost.append(_lost_frame(d, noise, t))
            if (d.atlas.n_maps() != n_maps
                    or d.get_tracking_state()
                    == sysm.TrackingState.NOT_INITIALIZED):
                break
        return dict(n_maps=d.atlas.n_maps(),
                    state=d.get_tracking_state().name,
                    map0_n_kf=int(d.atlas.maps[0].n_kf),
                    active_n_kf=int(d.map.n_kf), lost_frames=len(lost),
                    frames=lost)

    out["new_map"] = noise_run(a, t_end + 3.0)
    out["restart"] = noise_run(copy.deepcopy(slam), t_end)
    noise_frames = out["new_map"]["frames"] + out["restart"]["frames"]
    lost_all = ([out["blackout"]["frame"], out["blank"]["frame"]]
                + reload_frames + noise_frames)
    rec = [f["ms"] for f in lost_all if f["recovered"]]
    not_rec = [f["ms"] for f in lost_all if not f["recovered"]]
    out["lost_frame_ms"] = dict(
        recovered=statistics.median(rec) if rec else None,
        not_recovered=statistics.median(not_rec) if not_rec else None,
        n_recovered=len(rec), n_not_recovered=len(not_rec))
    out["lost_launches"] = dict(
        match=sum(f["match_launches"] for f in lost_all),
        pose=sum(f["pose_launches"] for f in lost_all))
    return out


def reloc_failures(r: dict) -> list:
    """The bars of phase 8 that `run_reloc`'s result `r` misses."""
    bad = []
    a, b, c, d = r["blackout"], r["blank"], r["reload"], r["new_map"]
    e = r["restart"]
    if r["state"] != "OK" or not r["loop_closing"]:
        bad.append(f"the clip ends {r['state']}, loop closing "
                   f"{r['loop_closing']}")
    if r["bow_rows"] != r["n_kf"]:
        bad.append(f"{r['bow_rows']} BoW rows for {r['n_kf']} keyframes")
    if not (a["show_frame_tracked"] and a["state"] == "OK"
            and a["active"] == 0 and a["n_maps"] == 1
            and a["centre_err_m"] < RELOC_CENTRE_M):
        bad.append(f"blackout: {a}")
    if b["state"] != "LOST" or b["n_maps"] != 2:
        bad.append(f"blank frame: {b}")
    if not (c["start_state"] == "LOST" and c["state"] == "OK"
            and c["n_kf"] >= r["n_kf"] and c["n_maps"] == 1):
        bad.append(f"reload: {c}")
    if not (d["n_maps"] == 2 and d["state"] == "NOT_INITIALIZED"
            and d["map0_n_kf"] == r["n_kf"] and d["active_n_kf"] == 0):
        bad.append(f"new map: {d}")
    small = r["n_kf"] < sysm.System.MIN_KFS_KEEP_MAP
    if not (e["state"] == "NOT_INITIALIZED" and e["active_n_kf"] == 0
            and e["n_maps"] == (1 if small else 2)):
        bad.append(f"restart of a {r['n_kf']}-keyframe map: {e}")
    return bad


# --------------------------------------- loop closing (phase 9)

LOOPY = dict(n_frames=280, width=640, height=480, fx=450.0, fps=10.0, seed=3)


def loopy_settings(loop_closing: bool) -> str:
    """`runtime/bench_eval.py`'s settings template at the clip's camera
    (1000 features, 8 levels), with `loopClosing` set."""
    c = LOOPY
    return ("%YAML:1.0\nFile.version: \"1.0\"\nCamera.type: \"Rectified\"\n"
            f"Camera1.fx: {c['fx']}\nCamera1.fy: {c['fx']}\n"
            f"Camera1.cx: {c['width'] / 2.0}\n"
            f"Camera1.cy: {c['height'] / 2.0}\n"
            f"Camera.width: {c['width']}\nCamera.height: {c['height']}\n"
            f"Camera.fps: {c['fps']}\nCamera.RGB: 1\nStereo.b: 0.0\n"
            "ORBextractor.nFeatures: 1000\nORBextractor.scaleFactor: 1.2\n"
            "ORBextractor.nLevels: 8\nORBextractor.iniThFAST: 20\n"
            "ORBextractor.minThFAST: 7\n"
            f"loopClosing: {int(loop_closing)}\n")


def render_loopy():
    c = LOOPY
    return synthetic.render_room_sequence(
        n_frames=c["n_frames"], width=c["width"], height=c["height"],
        fx=c["fx"], fy=c["fx"], fps=c["fps"], seed=c["seed"],
        traj=synthetic._loop_trajectory(c["n_frames"], c["fps"]))


def run_loopy(device, frames, loop_closing: bool):
    """The synth_loopy clip through `track_monocular` from a blank map.
    Returns (result, System): Sim3-aligned ATE of `get_frame_trajectory()`
    over the tracked frames, tracked frames, loops closed and maps merged,
    ms per frame, and the frames on which a loop closed or maps merged with
    their ms."""
    device = torch.device(device)
    imgs, R_gt, t_gt, ts = frames
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "synth_loopy.yaml"
        path.write_text(loopy_settings(loop_closing))
        slam = sysm.System(None, str(path), sysm.Sensor.MONOCULAR,
                           device=device)
    frame_ms, events = [], []
    for k in range(len(imgs)):
        n_ev = slam.n_loops_closed + slam.n_maps_merged
        t0 = time.perf_counter()
        slam.track_monocular(imgs[k], float(ts[k]))
        if device.type == "cuda":
            torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if slam.n_loops_closed + slam.n_maps_merged != n_ev:
            events.append(dict(frame=k, ms=frame_ms[-1]))
    tracked = tracked_frames(slam)
    return dict(loop_closing=loop_closing, frames=len(imgs),
                n_tracked=len(tracked),
                ate_m=ate(slam, slam.get_frame_trajectory(), R_gt, t_gt),
                loops_closed=slam.n_loops_closed,
                maps_merged=slam.n_maps_merged, n_maps=slam.atlas.n_maps(),
                n_kf=int(slam.map.n_kf), events=events,
                median_frame_ms=statistics.median(frame_ms),
                mean_frame_ms=statistics.fmean(frame_ms)), slam


# ------------------------------- an in-map loop closure (phase 9b)

CORRIDOR_ROOM = 32  # landmarks each corridor keyframe sees
CORRIDOR_SETTINGS = "tests/data/synth_cam.yaml"


class CorridorFeats(NamedTuple):
    """The two fields of a frame's features that loop closing reads."""

    signs: torch.Tensor
    mask: torch.Tensor


def aliased_corridor(slam: sysm.System, n_kf: int = 18,
                     aliased_kfs=(17,), seed: int = 0) -> dict:
    """Fill `slam`'s map with the corridor of the JAX loop-closing tests
    (`tests/test_loop_closing_e2e.py`'s `_build_aliased_system`): keyframe
    k at x = 0.5 k sees a block of its own CORRIDOR_ROOM landmarks (random
    descriptors); keyframe 2 and every id in `aliased_kfs` see an exact
    rigid copy of one room, so a keyframe of `aliased_kfs` is a revisit of
    keyframe 2 that shares no landmark with it. Each keyframe gets its BoW
    row; the System is left tracking. Returns {k: CorridorFeats}."""
    dev = slam.device
    cam = slam.cam
    cap = slam.map_cfg.n_feat
    N = CORRIDOR_ROOM
    rng = np.random.default_rng(seed)

    def bits_of(n):
        return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)

    def block():
        return np.stack([rng.uniform(-1.5, 1.5, N), rng.uniform(-1.0, 1.0, N),
                         rng.uniform(4.0, 6.0, N)], axis=-1).astype(np.float32)

    def pad(a, fill=0):
        full = np.full((cap,) + a.shape[1:], fill, a.dtype)
        full[:len(a)] = a
        return full

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    room_bits, room_rel = bits_of(N), block()
    m, feats = slam.map, {}
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    fv = pad(np.ones(N, bool), False)
    for k in range(n_kf):
        c_w = np.array([0.5 * k, 0.0, 0.0])
        R = np.eye(3, dtype=np.float32)
        tw = (-R @ c_w).astype(np.float32)
        if k == 2 or k in aliased_kfs:
            bits, X = room_bits, room_rel + c_w
        else:
            bits, X = bits_of(N), block() + c_w
        X = X.astype(np.float32)
        xc = X @ R.T + tw
        uv = np.stack([cam.fx * xc[:, 0] / xc[:, 2] + cam.cx,
                       cam.fy * xc[:, 1] / xc[:, 2] + cam.cy],
                      axis=-1).astype(np.float32)
        n_lm = int(m.n_lm)
        kf_bits = t(pad(bits).view(np.int32))
        m = ms.insert_keyframe(
            m, t(R), t(tw), 0.1 * k, t(pad(uv)),
            torch.zeros(cap, dtype=torch.int32, device=dev), kf_bits, t(fv),
            t(pad(np.arange(n_lm, n_lm + N, dtype=np.int32), -1)))
        m = ms.add_landmarks(m, t(X), t(bits.view(np.int32)),
                             torch.ones(N, dtype=torch.bool, device=dev), k,
                             k, ids, k, ids)
        feats[k] = CorridorFeats(signs=desc_ops.signs_from_bits(kf_bits),
                                 mask=t(fv))
        slam.map = m
        slam._add_bow_row(k, feats[k])
    slam.state = sysm.TrackingState.OK
    slam.kf_times = [0.1 * k for k in range(n_kf)]
    return feats


def run_corridor_loop(device, mesh=None) -> Tuple[dict, sysm.System]:
    """An in-map loop closure through `System._try_close_loop` on the
    corridor with keyframes 17 and 18 re-seeing keyframe 2's room:
    keyframe 17's detection starts the temporal consistency, keyframe 18's
    is verified (Sim3), corrected (essential graph), fused across the seam
    and polished by the global BA (over `mesh`, a `parallel.mesh.Mesh`,
    when given). Returns (result, System): loops closed after each call,
    ms of each call, and the corrected centres of keyframes 2, 17 and
    18."""
    device = torch.device(device)
    slam = sysm.System(None, str(REPO / CORRIDOR_SETTINGS),
                       sysm.Sensor.MONOCULAR, mesh=mesh, device=device)
    feats = aliased_corridor(slam, n_kf=19, aliased_kfs=(17, 18))
    closed, call_ms = [], []
    for k in (17, 18):
        t0 = time.perf_counter()
        slam._try_close_loop(k, feats[k])
        if device.type == "cuda":
            torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        closed.append(slam.n_loops_closed)
    m = slam.map
    centres = {k: (-m.kf_R[k].T @ m.kf_t[k]).cpu().numpy().tolist()
               for k in (2, 17, 18)}
    return dict(loops_closed_after=closed, call_ms=call_ms,
                last_loop_kf=slam.last_loop_kf, centres=centres,
                mesh_solves=slam.n_mesh_solves,
                finite=bool(torch.isfinite(m.kf_t).all()
                            and torch.isfinite(m.lm_X).all())), slam


# ------------------------------------------ mono-inertial (phase 10)

EUROC_VI = "config/Monocular-Inertial/EuRoC.yaml"
VI_FRAMES, VI_SEED, VI_TRAJ_SCALE = 120, 0, 1.5  # 6 s at the file's 20 fps
# the JAX evaluation's EuRoC-grade IMU (`runtime/bench_eval.py:53-59`: the
# published noise densities times sqrt(200), and the bias walks), the gyro
# bias of tests/test_e2e_vi.py:33, and the IMU noise seed 5
VI_IMU_KW = dict(rate=200.0, gyro_noise=1.7e-4 * np.sqrt(200.0),
                 acc_noise=2.0e-3 * np.sqrt(200.0), gyro_walk=1.9e-5,
                 acc_walk=3.0e-3)
VI_TRUE_BG = np.array([0.01, -0.008, 0.012])
VI_IMU_SEED = 5
# tests/test_e2e_vi.py's bars (:55, :76-88), on the frames after the VI
# initialization: the gyro bias (inf-norm), tracked frames, the Umeyama
# scale and the unaligned length ratio
VI_BG_TOL, VI_MIN_POST, VI_SCALE_TOL, VI_LENGTH_TOL = 2e-2, 20, 0.10, 0.35


class BodyTrajectory:
    """The IMU body's trajectory of a camera trajectory: T_wb = T_wc T_cb,
    with T_cb the inverse of `T_b_c` (the settings' `IMU.T_b_c1`, body from
    camera). Has the `rotation(t)` and `position(t)` that
    `synthetic.make_imu` reads."""

    def __init__(self, cam_traj, T_b_c):
        self.cam_traj = cam_traj
        T = np.asarray(T_b_c, np.float64)
        self.R_cb = T[:3, :3].T
        self.t_cb = -T[:3, :3].T @ T[:3, 3]

    def rotation(self, t):
        return self.cam_traj.rotation(t) @ self.R_cb

    def position(self, t):
        return self.cam_traj.position(t) + self.cam_traj.rotation(t) @ \
            self.t_cb


def render_euroc_vi():
    """The hard room clip (the JAX evaluation's `synth_hard_vi` rows,
    `runtime/bench_eval.py:253-322`: `render_room_sequence`'s planes,
    trajectory and photometry, seed 0, trajectory scale 1.5) rendered
    directly at 600x350 through the radtan camera of
    `config/Monocular-Inertial/EuRoC.yaml` after its resize (the rays come
    from the camera model the System undistorts with), 120 frames at the
    file's 20 fps, and the IMU of the camera's body under the file's
    `IMU.T_b_c1` at 200 Hz. Returns (images, R_gt, t_gt, timestamps,
    (imu_t, gyro, acc))."""
    st = settings_mod.load_settings(str(REPO / EUROC_VI))
    images, R_gt, t_gt, ts = synthetic.render_room_sequence_kb8(
        n_frames=VI_FRAMES, cam=st.camera, fps=st.fps, seed=VI_SEED,
        traj_scale=VI_TRAJ_SCALE)
    cam_traj = synthetic.default_trajectory(seed=VI_SEED + 3,
                                            scale=VI_TRAJ_SCALE)
    imu = synthetic.make_imu(BodyTrajectory(cam_traj, st.T_b_c1), -0.02,
                             float(ts[-1]) + 0.01, gyro_bias=VI_TRUE_BG,
                             seed=VI_IMU_SEED, **VI_IMU_KW)
    return images, R_gt, t_gt, ts, imu


def imu_points(imu, t_prev: float, t_k: float) -> list:
    """The samples of `imu` = (t, gyro, acc) in (t_prev, t_k] as the
    port's `ImuPoint`s (the JAX System reads the same three fields)."""
    imu_t, gyro, acc = imu
    sel = np.where((imu_t > t_prev) & (imu_t <= t_k))[0]
    return [sysm.ImuPoint(acc[i], gyro[i], imu_t[i]) for i in sel]


def vi_metrics(slam, R_gt, t_gt, true_bg) -> dict:
    """The measures of tests/test_e2e_vi.py on `get_frame_trajectory()`
    (the JAX or the port's System): the gyro bias error, and over the
    frames tracked after the VI initialization the Umeyama scale and the
    unaligned length ratio; also the Sim3-aligned ATE over every tracked
    frame and the length error over the last third (the evaluation's
    `scale_err_end_pct`, `runtime/bench_eval.py:383-393`)."""
    traj = slam.get_frame_trajectory()
    ok = [k for k, r in enumerate(slam.tracking_log) if r["state"] == 1]
    est = np.array([-traj[k][1][:3, :3].T @ traj[k][1][:3, 3] for k in ok])
    gt = np.array([-R_gt[k].T @ t_gt[k] for k in ok])
    out = dict(imu_initialized=bool(slam.is_imu_initialized()),
               inertial_ba1=bool(slam.get_inertial_ba1()),
               inertial_ba2=bool(slam.get_inertial_ba2()),
               n_tracked=len(ok), n_kf=int(slam.map.n_kf),
               bg=[float(x) for x in np.asarray(slam.bg)],
               bg_err=float(np.abs(np.asarray(slam.bg) - true_bg).max()),
               scale_applied=float(slam.scale_applied))
    if len(ok) >= 3:
        out["ate_m"] = synthetic.ate_rmse(est, gt)
        third = len(est) // 3
        if third >= 5:
            le = np.linalg.norm(np.diff(est[-third:], axis=0), axis=1).sum()
            lg = np.linalg.norm(np.diff(gt[-third:], axis=0), axis=1).sum()
            out["scale_err_end"] = float(abs(le - lg) / lg)
    kf_times = slam.kf_times
    t_init = kf_times[min(len(kf_times) - 1, slam.VI_INIT_KFS)] \
        if kf_times else np.inf
    post = [i for i, k in enumerate(ok) if traj[k][0] >= t_init]
    out["n_post_init"] = len(post)
    if len(post) >= 3:
        e, g = est[post], gt[post]
        out["umeyama_scale"] = synthetic.umeyama_scale(e, g)
        le = np.linalg.norm(np.diff(e, axis=0), axis=1).sum()
        lg = np.linalg.norm(np.diff(g, axis=0), axis=1).sum()
        out["length_ratio"] = float(le / lg)
    return out


def vi_failures(r: dict) -> list:
    """The phase 10 bars that a result of `vi_metrics` misses."""
    failed = []
    if not (r["imu_initialized"] and r["inertial_ba1"]):
        failed.append("the IMU did not initialize")
    if r["state"] != "OK":
        failed.append(f"state {r['state']} at the end")
    if not r["bg_err"] < VI_BG_TOL:
        failed.append(f"gyro bias error {r['bg_err']}")
    if not r["n_post_init"] > VI_MIN_POST:
        failed.append(f"{r['n_post_init']} frames after the VI init")
    if not abs(r.get("umeyama_scale", np.inf) - 1.0) < VI_SCALE_TOL:
        failed.append(f"Umeyama scale {r.get('umeyama_scale')}")
    if not abs(r.get("length_ratio", np.inf) - 1.0) < VI_LENGTH_TOL:
        failed.append(f"length ratio {r.get('length_ratio')}")
    return failed


def make_vi_system(device, pipelined: bool = False) -> sysm.System:
    """`config/Monocular-Inertial/EuRoC.yaml` as published, IMU_MONOCULAR."""
    return sysm.System(None, str(REPO / EUROC_VI),
                       sysm.Sensor.IMU_MONOCULAR, pipelined=pipelined,
                       device=device)


def run_euroc_vi(device, frames=None):
    """Phase 10's clip through `track_monocular` with its IMU samples.
    Returns (result, System): the `vi_metrics`, the frame of the VI
    initialization, keyframes, ms per frame, and the preintegration
    samples that the System dropped past its per-interval cap."""
    device = torch.device(device)
    images, R_gt, t_gt, ts, imu = frames or render_euroc_vi()
    slam = make_vi_system(device)
    frame_ms, init_frame, t_prev = [], None, -1.0
    for k in range(len(images)):
        pts = imu_points(imu, t_prev, float(ts[k]))
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        slam.track_monocular(images[k], float(ts[k]), pts)
        if device.type == "cuda":
            torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if init_frame is None and slam.is_imu_initialized():
            init_frame = k
        t_prev = float(ts[k])
    r = dict(config="euroc_vi", device=str(device), frames=len(images),
             state=slam.get_tracking_state().name, vi_init_frame=init_frame,
             dropped_imu_samples=slam.dropped_imu_samples,
             **vi_metrics(slam, R_gt, t_gt, VI_TRUE_BG),
             median_frame_ms=statistics.median(frame_ms))
    r["failed_bars"] = vi_failures(r)
    return r, slam


@dataclasses.dataclass(frozen=True)
class ViRig:
    """A stereo- or RGB-D-inertial clip of the JAX e2e tests
    (tests/test_e2e_stereo_inertial.py, test_e2e_rgbd_inertial.py): 60
    frames at 320x240, 10 fps, the IMU of the same trajectory (body ==
    left camera) with a gyro bias, VI_INIT_KFS 6 as the tests set it, and
    the tests' bounds."""

    name: str
    sensor: sysm.Sensor
    settings: str  # under the repository
    render_kw: dict
    n_frames: int = 60
    bg_tol: float = 6e-3  # |bg - true| (2-norm)
    min_tracked: int = 30
    length_tol: float = 0.12
    ate_max_m: float = 0.1


VI_RIG_BG = np.array([0.008, -0.006, 0.01])
VI_RIGS = {r.name: r for r in (
    ViRig("synth_stereo_inertial", sysm.Sensor.IMU_STEREO,
          "tests/data/synth_stereo.yaml", dict(stereo_baseline=0.12)),
    ViRig("synth_rgbd_inertial", sysm.Sensor.IMU_RGBD,
          "tests/data/synth_cam.yaml", dict(return_depth=True)),
)}


def render_vi_rig(rig: ViRig):
    """(images, right images or depth maps, R_gt, t_gt, timestamps, imu)."""
    frames = synthetic.render_sequence(
        n_frames=rig.n_frames, width=320, height=240, fx=260.0, fy=260.0,
        fps=10.0, seed=2, plane_depths=(5.0, 8.0), traj_scale=1.4,
        **rig.render_kw)
    traj = synthetic.default_trajectory(seed=5, scale=1.4)
    imu = synthetic.make_imu(traj, -0.02, frames[-1][-1] + 0.01, rate=200.0,
                             gyro_noise=2e-4, acc_noise=2e-3,
                             gyro_bias=VI_RIG_BG, seed=5)
    return (*frames, imu)


def make_vi_rig_system(rig: ViRig, device) -> sysm.System:
    slam = sysm.System(None, str(REPO / rig.settings), rig.sensor,
                       device=device)
    slam.VI_INIT_KFS = 6
    return slam


def track_vi_rig(slam: sysm.System, rig: ViRig, frames, k: int):
    """Feed frame k of a rendered clip, with its IMU samples, to its entry
    point."""
    images, second, _, _, ts, imu = frames
    t_prev = float(ts[k - 1]) if k else -1.0
    pts = imu_points(imu, t_prev, float(ts[k]))
    if rig.sensor == sysm.Sensor.IMU_RGBD:
        return slam.track_rgbd(images[k], second[k], float(ts[k]), pts)
    return slam.track_stereo(images[k], second[k], float(ts[k]), pts)


def vi_rig_metrics(slam: sysm.System, rig: ViRig, R_gt, t_gt) -> dict:
    """The tests' measures on `get_frame_trajectory()` over the frames
    tracked OK: the gyro bias error, tracked frames, the unaligned length
    ratio and the Sim3-aligned ATE; and the bars missed. Also, on the
    online `get_trajectory()`, the length ratio of the frame-to-frame
    steps into frames that inserted a keyframe and into the others (where
    the length's excess comes from)."""
    traj = slam.get_frame_trajectory()
    ok = tracked_frames(slam)
    est = np.array([-traj[k][1][:3, :3].T @ traj[k][1][:3, 3] for k in ok])
    gt = np.array([-R_gt[k].T @ t_gt[k] for k in ok])
    r = dict(config=rig.name, state=slam.get_tracking_state().name,
             imu_initialized=bool(slam.is_imu_initialized()),
             n_kf=int(slam.map.n_kf), n_tracked=len(ok),
             bg_err=float(np.linalg.norm(np.asarray(slam.bg) - VI_RIG_BG)))
    if len(ok) >= 3:
        le = np.linalg.norm(np.diff(est, axis=0), axis=1).sum()
        lg = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
        r.update(length_ratio=float(le / lg),
                 ate_m=synthetic.ate_rmse(est, gt))
        online = slam.get_trajectory()
        c = np.array([-T[:3, :3].T @ T[:3, 3] for _, T in online])
        g = np.array([-R_gt[k].T @ t_gt[k] for k in range(len(online))])
        step_e = np.linalg.norm(np.diff(c, axis=0), axis=1)
        step_g = np.linalg.norm(np.diff(g, axis=0), axis=1)
        kf_t = {round(t, 9) for t in slam.kf_times}
        at_kf = np.array([round(t, 9) in kf_t for t, _ in online[1:]])
        r.update(online_length_ratio=float(step_e.sum() / step_g.sum()),
                 keyframe_step_ratio=float(step_e[at_kf].sum()
                                           / step_g[at_kf].sum()),
                 other_step_ratio=float(step_e[~at_kf].sum()
                                        / step_g[~at_kf].sum()))
    failed = []
    if r["state"] != "OK" or not r["imu_initialized"]:
        failed.append(f"state {r['state']}, IMU initialized "
                      f"{r['imu_initialized']}")
    if not r["bg_err"] < rig.bg_tol:
        failed.append(f"gyro bias error {r['bg_err']}")
    if not r["n_tracked"] > rig.min_tracked:
        failed.append(f"{r['n_tracked']} tracked")
    if not abs(r.get("length_ratio", np.inf) - 1.0) < rig.length_tol:
        failed.append(f"length ratio {r.get('length_ratio')}")
    if not r.get("ate_m", np.inf) < rig.ate_max_m:
        failed.append(f"ATE {r.get('ate_m')}")
    r["failed_bars"] = failed
    return r


def run_vi_rigs(device, cpu_inputs: bool = False):
    """Phase 10b's clips through the System; with `cpu_inputs`, every
    image's features are extracted on the CPU (`extract_on_cpu`). Yields
    one `vi_rig_metrics` dict per clip."""
    for name, rig in VI_RIGS.items():
        frames = render_vi_rig(rig)
        slam = make_vi_rig_system(rig, device)
        if cpu_inputs:
            extract_on_cpu(slam)
        for k in range(rig.n_frames):
            track_vi_rig(slam, rig, frames, k)
        r = vi_rig_metrics(slam, rig, frames[2], frames[3])
        r.update(device=str(device), cpu_inputs=cpu_inputs)
        yield r


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


def features_to(f: ex.Features, device) -> ex.Features:
    return dataclasses.replace(f, **{
        fl.name: getattr(f, fl.name).to(device)
        for fl in dataclasses.fields(f)})


def extract_on_cpu(slam: sysm.System) -> None:
    """Extract `slam`'s features (every image it takes) on the CPU and move
    them to its device."""
    extract = ex.make_extractor(slam.ex_cfg)
    slam._extract = lambda img: features_to(extract(img.cpu()), slam.device)


def patch_inputs(slam: sysm.System, cpu_inputs: bool, init_offset: int):
    """Shift every initialization attempt's seed by `init_offset`; with
    `cpu_inputs`, route `slam`'s extraction (`extract_on_cpu`) and the
    initializer's sampling through the CPU. Returns the function that undoes
    the module-level patch."""
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
        extract_on_cpu(slam)
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
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--cpu-inputs", action="store_true")
    ap.add_argument("--init-offsets", type=int, nargs="+", default=[0])
    ap.add_argument("--config", default="euroc_mono",
                    choices=["euroc_mono", *RIGS, "euroc_reloc",
                             "synth_loopy", "euroc_vi", "vi_rigs"])
    args = ap.parse_args(argv)
    cuda = torch.device(args.device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        ap.error("no CUDA device is available; pass --device cpu to run on "
                 "the CPU")
    if args.config != "euroc_mono":
        if args.profile or args.init_offsets != [0]:
            ap.error("--profile and --init-offsets apply to euroc_mono only")
        if args.cpu_inputs and args.config != "vi_rigs":
            ap.error("--cpu-inputs applies to euroc_mono and vi_rigs only")
        if args.config == "euroc_reloc":
            r = run_reloc(args.device)
            r["failed_bars"] = reloc_failures(r)
            print(json.dumps(r))
        elif args.config == "synth_loopy":
            frames = render_loopy()
            for on in (True, False):
                print(json.dumps(run_loopy(args.device, frames, on)[0]))
        elif args.config == "euroc_vi":
            print(json.dumps(run_euroc_vi(args.device)[0]))
        elif args.config == "vi_rigs":
            for r in run_vi_rigs(args.device, args.cpu_inputs):
                print(json.dumps(r), flush=True)
        else:
            print(json.dumps(run_rig(args.config, args.device)))
        return
    if args.profile and not cuda:
        ap.error("--profile traces a CUDA device")
    for k in args.init_offsets:
        print(json.dumps(run(args.device, args.profile, args.cpu_inputs, k)))


if __name__ == "__main__":
    main()
