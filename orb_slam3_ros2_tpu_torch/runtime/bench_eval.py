"""Synthetic-sequence ATE evaluation cases (shared by scripts/eval_ate.py
and tests).

The container has zero network egress (see EVAL.md), so the real-data bar
(EuRoC MH01-MH05, BASELINE.md) cannot be *measured* here; this module is
the strongest stand-in that is runnable: rendered sequences with realistic
image formation (`io/synthetic.render_room_sequence` — oblique surfaces,
vignetting, exposure drift, sensor noise, 8-bit quantization) and
EuRoC-grade IMU noise/bias random walk, with exact groundtruth.

Port of `orb_slam3_ros2_tpu/runtime/bench_eval.py` over the port's `System`
and renderer: the same three cases and rows. Each case takes
`case["device"]` (default None: the card; "cpu" only when asked). The JAX
fisheye case imports its camera and settings from
`tests/test_e2e_fisheye.py`; this module carries its own copies
(`KB8`, `_KB8_SETTINGS`, `_KB8_STEREO_BLOCK`), since the package imports
nothing from `tests/`. The leave-and-return trajectory is the one the
port's `io/synthetic.py` already holds.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np

from orb_slam3_ros2_tpu_torch.io.synthetic import _loop_trajectory

_SETTINGS_TMPL = """%YAML:1.0

File.version: "1.0"

Camera.type: "Rectified"

Camera1.fx: {fx}
Camera1.fy: {fy}
Camera1.cx: {cx}
Camera1.cy: {cy}

Camera.width: {width}
Camera.height: {height}

Camera.fps: {fps}
Camera.RGB: 1

Stereo.b: {baseline}

ORBextractor.nFeatures: {n_features}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: {n_levels}
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7

IMU.NoiseGyro: 1.7e-4
IMU.NoiseAcc: 2.0e-3
IMU.GyroWalk: 1.9e-5
IMU.AccWalk: 3.0e-3
IMU.Frequency: 200.0
"""

# EuRoC-grade per-sample IMU sigmas at 200 Hz (density * sqrt(rate))
IMU_KW = dict(
    rate=200.0,
    gyro_noise=1.7e-4 * np.sqrt(200.0),
    acc_noise=2.0e-3 * np.sqrt(200.0),
    gyro_walk=1.9e-5,
    acc_walk=3.0e-3,
)


def _write_settings(tmpdir, width, height, fx, fy, fps, baseline,
                    n_features=1000, n_levels=8):
    path = os.path.join(tmpdir, "synth_eval.yaml")
    with open(path, "w") as f:
        f.write(_SETTINGS_TMPL.format(
            fx=fx, fy=fy, cx=width / 2.0, cy=height / 2.0, width=width,
            height=height, fps=fps, baseline=baseline,
            n_features=n_features, n_levels=n_levels))
    return path


# the mild KB8 fisheye of `tests/test_e2e_fisheye.py` (320x240; the case
# doubles it), its settings template and stereo block
KB8 = dict(fx=140.0, fy=140.0, cx=160.0, cy=120.0,
           k1=0.0035, k2=0.0007, k3=-0.002, k4=0.0002)
KB8_W, KB8_H = 320, 240

_KB8_SETTINGS = """%YAML:1.0
File.version: "1.0"
Camera.type: "KannalaBrandt8"
Camera1.fx: {fx}
Camera1.fy: {fy}
Camera1.cx: {cx}
Camera1.cy: {cy}
Camera1.k1: {k1}
Camera1.k2: {k2}
Camera1.k3: {k3}
Camera1.k4: {k4}
Camera.width: {w}
Camera.height: {h}
Camera.fps: 10.0
Camera.RGB: 1
{stereo}
ORBextractor.nFeatures: 600
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 12
ORBextractor.minThFAST: 5
"""

_KB8_STEREO_BLOCK = """Camera2.fx: {fx}
Camera2.fy: {fy}
Camera2.cx: {cx}
Camera2.cy: {cy}
Camera2.k1: {k1}
Camera2.k2: {k2}
Camera2.k3: {k3}
Camera2.k4: {k4}
Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [1.0, 0.0, 0.0, {b}, 0.0, 1.0, 0.0, 0.0,
         0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]
Stereo.ThDepth: 40.0
"""


def _tracked_centres(sys_, traj, R_gt, t_gt):
    """Camera centres of `traj` and of the ground truth over the frames
    tracked OK."""
    est, gt = [], []
    for k, (t, T) in enumerate(traj):
        if sys_.tracking_log[k]["state"] != 1:
            continue
        est.append(-T[:3, :3].T @ T[:3, 3])
        gt.append(-R_gt[k].T @ t_gt[k])
    return np.asarray(est), np.asarray(gt)


def run_fisheye_stereo_case(case: dict) -> dict:
    """KB8 fisheye stereo row (the TUM-VI stereo configuration shape,
    `config/Stereo/TUM-VI.yaml:8,17-32`): rendered through
    the same KannalaBrandt8 model the engine undistorts with, tracked via
    the general two-view rig, scored on ATE + unaligned metric scale."""
    from orb_slam3_ros2_tpu_torch.io import synthetic
    from orb_slam3_ros2_tpu_torch.models import cameras as cam_mod
    from orb_slam3_ros2_tpu_torch.runtime.system import Sensor, System

    n = case.get("n_frames", 36)
    baseline = 0.11
    # 640x480 — nearer the reference TUM-VI 512x512 rig than the CI-sized
    # 320x240 test camera. The metric-scale bias is quantization-driven
    # and halves with resolution (tests/test_e2e_fisheye.py measurements:
    # 4.6% @ 320x240 -> 2.2% @ 640x480 on the 22-frame scenario).
    kb = {k: (v * 2.0 if k in ("fx", "fy", "cx", "cy") else v)
          for k, v in KB8.items()}
    W, H = KB8_W * 2, KB8_H * 2
    cam = cam_mod.make_camera(
        "KannalaBrandt8", kb["fx"], kb["fy"], kb["cx"], kb["cy"],
        dist=(kb["k1"], kb["k2"], kb["k3"], kb["k4"]), width=W, height=H)
    images, images_r, R_gt, t_gt, ts = synthetic.render_room_sequence_kb8(
        n_frames=n, cam=cam, fps=10.0, seed=case.get("seed", 4),
        traj_scale=0.8, noise_dn=2.0, stereo_baseline=baseline)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        stereo = _KB8_STEREO_BLOCK.format(b=baseline, **kb)
        spath = os.path.join(td, "kb8.yaml")
        with open(spath, "w") as f:
            f.write(_KB8_SETTINGS.format(w=W, h=H, stereo=stereo, **kb))
        sys_ = System(None, spath, Sensor.STEREO,
                      device=case.get("device"))
        for k in range(n):
            sys_.track_stereo(images[k], images_r[k], float(ts[k]))
        est, gt = _tracked_centres(sys_, sys_.get_trajectory(), R_gt, t_gt)
    wall = time.perf_counter() - t0
    ate = synthetic.ate_rmse(est, gt)
    # motion-weighted metric-scale error: |1 - Umeyama Sim3 scale| — the
    # r4-committed per-chunk length ratio swung 1.2-18% between identical
    # reruns (near-zero-motion chunks dominated it); the Umeyama scale is
    # dominated by the trajectory's spatial extent and is reproducible
    s_uma = synthetic.umeyama_scale(est, gt)
    return {"sequence": case["name"], "mode": "fisheye_stereo(KB8 640x480)",
            "ate_rmse_m": round(float(ate), 4), "kf_ate_rmse_m": None,
            "tracked_frames": int(len(est)), "frames": int(n),
            "wall_s": round(wall, 1), "fps": round(n / wall, 1),
            "scale_err_pct": round(100 * abs(s_uma - 1.0), 1),
            "status": "ok"}


def run_loop_closure_case(case: dict) -> dict:
    """Loop-closure case (r4 verdict item 4): a leave-and-return
    trajectory whose revisit breaks covisibility. Runs the sequence with
    loop closing ON and OFF and reports both ATEs — the ON run must close
    >= 1 loop and beat the OFF run's accumulated drift."""
    from orb_slam3_ros2_tpu_torch.io import synthetic
    from orb_slam3_ros2_tpu_torch.runtime.system import Sensor, System

    n = case.get("n_frames", 280)
    fps = 10.0
    W, H = case.get("width", 640), case.get("height", 480)
    traj = _loop_trajectory(n, fps)
    images, R_gt, t_gt, ts = synthetic.render_room_sequence(
        n_frames=n, width=W, height=H, fx=450.0, fy=450.0, fps=fps,
        seed=case.get("seed", 3), traj=traj)

    def run(loop_on: bool):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as td:
            settings = _write_settings(td, W, H, 450.0, 450.0, fps, 0.0)
            sys_ = System(None, settings, Sensor.MONOCULAR,
                          device=case.get("device"))
            sys_.settings.loop_closing = bool(loop_on)
            for k in range(n):
                sys_.track_monocular(images[k], float(ts[k]))
            wall = time.perf_counter() - t0
            est, gt = _tracked_centres(sys_, sys_.get_frame_trajectory(),
                                       R_gt, t_gt)
            return (float(synthetic.ate_rmse(est, gt)), len(est),
                    int(sys_.n_loops_closed + sys_.n_maps_merged), wall)

    ate_on, n_on, loops, wall = run(True)
    ate_off, _, _, _ = run(False)
    return {"sequence": case["name"], "mode": "mono+loop",
            "ate_rmse_m": round(ate_on, 4),
            "kf_ate_rmse_m": None,
            "tracked_frames": int(n_on), "frames": int(n),
            "wall_s": round(wall, 1), "fps": round(n / wall, 1),
            "loops_closed": int(loops),
            "ate_loop_off_m": round(ate_off, 4),
            "note": ("leave-and-return trajectory: the 360-deg excursion "
                     "breaks covisibility with the early map, so the "
                     "revisit must be re-anchored by the loop detector "
                     "(BoW candidate -> Sim3 -> essential-graph "
                     "correction -> GBA); ate_loop_off_m is the same "
                     "sequence with the fork's loopClosing switch off"),
            "status": "ok"}


def run_synthetic_case(case: dict) -> dict:
    """Run one synthetic benchmark case end to end and return the ATE row.

    case keys: name, mode ('mono'|'vi'|'stereo'), n_frames, hard (bool),
    optional: seed, width, height, fx, fps, n_features, n_levels, device.
    """
    return run_synthetic_case_system(case)[0]


def run_synthetic_case_system(case: dict):
    """`run_synthetic_case`, returning (row, the System after the run), so
    that a caller can read the System's state (`imu_initialized`)."""
    from orb_slam3_ros2_tpu_torch.io import synthetic
    from orb_slam3_ros2_tpu_torch.runtime.system import (
        ImuPoint, Sensor, System,
    )

    name = case["name"]
    mode = case["mode"]
    n_frames = case.get("n_frames", 120)
    hard = case.get("hard", True)
    seed = case.get("seed", 0)
    width = case.get("width", 640)
    height = case.get("height", 480)
    fx = fy = case.get("fx", 450.0)
    fps = case.get("fps", 20.0)
    baseline = 0.1 if mode == "stereo" else 0.0
    traj_scale = case.get("traj_scale", 1.5)

    render = (synthetic.render_room_sequence if hard
              else synthetic.render_sequence)
    kw = dict(n_frames=n_frames, width=width, height=height, fx=fx, fy=fy,
              fps=fps, seed=seed, stereo_baseline=baseline)
    if hard:
        kw["traj_scale"] = traj_scale
    else:
        kw["traj_scale"] = traj_scale
    out = render(**kw)
    if baseline > 0:
        images, images_r, R_gt, t_gt, ts = out
    else:
        images, R_gt, t_gt, ts = out
        images_r = None

    imu = None
    if mode == "vi":
        traj = synthetic.default_trajectory(seed=seed + 3, scale=traj_scale)
        true_bg = np.array([0.01, -0.008, 0.012])
        imu_t, gyro, acc = synthetic.make_imu(
            traj, -0.02, float(ts[-1]) + 0.01, gyro_bias=true_bg,
            seed=seed + 5, **IMU_KW)
        imu = (imu_t, gyro, acc)

    sensor = {"mono": Sensor.MONOCULAR, "vi": Sensor.IMU_MONOCULAR,
              "stereo": Sensor.STEREO}[mode]
    with tempfile.TemporaryDirectory() as td:
        settings = _write_settings(
            td, width, height, fx, fy, fps, baseline,
            n_features=case.get("n_features", 1000),
            n_levels=case.get("n_levels", 8))
        sys_ = System(None, settings, sensor=sensor,
                      device=case.get("device"))
        if mode == "vi":
            sys_.VI_INIT_KFS = 6

        t0 = time.perf_counter()
        t_prev = -1.0
        frame_s = np.zeros(n_frames)
        for k in range(n_frames):
            tf = time.perf_counter()
            pts = []
            if imu is not None:
                imu_t, gyro, acc = imu
                sel = (imu_t > t_prev) & (imu_t <= ts[k])
                pts = [ImuPoint(acc[i], gyro[i], imu_t[i])
                       for i in np.where(sel)[0]]
            if mode == "stereo":
                sys_.track_stereo(images[k], images_r[k], float(ts[k]), pts)
            else:
                sys_.track_monocular(images[k], float(ts[k]), pts)
            t_prev = float(ts[k])
            frame_s[k] = time.perf_counter() - tf
        wall = time.perf_counter() - t0
        # steady-state System fps: median per-frame wall time over the
        # second half of the run — compiles and warm-up amortized out
        # (r2 verdict item 7: the full host loop's rate, vs the
        # device-resident bench number); also the tail percentiles, since
        # a live ingest drops frames on latency SPIKES, not on the median
        tail_ms = frame_s[n_frames // 2:] * 1e3
        steady = float(np.median(frame_s[n_frames // 2:]))

        # retroactively-corrected frame trajectory (reference-KF-relative,
        # upstream SaveTrajectoryTUM semantics): frames tracked BEFORE a
        # BA / loop / VI-scale correction inherit it — without this the
        # pre-VI-init prefix sits at a different scale than the rest and
        # one Sim3 alignment cannot serve both (measured: hard-VI ATE
        # 0.33 raw-online vs 0.03-level corrected)
        est, gt = _tracked_centres(sys_, sys_.get_frame_trajectory(), R_gt,
                                   t_gt)
        # keyframe-trajectory ATE (upstream SaveKeyFrameTrajectoryTUM — the
        # other standard evaluation surface; keyframes carry every
        # retroactive BA correction directly)
        kf_est, kf_gt = [], []
        for t, T in sys_.get_keyframe_trajectory():
            k = int(np.argmin(np.abs(ts - t)))
            kf_est.append(-T[:3, :3].T @ T[:3, 3])
            kf_gt.append(-R_gt[k].T @ t_gt[k])
        kf_est, kf_gt = np.asarray(kf_est), np.asarray(kf_gt)

    if len(est) < 10:
        return {"sequence": name, "mode": mode, "ate_rmse_m": None,
                "tracked_frames": int(len(est)), "frames": int(n_frames),
                "status": "tracking failed"}, sys_
    ate = synthetic.ate_rmse(est, gt)
    row = {"sequence": name, "mode": mode, "ate_rmse_m": round(ate, 4),
           "kf_ate_rmse_m": (round(synthetic.ate_rmse(kf_est, kf_gt), 4)
                             if len(kf_est) >= 4 else None),
           "tracked_frames": int(len(est)), "frames": int(n_frames),
           "wall_s": round(wall, 1), "fps": round(n_frames / wall, 1),
           "fps_steady": round(1.0 / max(steady, 1e-9), 1),
           "frame_ms_p95": round(float(np.percentile(tail_ms, 95)), 1),
           "frame_ms_max": round(float(tail_ms.max()), 1),
           "frames_over_33ms": int((tail_ms > 33.0).sum()),
           "status": "ok"}
    if mode != "mono":
        # metric-scale check: trajectory length ratio without Sim3 scale
        len_est = float(np.linalg.norm(np.diff(est, axis=0), axis=1).sum())
        len_gt = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
        if len_gt > 0:
            row["scale_err_pct"] = round(
                100.0 * abs(len_est - len_gt) / len_gt, 1)
        # scale AT SEQUENCE END (last third): the VI convergence loop keeps
        # refining until observability accrues, so the steady-state scale
        # is the shippable number; the whole-trajectory column above keeps
        # charging the pre-convergence prefix forever
        third = len(est) // 3
        if third >= 5:
            le = float(np.linalg.norm(
                np.diff(est[-third:], axis=0), axis=1).sum())
            lg = float(np.linalg.norm(
                np.diff(gt[-third:], axis=0), axis=1).sum())
            if lg > 1e-9:
                row["scale_err_end_pct"] = round(
                    100.0 * abs(le - lg) / lg, 1)
    return row, sys_
