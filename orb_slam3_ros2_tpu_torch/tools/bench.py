"""Benchmark of the port on the card: tracking frames/s, bundle-adjustment
iterations/s and the pipelined System's steady frames/s, monocular and
mono-inertial.

    python -m orb_slam3_ros2_tpu_torch.tools.bench
        [--only tracking|ba|system|system_vi] [--device cuda|cpu]

Port of `bench.py` over the port's modules: the same four numbers, sizes,
seeds and JSON keys. It prints one JSON line, `{"metric":
"tracking_fps_per_chip", "value", "unit", "vs_baseline", "extra"}`, whose
`extra` holds `ba_iters_per_s_per_chip`, `system_fps_steady`,
`system_fps_detail`, `system_fps_steady_vi` and `system_fps_vi_detail` as
`bench.py`'s does, plus the card's `name` and `power.limit` (as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
them) and the per-repeat times behind the two slopes
(`tracking_repeat_s`, `ba_repeat_s`). Numbers are not rounded.

- `tracking_fps_per_chip` (`_bench_tracking`): 752x480 noise frames, 1000
  features over 8 levels, `extract` -> `match_to_map` (every one of the
  8192 landmark slots, 4096 of them set from `default_rng(0)`) ->
  `track_pose`, the pose chained frame to frame on the device with no
  host sync inside a batch; the time a frame is the slope
  (T(256) - T(32)) / 224, each T the best of 3 runs that end in one
  synchronize. `bench.py` runs the batch as one compiled `lax.scan`;
  here a Python loop launches each frame's work, so the slope includes
  the host's launch time, which is what the port pays. The match kernel
  launches once a frame (this is not `track_frame`).
- `ba_iters_per_s_per_chip` (`_bench_ba_iters`): `make_scene(64 frames,
  512 points, seed 1)` tiled to 8192 landmarks, keyframe 0 fixed,
  `backend/ba.bundle_adjust`; the slope between 10 and 30 iterations,
  each the best of 3.
- `system_fps_steady` / `_vi` (`_bench_system_fps_steady` / `_vi`):
  `System(pipelined=True)` at 640x480 with 1250 features over
  `render_sequence(seed=1)`, 100 frames (mono-inertial: 180 frames, a
  200 Hz IMU from `make_imu(seed=5)`, `VI_INIT_KFS = 6`); the median
  host-clock time of a `track_monocular` call over the second half, with
  p50 / p95 / max, the calls over 33 ms, and the `summary_fetch` /
  `mapping_fused` stage medians from the System's tracer.

`--only` runs one part; the others' numbers are then null. Every size is
a keyword of its function (the tests run them small on the CPU);
`--device cpu` runs the published sizes on the CPU, which no measurement
uses. Without a card the default device stops the run with an error.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod
from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
from orb_slam3_ros2_tpu_torch.frontend import tracking as trk
from orb_slam3_ros2_tpu_torch.io import synthetic
from orb_slam3_ros2_tpu_torch.tools.cli import add_device, device_of, sync
from orb_slam3_ros2_tpu_torch.tools.roofline import card

PARTS = ("tracking", "ba", "system", "system_vi")

# the EuRoC-like mono configuration of `bench.py`'s tracking loop
HEIGHT, WIDTH = 480, 752
FX, FY, CX, CY = 458.654, 457.296, 367.215, 248.375
N_LANDMARKS = 4096
B_SMALL, B_LARGE = 32, 256  # slope endpoints
REPEATS = 3
BA_ITERS = (10, 30)
LIVE_BUDGET_MS = 33.0  # a frame of the 30 frames/s live camera


# ------------------------------------------------------------ tracking

def tracking_map(rng, cfg: ex.ExtractorConfig, device,
                 n_landmarks: int = N_LANDMARKS, max_kf: int = 64,
                 max_lm: int = 8192) -> ms.MapState:
    """`bench.py`'s map: `n_landmarks` valid slots with X uniform in
    [-4, 4] x [-3, 3] x [4, 10] and uniform random bits, drawn from `rng`
    in that order."""
    m = ms.empty_map(ms.MapConfig(max_kf=max_kf, max_lm=max_lm,
                                  n_feat=ex.total_capacity(cfg)),
                     device=device)
    L = n_landmarks
    X = np.stack([rng.uniform(-4, 4, L), rng.uniform(-3, 3, L),
                  rng.uniform(4, 10, L)], axis=-1).astype(np.float32)
    bits = rng.integers(0, 2**32, (L, 8), dtype=np.uint32).view(np.int32)
    lm_X, lm_valid, lm_bits = (m.lm_X.clone(), m.lm_valid.clone(),
                               m.lm_bits.clone())
    lm_X[:L] = torch.from_numpy(X).to(device)
    lm_valid[:L] = True
    lm_bits[:L] = torch.from_numpy(bits).to(device)
    return m._replace(lm_X=lm_X, lm_valid=lm_valid, lm_bits=lm_bits)


def noise_frames(rng, n: int, height: int, width: int, device):
    """n frames of uniform noise in [0, 255), f32, on `device`."""
    return torch.from_numpy(
        rng.uniform(0, 255, (n, height, width)).astype(np.float32)).to(device)


def track_step(extract, m: ms.MapState, img, R, t, cam):
    """One step of `bench.py`'s `track_batch` scan: extract, match every
    landmark slot at 15 px from (R, t), pose LM from (R, t). `cam` is
    (fx, fy, cx, cy, width, height). Returns (R, t, n_inliers) as device
    tensors."""
    fx, fy, cx, cy, width, height = cam
    f = extract(img)
    tm = trk.match_to_map(m, f.uv, f.bits, f.mask, R, t, fx, fy, cx, cy,
                          width, height)
    res, _ = trk.track_pose(m, tm.obs_lm, f.uv, f.level, R, t, fx, fy, cx,
                            cy)
    return res.R, res.t, res.n_inliers


def track_batch(extract, m: ms.MapState, frames, R0, t0, cam):
    """The frames in order, the pose chained from each to the next on the
    device. Returns (R, t, n_inliers (B,))."""
    R, t, n = R0, t0, []
    for img in frames:
        R, t, k = track_step(extract, m, img, R, t, cam)
        n.append(k)
    return R, t, torch.stack(n)


def _bench_tracking(device, height: int = HEIGHT, width: int = WIDTH,
                    n_features: int = 1000, n_levels: int = 8,
                    n_landmarks: int = N_LANDMARKS,
                    batches=(B_SMALL, B_LARGE), repeats: int = REPEATS):
    """Tracking frames/s from the batch-size slope. Returns (fps, detail):
    detail["repeat_s"] maps each batch size to its runs' seconds and
    detail["frames"] counts every frame tracked (warm-up runs included)."""
    scale = width / WIDTH
    cam = (FX * scale, FY * scale, CX * scale, CY * scale, width, height)
    cfg = ex.ExtractorConfig(n_features=n_features, n_levels=n_levels,
                             height=height, width=width)
    extract = ex.make_extractor(cfg)
    rng = np.random.default_rng(0)
    m = tracking_map(rng, cfg, device, n_landmarks)
    R0 = torch.eye(3, device=device)
    t0 = torch.zeros(3, device=device)
    times, frames = {}, 0
    for nb in batches:
        fr = noise_frames(rng, nb, height, width, device)
        track_batch(extract, m, fr, R0, t0, cam)  # warm-up
        sync(device)
        fr = noise_frames(rng, nb, height, width, device)
        frames += nb * (1 + repeats)
        runs = []
        for _ in range(repeats):
            t_start = time.perf_counter()
            track_batch(extract, m, fr, R0, t0, cam)
            sync(device)
            runs.append(time.perf_counter() - t_start)
            fr = fr + 0.001  # a new buffer each run, as bench.py
        times[nb] = runs
    small, large = batches
    dt = (min(times[large]) - min(times[small])) / (large - small)
    return 1.0 / dt, {"repeat_s": {str(k): v for k, v in times.items()},
                      "frames": frames}


# ------------------------------------------------------------------- BA

def ba_problem(device, K: int = 64, L: int = 8192) -> ba_mod.BAProblem:
    """`bench.py`'s BA problem: `make_scene(K frames, 512 points, noise
    0.5 px, seed 1)` tiled to L landmarks with N(0, 0.05) added to the
    points, then N(0, 0.02) to the translations (`default_rng(0)`, in that
    order); keyframe 0 fixed."""
    fx = fy = 458.0
    cx, cy = 367.0, 248.0
    rng = np.random.default_rng(0)
    sc = synthetic.make_scene(n_frames=K, n_points=512, noise_px=0.5, seed=1,
                              fx=fx, fy=fy, cx=cx, cy=cy)
    reps = L // 512
    X = np.tile(sc.X, (reps, 1)) + rng.normal(0, 0.05, (L, 3))
    uv = np.tile(sc.uv, (1, reps, 1))
    w = np.tile(sc.vis, (1, reps)).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    t = sc.t_cw + rng.normal(0, 0.02, (K, 3))

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return ba_mod.BAProblem(
        R=f32(sc.R_cw), t=f32(t), X=f32(X), uv=f32(uv), w=f32(w),
        fixed=torch.from_numpy(fixed).to(device),
        point_valid=torch.ones(L, dtype=torch.bool, device=device))


BA_CAMERA = (458.0, 458.0, 367.0, 248.0)


def _bench_ba_iters(device, K: int = 64, L: int = 8192, iters=BA_ITERS,
                    repeats: int = REPEATS):
    """BA iterations/s from the slope over the iteration count. Returns
    (iterations/s, {"repeat_s": each count's runs in seconds})."""
    problem = ba_problem(device, K, L)
    times = {}
    for n_iters in iters:
        ba_mod.bundle_adjust(problem, *BA_CAMERA, n_iters=n_iters)  # warm
        sync(device)
        runs = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            ba_mod.bundle_adjust(problem, *BA_CAMERA, n_iters=n_iters)
            sync(device)
            runs.append(time.perf_counter() - t0)
        times[n_iters] = runs
    lo, hi = iters
    dt_iter = (min(times[hi]) - min(times[lo])) / (hi - lo)
    return 1.0 / dt_iter, {"repeat_s": {str(k): v for k, v in times.items()}}


# --------------------------------------------------------------- System

_IMU_SETTINGS = ("IMU.NoiseGyro: 1.7e-4\nIMU.NoiseAcc: 2.0e-3\n"
                 "IMU.GyroWalk: 1.9e-5\nIMU.AccWalk: 3.0e-3\n"
                 "IMU.Frequency: 200.0\n")


def settings_text(width: int = 640, height: int = 480, fx: float = 520.0,
                  n_features: int = 1250, imu: bool = False) -> str:
    """`bench.py`'s settings templates (the D435i live configuration); at
    the default sizes the same text."""
    text = (
        '%YAML:1.0\nFile.version: "1.0"\nCamera.type: "Rectified"\n'
        f"Camera1.fx: {fx}\nCamera1.fy: {fx}\n"
        f"Camera1.cx: {width / 2}\nCamera1.cy: {height / 2}\n"
        f"Camera.width: {width}\nCamera.height: {height}\n"
        "Camera.fps: 30.0\n"
        f"Camera.RGB: 1\nORBextractor.nFeatures: {n_features}\n"
        "ORBextractor.scaleFactor: 1.2\nORBextractor.nLevels: 8\n"
        "ORBextractor.iniThFAST: 20\nORBextractor.minThFAST: 7\n")
    return text + _IMU_SETTINGS if imu else text


def _system(settings: str, sensor, device):
    from orb_slam3_ros2_tpu_torch.runtime.system import System

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "bench_sys.yaml")
        with open(path, "w") as f:
            f.write(settings)
        return System(None, path, sensor, pipelined=True, device=device)


def _median_ms(samples) -> float | None:
    return float(np.median(samples)) * 1e3 if samples else None


def _tail(frame_s: np.ndarray) -> dict:
    tail = frame_s[frame_s.size // 2:] * 1e3
    return {"frame_ms_p50": float(np.percentile(tail, 50)),
            "frame_ms_p95": float(np.percentile(tail, 95)),
            "frame_ms_max": float(tail.max()),
            "frames_over_33ms": int((tail > LIVE_BUDGET_MS).sum()),
            "frames_measured": int(tail.size)}


def _bench_system_fps_steady(device, n: int = 100, width: int = 640,
                             height: int = 480, fx: float = 520.0,
                             n_features: int = 1250):
    """Steady frames/s of `System(pipelined=True)` in MONOCULAR at the
    reference live configuration: the median host-clock time of a
    `track_monocular` call (no synchronize: the pipelined mode consumes
    each frame one call later) over the second half of the run. Returns
    (fps, detail with `bench.py`'s keys)."""
    from orb_slam3_ros2_tpu_torch.runtime.system import Sensor

    images, _, _, ts = synthetic.render_sequence(
        n_frames=n, width=width, height=height, fx=fx, fy=fx, fps=30.0,
        seed=1, traj_scale=1.0)
    sys_ = _system(settings_text(width, height, fx, n_features),
                   Sensor.MONOCULAR, device)
    frame_s = np.zeros(n)
    for k in range(n):
        t0 = time.perf_counter()
        sys_.track_monocular(images[k], float(ts[k]))
        frame_s[k] = time.perf_counter() - t0
    fetch = sys_.tracer._samples.get("summary_fetch", [])
    kf = sys_.tracer._samples.get("mapping_fused", [])
    steady = float(np.median(frame_s[n // 2:]))
    extra = {
        "config": f"{width}x{height} / {n_features} feats / 8 levels "
                  "(reference D435i live config), pipelined mode",
        "summary_fetch_ms_median": _median_ms(fetch),
        "mapping_fused_ms_median": _median_ms(kf),
        "keyframes": int(sys_.map.n_kf),
        "blocking_turnarounds_per_frame": len(kf) / n,
        **_tail(frame_s),
        "note": "each call dispatches its frame with no host sync and "
                "consumes the previous one; the keyframe summaries "
                "(count above) are read one call after their dispatch; "
                "latency percentiles are over the second half of the run "
                "(host clock, no synchronize)",
    }
    return 1.0 / max(steady, 1e-9), extra


def _bench_system_fps_steady_vi(device, n: int = 180, width: int = 640,
                                height: int = 480, fx: float = 520.0,
                                n_features: int = 1250):
    """Steady frames/s of `System(pipelined=True)` in IMU_MONOCULAR at the
    reference live configuration with a 200 Hz IMU (the pipelined path
    engages once the IMU is initialized). Returns (fps, detail with
    `bench.py`'s keys)."""
    from orb_slam3_ros2_tpu_torch.runtime.system import ImuPoint, Sensor

    images, _, _, ts = synthetic.render_sequence(
        n_frames=n, width=width, height=height, fx=fx, fy=fx, fps=30.0,
        seed=1, traj_scale=1.2)
    # render_sequence(seed=s) flies default_trajectory(s + 3); the IMU
    # rides the same trajectory
    traj = synthetic.default_trajectory(seed=4, scale=1.2)
    imu_t, gyro, acc = synthetic.make_imu(
        traj, -0.02, float(ts[-1]) + 0.01, rate=200.0,
        gyro_noise=1.7e-4 * np.sqrt(200.0), acc_noise=2.0e-3 * np.sqrt(200.0),
        gyro_bias=np.array([0.01, -0.008, 0.012]), seed=5)
    sys_ = _system(settings_text(width, height, fx, n_features, imu=True),
                   Sensor.IMU_MONOCULAR, device)
    sys_.VI_INIT_KFS = 6
    frame_s = np.zeros(n)
    t_prev = -1.0
    pipelined_frames = 0
    for k in range(n):
        sel = (imu_t > t_prev) & (imu_t <= ts[k])
        pts = [ImuPoint(acc[i], gyro[i], imu_t[i]) for i in np.where(sel)[0]]
        t0 = time.perf_counter()
        sys_.track_monocular(images[k], float(ts[k]), pts)
        frame_s[k] = time.perf_counter() - t0
        t_prev = float(ts[k])
        if sys_._pend is not None:
            pipelined_frames += 1
    steady = float(np.median(frame_s[n // 2:]))
    extra = {
        "config": f"{width}x{height} / {n_features} feats / 8 levels / "
                  "200 Hz IMU (reference D435i mono-inertial live config), "
                  "pipelined VI mode engages after IMU init",
        "imu_initialized": bool(sys_.imu_initialized),
        "keyframes": int(sys_.map.n_kf),
        "pipelined_frames": pipelined_frames,
        **_tail(frame_s),
    }
    return 1.0 / max(steady, 1e-9), extra


# ----------------------------------------------------------------- main

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=PARTS, default=None,
                    help="run one part; the others' numbers are null")
    add_device(ap)
    return ap


def main(argv=None) -> dict:
    """Runs the parts, prints the JSON line and returns it as a dict."""
    ap = build_parser()
    args = ap.parse_args(argv)
    dev = device_of(ap, args)

    def runs(part):
        return args.only in (None, part)

    fps, trk_detail = (_bench_tracking(dev) if runs("tracking")
                       else (None, {}))
    ba_s, ba_detail = _bench_ba_iters(dev) if runs("ba") else (None, {})
    sys_fps, sys_extra = (_bench_system_fps_steady(dev) if runs("system")
                          else (None, None))
    vi_fps, vi_extra = (_bench_system_fps_steady_vi(dev)
                        if runs("system_vi") else (None, None))
    blob = {
        "metric": "tracking_fps_per_chip",
        "value": fps,
        "unit": "frames/s (752x480, 1000 ORB feats, 8 levels, full map "
                "match + pose LM; one Python loop of eager launches, the "
                "pose chained on the device, batch-size slope)",
        "vs_baseline": None if fps is None else fps / 30.0,
        "extra": {
            "ba_iters_per_s_per_chip": ba_s,
            "ba_problem": "64 kf x 8192 lm dense robust-LM Schur "
                          "(iteration-count slope)",
            "system_fps_steady": sys_fps,
            "system_fps_detail": sys_extra,
            "system_fps_steady_vi": vi_fps,
            "system_fps_vi_detail": vi_extra,
            "system_fps_note": "full orchestrated host loop at the "
                               "reference 640x480/1250-feature live "
                               "config, pipelined mode (each frame "
                               "consumed one call later, the pose chained "
                               "on the device); live-ingest bar is 30 FPS "
                               "(launch/mapping.launch.py:85)",
            **card(dev),
            "tracking_repeat_s": trk_detail.get("repeat_s"),
            "ba_repeat_s": ba_detail.get("repeat_s"),
        },
    }
    print(json.dumps(blob), flush=True)
    return blob


if __name__ == "__main__":
    main()
