#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU: every kernel against its
plain version, the per-frame tracking slice, and the System in its
monocular, stereo, RGB-D and fisheye-stereo configurations.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. Device: requires CUDA; prints the card's name and power limit, and builds
   the kernels from `orb_slam3_ros2_tpu_torch/csrc/` (one nvcc per source,
   all started together).
2. Kernels: the three tracking-path kernels against their plain PyTorch
   versions on the card, at the shapes the tracking path gives them
   (752x480 over 8 levels; 1000 features x 4096 visible landmarks for
   tracking and x 8192 landmark slots for SearchAndFuse; 1000 pose
   observations); then again at the stereo and RGB-D paths' shapes: the
   8-level pyramids of a 1241x376 (KITTI) and a 512x512 (TUM-VI) frame,
   2000 features x 4096 visible landmarks at 15 px and x 8192 slots at 4 px
   (max_dist 45, no ratio, not mutual), and 2000 and 4096 pose
   observations. The match kernel must give idx, valid and dist exactly
   as its plain version (also over back-to-back calls on two inputs),
   dispatch only three `torch.empty` and views, and enqueue itself alone; its
   latency floor (the same launch without the sweeps) is printed at each
   shape. The pose kernel must agree with its plain version (R
   within 5e-5, t within 5e-4, identical inliers and count), give the
   same bits twice, dispatch only three `torch.empty` and views, and
   enqueue itself alone; its latency floor (the same launch doing only
   the 18 reductions) is printed. The packed frontend must give score exactly on the whole canvas, keep
   exactly 4 px inside each level, raw exactly on each level, 0 / false
   outside the levels, one kernel and no other device op per call, and
   the extractor's features bit for bit as through the plain version
   (752x480 and 1241x376).
2b. Per-level kernels: `fast_nms`, `blur7`, `frontend_pass` and
   `frontend_pass_lite` on each of the 8 levels of a 752x480 frame's
   pyramid, against their plain versions at the JAX oracle tests'
   tolerances, and one call of each timed on level 0; `blur7` beside
   `conv2d` with the same 7x7 taps (its library yardstick).
   For every kernel phases 2 and 2b print its device time per launch
   (torch.profiler, the kernel's own device events), its bound (the larger
   of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s, H100
   SXM data sheet) and the share of the bound, the wrapper's time (CUDA
   events around back-to-back calls, what the path pays) and the plain
   version's.
3. Slice: renders a 752x480 sequence (EuRoC intrinsics, seed 1), seeds a
   full-size map (256 keyframes, 8192 landmarks, 1000 features) from frame
   0's features and ground-truth depth, and tracks the following frames with
   `runtime.system.frame_step` under constant-velocity prediction. Checks
   inliers and pose error against ground truth on every frame, that the same
   frames through the plain versions on the card give the same poses, and
   that the kernels' launch counters show the path went through them.
4. System: `System.track_monocular` from a blank map over 40 rendered
   752x480 frames (EuRoC cam0 intrinsics; the configuration of
   `orb_slam3_ros2_tpu_torch/tools/system_run.py`), through the two-view
   initializer, tracking and keyframe mapping, held to the bounds of
   `tests/test_e2e_mono.py`; SearchAndFuse must launch the match kernel
   once per inserted keyframe.
5. Stereo: `System.track_stereo` from a blank map over 30 rendered
   1241x376 pairs of the textured room at KITTI00-02's calibration and
   2000 features
   (`kitti_stereo` of `tools/system_run.py`), held to the bounds of
   `tests/test_e2e_stereo.py`: state OK, more than 15 tracked frames,
   Sim3-aligned ATE under 0.08 m, unaligned length within 12%.
6. RGB-D: `System.track_rgbd` over 30 rendered 640x480 image + depth frames
   at TUM1's intrinsics (`tum1_rgbd`), held to `tests/test_e2e_rgbd.py`'s
   bounds (the length within 10%).
7. Fisheye stereo: `System.track_stereo` over 22 rendered 512x512 KB8 pairs
   of TUM-VI's two cameras through the general two-view rig
   (`tumvi_stereo`), held to `tests/test_e2e_fisheye.py`'s stereo bounds:
   at least n - 8 tracked, ATE under 0.10 m, length within 10%.
   Phases 5-7 also require each kernel on the path: the frontend kernel
   once per image, the pose kernel twice per tracked frame after the
   initializing one, the match kernel once per SearchAndFuse.

The last line is {"ok": true, "device": {...}}; the line before it holds the
per-kernel JSON record (`launches`: the sum over the runs of phases 3-7,
each counted from 0 around its run; the per-level kernels: phase 2b; `ms`:
device time per launch at the main-path shape, `wrapper_ms` the wrapper's
time there), the line before that the card, and the one before that the
phases' results. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PKG = "orb_slam3_ros2_tpu_torch"

N_TRACK = 20  # frames tracked after the seeding frame
WIDTH, HEIGHT = 752, 480
FX, FY = 458.654, 457.296  # EuRoC cam0
# Pose bounds against ground truth (camera centre, rotation angle), about
# three times what the port's plain path gives on the same 20 frames on a
# CPU (median 0.0021 m, max 0.0066 m).
MEDIAN_POS_M, MAX_POS_M, MAX_ROT_DEG = 0.01, 0.025, 0.25
# kernel path vs plain path on the same frames
AGREE_POS_M, AGREE_ROT_RAD = 1e-3, 1e-3

KERNELS = {
    # name: (source, replaced TPU kernel)
    "frontend_packed": (f"{PKG}/csrc/frontend_packed.cu",
                        "orb_slam3_ros2_tpu/ops/pallas_kernels.py:534"),
    "fused_match": (f"{PKG}/csrc/fused_match.cu",
                    "orb_slam3_ros2_tpu/ops/fused_match.py:113"),
    "pose_opt_fused": (f"{PKG}/csrc/pose_opt_fused.cu",
                       "orb_slam3_ros2_tpu/backend/pose_opt_fused.py:255"),
    "fast_nms": (f"{PKG}/csrc/frontend_level.cu",
                 "orb_slam3_ros2_tpu/ops/pallas_kernels.py:161"),
    "blur7": (f"{PKG}/csrc/frontend_level.cu",
              "orb_slam3_ros2_tpu/ops/pallas_kernels.py:182"),
    "frontend_pass": (f"{PKG}/csrc/frontend_level.cu",
                      "orb_slam3_ros2_tpu/ops/pallas_kernels.py:340"),
}
SOURCES = ("frontend_packed", "fused_match", "pose_opt_fused",
           "frontend_level")

# phase 2b: the JAX oracle tests' tolerances (tests/test_pallas_kernels.py),
# on each level's interior (4 px; 16 px for the moment maps)
LEVEL_SCORE_ATOL = 1e-4
LEVEL_BLUR_RTOL, LEVEL_BLUR_ATOL = 1e-5, 1e-3
LEVEL_MOM_RTOL, LEVEL_MOM_ATOL = 2e-4, 2.0

# phase 4: tests/test_e2e_mono.py's bounds; the JAX System on the clip of
# tools/system_run.py on a CPU: OK, 9 keyframes, 1660 landmarks, 38
# tracked, ATE 0.0078 / 0.0084 m
ATE_MAX_M, ATE_RAW_MAX_M = 0.05, 0.12
MIN_KF, MIN_LM, MIN_TRACKED = 4, 100, 20

# phases 5-7: the rig configurations of tools/system_run.py; their bounds
# are those of the JAX e2e tests (`system_run.RIGS`). The JAX System on the
# same clips on a CPU: OK, 30/30/22 tracked, ATE 0.0125 / 0.0053 / 0.0158 m,
# length ratio 1.0054 / 0.9966 / 0.9274 (PERF.md §4)
RIG_PHASES = ("kitti_stereo", "tum1_rgbd", "tumvi_stereo")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 operations/s
# outside the tensor cores (integer and min/max operations are counted at
# the same rate)
PEAK_BYTES_S, PEAK_OPS_S = 3.35e12, 67e12
# operations per pixel, counted from the kernels' code: FAST-9 by the
# doubling window (64 min + 64 max, 30 arc maxima/minima, 2 subtractions,
# 2 max), 3x3 NMS (8 compares), separable 7x7 blur (2 x 7 multiplies + 2 x
# 6 adds); the moment maps' prefix sums (4) and 31 disc rows (6 each, + 2)
OPS_FAST, OPS_NMS, OPS_BLUR, OPS_MOMENTS = 162, 8, 26, 192
# match: the window test of a pair (2 sub, 2 abs, 2 compare, the masks);
# a pair inside the window: 8 XOR, 8 popcount, 8 adds, the row's top-2 and
# the column's argmin
OPS_MATCH_PAIR, OPS_MATCH_IN_WINDOW = 7, 28
# pose LM: 3 rounds x (1 + 5) evaluations of ~235 operations a point
# (transform 18, projection and residual 16, chi2/Huber/weights 15,
# Jacobian 18, the 28 Gram entries 168)
POSE_EVALS, OPS_POSE_POINT = 18, 235


class PhaseError(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the f32 rate."""
    t_b = n_bytes / PEAK_BYTES_S * 1e3
    t_o = n_ops / PEAK_OPS_S * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                bytes=n_bytes, ops=n_ops)


def kernel_times(fn, names, n_bytes, n_ops, plain=None) -> dict:
    """Device time per launch (profiler), bound and share, the wrapper's
    time and the plain version's, for the kernel behind fn()."""
    from orb_slam3_ros2_tpu_torch.tools.kernel_timing import (device_events,
                                                              time_ms)

    dev_ms, ops = device_events(fn, names)
    out = dict(device_ms=dev_ms, device_ops=ops, wrapper_ms=time_ms(fn),
               **bound(n_bytes, n_ops))
    out["ms"] = dev_ms if dev_ms is not None else out["wrapper_ms"]
    out["share"] = out["bound_ms"] / out["ms"]
    if plain is not None:
        out["plain_ms"] = time_ms(plain)
    return out


def aten_ops(fn) -> list:
    """The aten operators (OpOverloads) one call of fn() dispatches, in
    order."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    with Log() as log:
        fn()
    return log.ops


def print_times(label: str, r: dict) -> None:
    dev = ("not measured" if r["device_ms"] is None
           else f"{r['device_ms']:.5f} ms")
    extra = "".join(f", {k} {r[k]:.5f} ms" for k in
                    ("plain_ms", "library_ms", "floor_ms")
                    if r.get(k) is not None)
    print(f"{label}: device {dev} per launch, bound {r['bound_ms']:.5f} ms "
          f"({r['bound_by']}: {r['bytes']:.0f} B, {r['ops']:.0f} ops), "
          f"share {r['share']:.1%}, wrapper {r['wrapper_ms']:.5f} ms{extra}")


# ---------------------------------------------------------------- phase 2

def check_frontend(img, dev, n_features=None):
    """The packed frontend on img's 8-level pyramid against its plain
    version: score exact on the whole canvas, keep exact 4 px inside each
    level, raw exact on each level, blur within the oracle's bounds 4 px
    inside each level, 0 / false outside the levels; one kernel and no
    other device op per call. With `n_features`, the extractor's features
    through the kernel and through the plain version must be identical.
    Returns max_abs_err and the times of `kernel_times`."""
    import torch
    from orb_slam3_ros2_tpu_torch.ops import frontend_packed as fp
    from orb_slam3_ros2_tpu_torch.ops import pyramid as pyr

    levels = pyr.build_pyramid(torch.from_numpy(img).to(dev), 8, 1.2)
    score, keep, blur, raw, layout = fp.frontend_pass_packed(levels)
    s_r, k_r, b_r, r_r, lay_r = fp.frontend_pass_packed_ref(levels)
    torch.cuda.synchronize()
    tag = f"frontend {img.shape[1]}x{img.shape[0]}"
    _, total = fp.pack_layout([tuple(l.shape) for l in levels])
    require(layout == lay_r and tuple(score.shape) == (total, img.shape[1]),
            f"{tag}: layout {layout}, canvas {tuple(score.shape)}")
    require(bool((score == s_r).all()), f"{tag}: score not exact, max "
            f"{(score - s_r).abs().max().item()}")
    require(bool((raw == r_r).all()), f"{tag}: raw differs")
    outside = torch.ones_like(keep)
    B = 4
    err = 0.0
    for (r0, h, w) in layout:
        outside[r0:r0 + h, :w] = False
        sl = (slice(r0 + B, r0 + h - B), slice(B, w - B))
        require(bool((keep[sl] == k_r[sl]).all()),
                f"{tag}: keep differs at level row {r0}")
        db = (blur[sl] - b_r[sl]).abs()
        require(bool((db <= 1e-3 + 1e-5 * b_r[sl].abs()).all()),
                f"{tag}: blur differs by {db.max().item()} at row {r0}")
        err = max(err, db.max().item())
    require(not bool(keep[outside].any())
            and all(bool((x[outside] == 0).all()) for x in (score, blur, raw)),
            f"{tag}: a cell outside the levels is not 0 / false")
    ops = [str(op) for op in aten_ops(lambda: fp.frontend_pass_packed(levels))]
    require(ops == ["aten.empty.memory_format"] * 4,
            f"{tag}: the wrapper dispatches {ops}")
    if n_features is not None:
        check_extract(img, dev, n_features)

    n_px = sum(h * w for _, h, w in layout)
    plan = fp.plan_of(levels)
    r = kernel_times(
        lambda: fp.frontend_pass_packed(levels), ("frontend_packed_kernel",),
        4 * n_px + 13 * score.numel(), (OPS_FAST + OPS_NMS + OPS_BLUR) * n_px,
        plain=lambda: fp.frontend_pass_packed_ref(levels))
    if r["device_ms"] is not None:  # the profiler window: this kernel alone
        require(len(r["device_ops"]) == 1
                and "frontend_packed_kernel" in next(iter(r["device_ops"])),
                f"{tag}: one call enqueues {r['device_ops']}")
    print(f"{tag}: device ops of 20 calls {r['device_ops']}, aten ops of "
          f"one call {ops}")
    r.update(max_abs_err=err, levels=len(layout), level_px=n_px,
             canvas=[total, img.shape[1]],
             tiles=plan.n_tiles, zero_fill_blocks=plan.n_zero)
    return r


def check_extract(img, dev, n_features):
    """`extract()` on the card through the kernel and through the plain
    frontend: identical uv, level, score, mask and bits."""
    import torch
    from orb_slam3_ros2_tpu_torch.frontend import extractor as ex

    cfg = ex.ExtractorConfig(n_features=n_features, n_levels=8,
                             scale_factor=1.2, height=img.shape[0],
                             width=img.shape[1])
    extract = ex.make_extractor(cfg)
    image = torch.from_numpy(img).to(dev)
    got = extract(image)
    with plain_versions():
        ref = extract(image)
    torch.cuda.synchronize()
    for name in ("uv", "level", "score", "mask", "bits"):
        require(torch.equal(getattr(got, name), getattr(ref, name)),
                f"extract {img.shape[1]}x{img.shape[0]}: {name} differs "
                f"between the kernel and the plain frontend")
    print(f"extract {img.shape[1]}x{img.shape[0]}, {n_features} features: "
          f"identical through the kernel and the plain frontend "
          f"({int(got.mask.sum())} valid)")


def check_match(dev, N=1000):
    """Tracking's shape (N x 4096 visible landmarks, 15 px) under every
    ratio/mutual setting (N = 1000; at N = 2000 the default ratio 0.9,
    mutual), and SearchAndFuse's (N x all 8192 landmark slots, 4 px,
    max_dist 45, no ratio test, not mutual): idx, valid and dist exact
    against the plain version, also over three back-to-back calls on two
    inputs (state left by a launch would show); one call dispatches only
    three `torch.empty` and views and enqueues the kernel alone. Returns
    max_abs_err, the times of the tracking call and of the SearchAndFuse
    call, and each one's latency floor (the same launch without the
    sweeps)."""
    import torch
    from orb_slam3_ros2_tpu_torch.ops import fused_match as fm
    from orb_slam3_ros2_tpu_torch.tools.kernel_timing import (device_events,
                                                              match_tensors)

    args, kw = match_tensors(N, 4096, "track", 0 if N == 1000 else 4, dev)
    settings = [(args, dict(kw, ratio=ratio, mutual=mutual))
                for ratio in (0.9, None) for mutual in (True, False)
                if N == 1000 or (ratio, mutual) == (0.9, True)]
    fuse_args, fuse_kw = match_tensors(N, 8192, "fuse",
                                       2 if N == 1000 else 5, dev)
    settings.append((fuse_args, fuse_kw))
    other, _ = match_tensors(N, 4096, "track", 7, dev)
    # back to back, no synchronize between: the first input again after
    # another, so that state left by a launch would change a result
    settings += [(args, kw), (other, kw), (args, kw)]
    gots = [fm.match_window(*a, **k) for a, k in settings]
    err = 0.0
    for (a, k), got in zip(settings, gots):
        ref = fm.match_window_ref(*a, **k)
        torch.cuda.synchronize()
        what = f"{N}x{a[3].shape[0]}, {k}"
        n_ok = int(ref.valid.sum())
        require(n_ok > 300, f"match case {what} has only {n_ok} matches")
        require(torch.equal(got.valid, ref.valid)
                and torch.equal(got.idx, ref.idx),
                f"match idx/valid differ ({what})")
        v = ref.valid
        err = max(err, (got.dist[v] - ref.dist[v]).abs().max().item())
    require(err == 0.0, f"match distances differ by {err}")

    def cost(a, k):
        """Bytes and operations of one call on a's inputs: each input read
        once (41 B a row or column), idx, dist and valid written once."""
        _, ma, uva, _, mb, uvb = a
        M, r = uvb.shape[0], k["radius"]
        win = (((uva[:, None, 0] - uvb[None, :, 0]).abs() <= r)
               & ((uva[:, None, 1] - uvb[None, :, 1]).abs() <= r)
               & ma[:, None] & mb[None, :])
        return (41 * (N + M) + 9 * N,
                OPS_MATCH_PAIR * N * M + OPS_MATCH_IN_WINDOW * int(win.sum()))

    names = ("match_window_kernel",)
    out = {}
    for key, a, k in (("track", args, kw), ("fuse", fuse_args, fuse_kw)):
        tag = f"match {N}x{a[3].shape[0]} at {k['radius']:g} px"
        ops = aten_ops(lambda: fm.match_window(*a, **k))
        empty = [str(op) == "aten.empty.memory_format" for op in ops]
        require(sum(empty) == 3
                and all(e or op.is_view for e, op in zip(empty, ops)),
                f"{tag}: the wrapper dispatches {ops}")
        ops = [str(op) for op in ops]
        r = kernel_times(lambda: fm.match_window(*a, **k), names, *cost(a, k),
                         plain=lambda: fm.match_window_ref(*a, **k))
        if r["device_ms"] is not None:  # the profiler window: the kernel alone
            require(len(r["device_ops"]) == 1
                    and names[0] in next(iter(r["device_ops"])),
                    f"{tag}: one call enqueues {r['device_ops']}")
        r["floor_ms"], _ = device_events(
            lambda: fm.latency_floor(*a, **k), names)
        print(f"{tag}: plan {fm.plan_for(N, a[3].shape[0])}, "
              f"{fm.blocks_for(N, a[3].shape[0])} blocks, device ops of 20 "
              f"calls {r['device_ops']}, aten ops of one call {ops}")
        print_times(tag, r)
        out[key] = r
    track = out["track"]
    track.update(max_abs_err=err, fuse={k: v for k, v in out["fuse"].items()
                                        if k != "device_ops"})
    return track


def check_pose(dev, N=1000):
    """The pose kernel on N observations (30% outliers) against its plain
    version (R within 5e-5, t within 5e-4, identical inliers and count)
    and the true pose; two launches bit-identical; one call dispatches
    only `torch.empty` and views and enqueues the kernel alone. Returns
    max_abs_err, both times, the plan and the latency floor: the same
    launch shape doing only the 18 reduce-and-broadcasts."""
    import torch
    from orb_slam3_ros2_tpu_torch.backend import pose_opt, pose_opt_fused
    from orb_slam3_ros2_tpu_torch.tools.kernel_timing import (device_events,
                                                              pose_case)

    X, uv, invs2, mask, K, R_true, t_true = pose_case(
        N, 1 if N == 1000 else N)
    args = (torch.eye(3, device=dev), torch.zeros(3, device=dev),
            *(torch.from_numpy(a).to(dev) for a in (X, uv, invs2, mask)), *K)
    got = pose_opt_fused.optimize_pose_fused(*args)
    again = pose_opt_fused.optimize_pose_fused(*args)
    ref = pose_opt.optimize_pose(*args)
    torch.cuda.synchronize()
    tag = f"pose N={N}"
    dR = (got.R - ref.R).abs().max().item()
    dt = (got.t - ref.t).abs().max().item()
    require(dR <= 5e-5 and dt <= 5e-4, f"{tag}: dR {dR}, dt {dt}")
    require(bool((got.inliers == ref.inliers).all())
            and got.n_inliers.dtype == torch.int32
            and int(got.n_inliers) == int(ref.n_inliers),
            f"{tag}: inlier sets differ")
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"{tag}: two launches differ")
    require(np.abs(got.R.cpu().numpy() - R_true).max() < 2e-3
            and np.abs(got.t.cpu().numpy() - t_true).max() < 1e-2,
            f"{tag}: the kernel did not converge to the true pose")
    ops = aten_ops(lambda: pose_opt_fused.optimize_pose_fused(*args))
    n_empty = sum(str(op) == "aten.empty.memory_format" for op in ops)
    require(n_empty == 3 and all(str(op) == "aten.empty.memory_format"
                                 or op.is_view for op in ops),
            f"{tag}: the wrapper dispatches {ops}")
    out = kernel_times(
        lambda: pose_opt_fused.optimize_pose_fused(*args),
        ("pose_opt_kernel",), 26 * N + 48 + 68,
        POSE_EVALS * OPS_POSE_POINT * N,
        plain=lambda: pose_opt.optimize_pose(*args))
    if out["device_ms"] is not None:  # the profiler window: this kernel alone
        require(len(out["device_ops"]) == 1
                and "pose_opt_kernel" in next(iter(out["device_ops"])),
                f"{tag}: one call enqueues {out['device_ops']}")
    floor_ms, _ = device_events(
        lambda: pose_opt_fused.latency_floor(POSE_EVALS, N, dev),
        ("pose_floor_kernel",))
    print(f"{tag}: plan (threads, points a thread, cluster) "
          f"{pose_opt_fused.plan_for(N)}, device ops of 20 calls "
          f"{out['device_ops']}, aten ops of one call "
          f"{[str(op) for op in ops]}, latency floor {floor_ms} ms")
    out.update(max_abs_err=max(dR, dt), floor_ms=floor_ms,
               plan=list(pose_opt_fused.plan_for(N)))
    return out


# --------------------------------------------------------------- phase 2b

def _interior_err(got, ref, b, rtol, atol, what):
    """Max |got - ref| on the b-px interior; fails past atol + rtol |ref|."""
    g, r = got[b:-b, b:-b].float(), ref[b:-b, b:-b].float()
    d = (g - r).abs()
    require(bool((d <= atol + rtol * r.abs()).all()),
            f"{what} differs by {d.max().item()} on the interior")
    return d.max().item()


def check_frontend_level(img, dev, record):
    """The per-level ops API on every level of the pyramid: the path run
    (counters from 0), then each output against the plain version."""
    import torch
    from orb_slam3_ros2_tpu_torch.ops import frontend_level as fl
    from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as desc
    from orb_slam3_ros2_tpu_torch.ops import pyramid as pyr
    from orb_slam3_ros2_tpu_torch.tools.kernel_timing import (device_events,
                                                              time_ms)

    levels = pyr.build_pyramid(torch.from_numpy(img).to(dev), 8, 1.2)
    fns = (fl.fast_nms, fl.blur7, fl.frontend_pass, fl.frontend_pass_lite)
    for fn in fns:
        fn.launches = 0
    outs = [tuple(fn(level) for fn in fns) for level in levels]
    torch.cuda.synchronize()
    launches = [fn.launches for fn in fns]
    print(f"per-level launches over {len(levels)} levels: {launches}")
    require(launches == [len(levels)] * 4, "a per-level kernel did not run")
    err = dict(fast_nms=0.0, blur7=0.0, frontend_pass=0.0)
    B, BM = 4, 16
    for level, (sk, blur, full, lite) in zip(levels, outs):
        s_r, k_r = fl.fast_nms_ref(level)
        b_r = fl.blur7_ref(level)
        m01_r, m10_r = desc.moment_maps(level)
        tag = f"level {tuple(level.shape)}"
        for (score, keep), key in ((sk, "fast_nms"), (full[:2], "frontend_pass"),
                                   (lite[:2], "frontend_pass")):
            e = _interior_err(score, s_r, B, 0.0, LEVEL_SCORE_ATOL,
                              f"{key} score, {tag}")
            require(bool((keep[B:-B, B:-B] == k_r[B:-B, B:-B]).all()),
                    f"{key} keep differs, {tag}")
            err[key] = max(err[key], e)
        for b, key in ((blur, "blur7"), (full[4], "frontend_pass"),
                       (lite[2], "frontend_pass")):
            err[key] = max(err[key], _interior_err(
                b, b_r, B, LEVEL_BLUR_RTOL, LEVEL_BLUR_ATOL, f"{key} blur, {tag}"))
        for m, m_r, name in ((full[2], m01_r, "m01"), (full[3], m10_r, "m10")):
            err["frontend_pass"] = max(err["frontend_pass"], _interior_err(
                m, m_r, BM, LEVEL_MOM_RTOL, LEVEL_MOM_ATOL, f"{name}, {tag}"))
    level0 = levels[0]
    n_px = level0.numel()
    score_ops = OPS_FAST + OPS_NMS
    # (record key, wrapper, plain version, bytes per pixel, ops per pixel);
    # outputs: score f32 + keep bool, blur f32, m01/m10 f32 for the full pass
    cases = (
        ("fast_nms", fl.fast_nms, fl.fast_nms_ref, 4 + 5, score_ops),
        ("blur7", fl.blur7, fl.blur7_ref, 4 + 4, OPS_BLUR),
        ("frontend_pass", fl.frontend_pass, fl.frontend_pass_ref,
         4 + 17, score_ops + OPS_BLUR + OPS_MOMENTS),
        ("frontend_pass_lite", fl.frontend_pass_lite,
         fl.frontend_pass_lite_ref,
         4 + 9, score_ops + OPS_BLUR))
    for (key, fn, ref, b_px, o_px), n_l in zip(cases, launches):
        r = kernel_times(lambda: fn(level0), ("level_kernel",), b_px * n_px,
                         o_px * n_px, plain=lambda: ref(level0))
        r.update(launches=n_l, max_abs_err=err.get(key))
        record[key] = r
    # blur7's library yardstick: one conv2d with the 7x7 outer product of
    # the same taps and the same zero padding (TF32 off, as the package
    # sets it), timed here and called nowhere in the port
    torch.backends.cudnn.allow_tf32 = False
    g = torch.from_numpy(pyr._gauss_kernel1d(7, 2.0)).to(dev)
    k2 = torch.outer(g, g)[None, None]

    def conv():
        return torch.nn.functional.conv2d(level0[None, None], k2,
                                          padding=3)[0, 0]

    record["blur7"]["library_ms"] = time_ms(conv)
    record["blur7"]["library_device_ms"] = device_events(conv, ("",))[0]
    record["blur7"]["library_max_abs_diff"] = (
        conv() - fl.blur7(level0)).abs().max().item()
    lite = record.pop("frontend_pass_lite")
    record["frontend_pass"]["launches"] += lite["launches"]
    record["frontend_pass"]["lite"] = {k: v for k, v in lite.items()
                                       if k != "device_ops"}


# ---------------------------------------------------------------- phase 3

@contextlib.contextmanager
def plain_versions():
    """Route the tracking path through the kernels' plain PyTorch versions
    (for the comparison run only)."""
    from orb_slam3_ros2_tpu_torch.backend import pose_opt, pose_opt_fused
    from orb_slam3_ros2_tpu_torch.ops import frontend_packed as fp
    from orb_slam3_ros2_tpu_torch.ops import fused_match as fm

    saved = [(fp, "frontend_pass_packed", fp.frontend_pass_packed),
             (fm, "match_window", fm.match_window),
             (pose_opt_fused, "optimize_pose_fused",
              pose_opt_fused.optimize_pose_fused)]
    fp.frontend_pass_packed = fp.frontend_pass_packed_ref
    fm.match_window = fm.match_window_ref
    pose_opt_fused.optimize_pose_fused = pose_opt.optimize_pose
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def seed_map(img, depth, R, t, cam, ex_cfg, dev):
    """Frame-0 keyframe: port features back-projected with ground-truth
    depth and pose, inserted into a full-size map."""
    import torch
    from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
    from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
    from orb_slam3_ros2_tpu_torch.runtime import system

    f = ex.make_extractor(ex_cfg)(torch.from_numpy(img).to(dev))
    uv = system.undistort(cam, f.uv)
    uvn = uv.cpu().numpy()
    xi = np.clip(np.round(uvn[:, 0]).astype(int), 0, img.shape[1] - 1)
    yi = np.clip(np.round(uvn[:, 1]).astype(int), 0, img.shape[0] - 1)
    z = depth[yi, xi]
    ok = f.mask.cpu().numpy() & (z > 0.1)
    Xc = np.stack([(uvn[:, 0] - cam.cx) / cam.fx * z,
                   (uvn[:, 1] - cam.cy) / cam.fy * z, z], -1)
    Xw = ((Xc - t) @ R).astype(np.float32)  # R^T (x_c - t)
    cfg = ms.MapConfig(max_kf=256, max_lm=8192, n_feat=ex.total_capacity(ex_cfg))
    m = ms.empty_map(cfg, dev)
    N = cfg.n_feat
    Rd, td = torch.from_numpy(R).to(dev), torch.from_numpy(t).to(dev)
    m = ms.insert_keyframe(m, Rd, td, 0.0, uv, f.level, f.bits, f.mask,
                           torch.full((N,), -1, dtype=torch.int32, device=dev))
    feat = torch.arange(N, dtype=torch.int32, device=dev)
    m = ms.add_landmarks(m, torch.from_numpy(Xw).to(dev), f.bits,
                         torch.from_numpy(ok).to(dev), 0, 0, feat, 0, feat)
    return m, int(ok.sum())


def track(m, imgs, R0, t0, cam, ex_cfg, dev):
    """Track imgs[1:] from the ground-truth frame-0 pose. Returns per-frame
    (R, t, summary, ms) lists."""
    import torch
    from orb_slam3_ros2_tpu_torch.runtime import system

    poses = [(torch.from_numpy(R0).to(dev), torch.from_numpy(t0).to(dev))] * 2
    out = []
    for k in range(1, imgs.shape[0]):
        img = torch.from_numpy(imgs[k]).to(dev)
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        m, f_u, _, R, t, summary = system.frame_step(
            m, *poses[-1], *poses[-2], img, cam, ex_cfg)
        summary = summary.cpu().numpy()
        ms_frame = (time.perf_counter() - t_start) * 1e3
        require(f_u.uv.shape == (1000, 2) and bool(torch.isfinite(f_u.uv).all())
                and np.isfinite(summary).all() and summary.shape == (16,),
                f"frame {k}: non-finite or misshapen output")
        poses.append((R, t))
        out.append((R.cpu().numpy(), t.cpu().numpy(), summary, ms_frame))
    return out


def rot_angle(Ra, Rb) -> float:
    """Angle of Ra Rb^T in radians, from ||Ra - Rb||_F = 2 sqrt(2) sin(θ/2)
    (the arccos of the trace cannot resolve small angles from f32 input)."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0)))


def pose_errors(R, t, R_gt, t_gt):
    """(camera-centre error in m, rotation error in degrees)."""
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    R_gt, t_gt = np.asarray(R_gt, np.float64), np.asarray(t_gt, np.float64)
    c = -R.T @ t
    c_gt = -R_gt.T @ t_gt
    return (float(np.linalg.norm(c - c_gt)),
            float(np.degrees(rot_angle(R, R_gt))))


def run_slice(dev, record):
    import torch
    from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused
    from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
    from orb_slam3_ros2_tpu_torch.io.synthetic import render_sequence
    from orb_slam3_ros2_tpu_torch.models import cameras
    from orb_slam3_ros2_tpu_torch.ops import frontend_packed as fp
    from orb_slam3_ros2_tpu_torch.ops import fused_match as fm

    imgs, depths, R_gt, t_gt, _ = render_sequence(
        n_frames=N_TRACK + 1, width=WIDTH, height=HEIGHT, fx=FX, fy=FY,
        return_depth=True, seed=1)
    cam = cameras.make_camera("PinHole", FX, FY, WIDTH / 2.0, HEIGHT / 2.0,
                              (0.0, 0.0, 0.0, 0.0), WIDTH, HEIGHT, 20.0)
    ex_cfg = ex.ExtractorConfig(n_features=1000, n_levels=8,
                                scale_factor=1.2, height=HEIGHT, width=WIDTH)
    require(ex.total_capacity(ex_cfg) == 1000, "extractor capacity")
    m, n_lm = seed_map(imgs[0], depths[0], R_gt[0], t_gt[0], cam, ex_cfg, dev)
    require(n_lm >= 300, f"seed map has only {n_lm} landmarks")
    print(f"seed map: {n_lm} landmarks from frame 0")

    # warm-up on the seeding frame (allocator, first launches)
    track(m, imgs[:2], R_gt[0], t_gt[0], cam, ex_cfg, dev)
    counters = (fp.frontend_pass_packed, fm.match_window,
                pose_opt_fused.optimize_pose_fused)
    for fn in counters:
        fn.launches = 0
    run = track(m, imgs, R_gt[0], t_gt[0], cam, ex_cfg, dev)
    launches = dict(zip(("frontend_packed", "fused_match", "pose_opt_fused"),
                        (fn.launches for fn in counters)))
    with plain_versions():
        plain = track(m, imgs, R_gt[0], t_gt[0], cam, ex_cfg, dev)

    pos_err, rot_err = [], []
    for k, ((R, t, s, _), (Rp, tp, sp, _)) in enumerate(zip(run, plain), 1):
        pe, re = pose_errors(R, t, R_gt[k], t_gt[k])
        pos_err.append(pe)
        rot_err.append(re)
        print(f"frame {k:2d}: matches {int(s[12]):4d} inliers {int(s[13]):4d}"
              f" pos_err {pe:.5f} m rot_err {re:.4f} deg"
              f" | plain inliers {int(sp[13]):4d}")
        require(s[13] >= 15, f"frame {k}: {int(s[13])} inliers < 15")
        dpos = float(np.abs((-R.T @ t) - (-Rp.T @ tp)).max())
        drot = rot_angle(R, Rp)
        require(dpos <= AGREE_POS_M and drot <= AGREE_ROT_RAD,
                f"frame {k}: kernel and plain paths disagree "
                f"({dpos} m, {drot} rad)")
    med = statistics.median(pos_err)
    print(f"pose error vs ground truth: median {med:.5f} m, max "
          f"{max(pos_err):.5f} m, max {max(rot_err):.4f} deg")
    require(med <= MEDIAN_POS_M and max(pos_err) <= MAX_POS_M
            and max(rot_err) <= MAX_ROT_DEG, "pose error out of bounds")
    n = len(run)
    print(f"launches over {n} frames: {launches}")
    require(launches["frontend_packed"] >= n, "frontend kernel not on path")
    require(launches["fused_match"] >= 2 * n, "match kernel not on path")
    require(launches["pose_opt_fused"] == 2 * n, "pose kernel not on path")
    ms_k = statistics.median(r[3] for r in run)
    ms_p = statistics.median(r[3] for r in plain)
    print(f"frame_step median: {ms_k:.3f} ms (kernels), "
          f"{ms_p:.3f} ms (plain versions)")
    add_launches(record, launches)
    return ms_k, ms_p


def add_launches(record, launches):
    """Add one main-path run's launch counts to the kernels' records."""
    for name, n_l in launches.items():
        record[name]["launches"] = record[name].get("launches", 0) + n_l


# ------------------------------------------------------------ phases 4-7

def drive(slam, step, n_frames: int, label: str) -> dict:
    """Feed frames 0..n_frames-1 to `step(k)` (one entry-point call) from a
    blank map, with every kernel's launch counter from 0, a host clock
    around each frame and each keyframe insertion (ending in a device
    synchronize), and SearchAndFuse's match-kernel launches and
    `compact_landmarks`' calls recorded. Prints and returns the run's
    counts and times; raises PhaseError unless the System ends tracking and
    the match and pose kernels ran on every tracked frame and SearchAndFuse
    once per inserted keyframe."""
    import torch
    from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
    from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused
    from orb_slam3_ros2_tpu_torch.frontend import tracking as trk
    from orb_slam3_ros2_tpu_torch.ops import frontend_packed as fp
    from orb_slam3_ros2_tpu_torch.ops import fused_match as fm
    from orb_slam3_ros2_tpu_torch.runtime import system as sysm
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    fuse_deltas, compactions, insert_ms = [], [], []
    fuse, compact = trk.fuse_map_points, ms.compact_landmarks

    def counted_fuse(*args, **kwargs):
        before = fm.match_window.launches
        out = fuse(*args, **kwargs)
        fuse_deltas.append(fm.match_window.launches - before)
        return out

    def counted_compact(m):
        compactions.append(int(m.n_lm))
        return compact(m)

    insert = slam._insert_keyframe_fused

    def timed_insert(*args, **kwargs):
        torch.cuda.synchronize()
        t_ins = time.perf_counter()
        insert(*args, **kwargs)
        torch.cuda.synchronize()
        insert_ms.append((time.perf_counter() - t_ins) * 1e3)

    slam._insert_keyframe_fused = timed_insert
    counters = (fp.frontend_pass_packed, fm.match_window,
                pose_opt_fused.optimize_pose_fused)
    for fn in counters:
        fn.launches = 0
    frame_ms, inserted = [], []
    trk.fuse_map_points, ms.compact_landmarks = counted_fuse, counted_compact
    try:
        for k in range(n_frames):
            n_kf = int(slam.map.n_kf)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                T = step(k)
            except NotImplementedError as e:  # the LOST branch
                raise PhaseError(f"{label} frame {k}: tracking was lost ({e})")
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            require(T.shape == (4, 4) and np.isfinite(T).all(),
                    f"{label} frame {k}: non-finite pose")
            inserted.append(n_kf > 0 and int(slam.map.n_kf) > n_kf)
    finally:
        trk.fuse_map_points, ms.compact_landmarks = fuse, compact
    launches = dict(zip(("frontend_packed", "fused_match", "pose_opt_fused"),
                        (fn.launches for fn in counters)))
    tracked = sr.tracked_frames(slam)
    init_at = tracked[0] if tracked else None
    plain_ms = [t for k, t in enumerate(frame_ms)
                if k in tracked and k != init_at and not inserted[k]]
    kf_ms = [t for k, t in enumerate(frame_ms) if inserted[k]]
    n_ins = sum(inserted)
    out = dict(
        init_frame=init_at, n_kf=int(slam.map.n_kf),
        n_lm=int(slam.map.lm_valid.sum()), lm_slots_used=int(slam.map.n_lm),
        n_tracked=len(tracked), keyframes_inserted=n_ins,
        compactions=compactions, fuse_launches=fuse_deltas,
        launches=launches,
        frame_ms=statistics.median(plain_ms) if plain_ms else None,
        keyframe_frame_ms=statistics.median(kf_ms) if kf_ms else None,
        insert_ms=statistics.median(insert_ms) if insert_ms else None,
        init_frame_ms=frame_ms[init_at] if tracked else None)
    print(f"{label}: init at frame {init_at}, {out['n_kf']} keyframes "
          f"({n_ins} inserted after init), {out['n_lm']} landmarks "
          f"({out['lm_slots_used']} slots used, compact_landmarks ran "
          f"{len(compactions)} times), {len(tracked)} tracked")
    print(f"{label}: median frame {out['frame_ms']} ms without keyframe, "
          f"{out['keyframe_frame_ms']} ms with a keyframe insertion "
          f"(insertion alone {out['insert_ms']} ms), initializing frame "
          f"{out['init_frame_ms']} ms; launches {launches}, fuse launches "
          f"{fuse_deltas}")
    require(slam.get_tracking_state() == sysm.TrackingState.OK,
            f"{label}: System ends in state {slam.get_tracking_state().name}")
    require(n_ins >= 1 and len(fuse_deltas) == n_ins
            and all(d == 1 for d in fuse_deltas),
            f"{label}: SearchAndFuse match kernel launches {fuse_deltas} for "
            f"{n_ins} keyframe insertions")
    # tracking's own calls: 2 or 3 per tracked frame after the first
    n_track_calls = launches["fused_match"] - sum(fuse_deltas)
    require(n_track_calls >= 2 * (len(tracked) - 1),
            f"{label}: {n_track_calls} tracking match launches")
    require(launches["pose_opt_fused"] == 2 * (len(tracked) - 1),
            f"{label}: pose kernel launched {launches['pose_opt_fused']} "
            f"times for {len(tracked)} tracked frames")
    return out


def run_system(dev, record):
    """System.track_monocular from a blank map over the clip of
    `tools/system_run.py`; `record` receives the run's launch counts.
    Returns a dict of the results. Every check raises PhaseError."""
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    imgs, R_gt, t_gt, ts = sr.render()
    slam = sr.make_system(dev)
    out = drive(slam, lambda k: slam.track_monocular(imgs[k], float(ts[k])),
                sr.N_FRAMES, "system")
    ate = sr.ate(slam, slam.get_frame_trajectory(), R_gt, t_gt)
    ate_raw = sr.ate(slam, slam.get_trajectory(), R_gt, t_gt)
    out.update(ate_m=ate, ate_raw_m=ate_raw)
    print(f"system: ATE {ate:.4f} m (raw {ate_raw:.4f} m)")
    require(out["n_tracked"] > MIN_TRACKED,
            f"only {out['n_tracked']} tracked frames")
    require(out["n_kf"] >= MIN_KF, f"only {out['n_kf']} keyframes")
    require(out["n_lm"] > MIN_LM, f"only {out['n_lm']} landmarks")
    require(ate < ATE_MAX_M, f"ATE {ate:.4f} m >= {ATE_MAX_M}")
    require(ate_raw < ATE_RAW_MAX_M, f"raw ATE {ate_raw:.4f} m")
    require(out["launches"]["frontend_packed"] == sr.N_FRAMES,
            "frontend kernel not on the System path")
    add_launches(record, out["launches"])
    return out


def run_rig(dev, name, frames, record):
    """`track_stereo` / `track_rgbd` from a blank map over `frames`, the
    clip of the `tools/system_run.py` rig `name`, held to the bounds of the
    JAX e2e test it mirrors; `record` receives the run's launch counts.
    Returns a dict of the results. Every check raises PhaseError."""
    from orb_slam3_ros2_tpu_torch.runtime import system as sysm
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    rig = sr.RIGS[name]
    slam = sr.make_rig_system(rig, dev)
    out = dict(config=name, source=rig.source, frames=rig.n_frames,
               width=slam.cam.width, height=slam.cam.height,
               n_features=slam.ex_cfg.n_features)
    out.update(drive(slam, lambda k: sr.track_rig(slam, rig, frames, k),
                     rig.n_frames, name))
    metrics = sr.rig_metrics(slam, frames[2], frames[3])
    out.update(metrics)
    print(f"{name}: ATE {metrics['ate_m']} m, length ratio "
          f"{metrics['length_ratio']}")
    require(metrics["n_tracked"] > rig.min_tracked,
            f"{name}: only {metrics['n_tracked']} tracked frames")
    require(metrics["ate_m"] < rig.ate_max_m,
            f"{name}: ATE {metrics['ate_m']} m >= {rig.ate_max_m}")
    require(abs(metrics["length_ratio"] - 1.0) < rig.length_tol,
            f"{name}: length ratio {metrics['length_ratio']}")
    per_frame = 1 if rig.sensor == sysm.Sensor.RGBD else 2
    launches = out["launches"]
    require(launches["frontend_packed"] == per_frame * rig.n_frames,
            f"{name}: frontend kernel launched {launches['frontend_packed']}"
            f" times for {rig.n_frames} frames")
    add_launches(record, launches)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / PKG / "__init__.py").is_file():
        print(f"chip_smoke: {PKG}/ not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from orb_slam3_ros2_tpu_torch.ops import cuda_lib

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(cuda_lib.load, SOURCES))
    print(f"built {len(SOURCES)} kernel sources in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        for line in cuda_lib.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    from orb_slam3_ros2_tpu_torch.io.synthetic import render_sequence
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    img0 = render_sequence(n_frames=1, width=WIDTH, height=HEIGHT, fx=FX,
                           fy=FY, seed=1)[0][0]
    record = dict(frontend_packed=check_frontend(img0, dev, n_features=1000),
                  fused_match=check_match(dev), pose_opt_fused=check_pose(dev))
    check_frontend_level(img0, dev, record)
    labels = dict(frontend_packed="frontend_packed 752x480",
                  fused_match="fused_match 1000x4096 at 15 px",
                  pose_opt_fused="pose_opt_fused N=1000",
                  fast_nms="fast_nms 752x480 level",
                  blur7="blur7 752x480 level",
                  frontend_pass="frontend_pass 752x480 level")
    for name, r in record.items():
        print_times(f"{labels[name]} (max_abs_err {r['max_abs_err']:.3g})", r)
    print_times("frontend_pass_lite 752x480 level",
                record["frontend_pass"]["lite"])
    print(f"blur7 beside conv2d: conv2d device "
          f"{record['blur7']['library_device_ms']} ms, max |conv2d - blur7| "
          f"{record['blur7']['library_max_abs_diff']:.3g}")
    # the stereo and RGB-D paths' shapes, on the first frames of their clips
    t_render = time.perf_counter()
    clips = {name: sr.RIGS[name].render() for name in RIG_PHASES}
    print(f"rendered the clips of phases 5-7 in "
          f"{time.perf_counter() - t_render:.2f} s")
    shapes = {
        "frontend_packed 1241x376": check_frontend(
            clips["kitti_stereo"][0][0], dev, n_features=2000),
        "frontend_packed 512x512": check_frontend(
            clips["tumvi_stereo"][0][0], dev),
        "fused_match 2000x4096 / 2000x8192": check_match(dev, N=2000),
        "pose_opt_fused N=2000": check_pose(dev, N=2000),
        "pose_opt_fused N=4096": check_pose(dev, N=4096),
    }
    for name, r in shapes.items():
        print_times(f"{name} (max_abs_err {r['max_abs_err']:.3g})", r)
        r.pop("device_ops")
    for name in ("frontend_packed", "fused_match", "pose_opt_fused"):
        record[name]["max_abs_err"] = max(
            [record[name]["max_abs_err"]]
            + [r["max_abs_err"] for k, r in shapes.items()
               if k.startswith(name)])
    ms_k, ms_p = run_slice(dev, record)
    slice_launches = {n: record[n]["launches"] for n in
                      ("frontend_packed", "fused_match", "pose_opt_fused")}
    print(f"slice launches: {slice_launches}")
    system = run_system(dev, record)
    rigs = {name: run_rig(dev, name, clips[name], record)
            for name in RIG_PHASES}

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "wrapper_ms")
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    library_ms=record[name].get("library_ms"),
                    **{k: record[name][k] for k in keys})
               for name, (src, rep) in KERNELS.items()]
    phase2 = {labels[name]: {k: v for k, v in r.items() if k != "device_ops"}
              for name, r in record.items()}
    print(json.dumps({"frame_step_ms": ms_k, "frame_step_plain_ms": ms_p,
                      "slice_launches": slice_launches,
                      "phase2": phase2,
                      "system": system, "phase2_shapes": shapes,
                      "stereo": rigs["kitti_stereo"],
                      "rgbd": rigs["tum1_rgbd"],
                      "fisheye_stereo": rigs["tumvi_stereo"]}))
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
