#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU: every kernel against its
plain version, the per-frame tracking slice, and the monocular System.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. Device: requires CUDA; prints the card's name and power limit, and builds
   the kernels from `orb_slam3_ros2_tpu_torch/csrc/` (one nvcc per source,
   all started together).
2. Kernels: the three tracking-path kernels against their plain PyTorch
   versions on the card, at the shapes the tracking path gives them
   (752x480 over 8 levels; 1000 features x 4096 visible landmarks for
   tracking and x 8192 landmark slots for SearchAndFuse; 1000 pose
   observations), with each one's median time beside its plain version's.
2b. Per-level kernels: `fast_nms`, `blur7`, `frontend_pass` and
   `frontend_pass_lite` on each of the 8 levels of a 752x480 frame's
   pyramid, against their plain versions at the JAX oracle tests'
   tolerances, and one call of each timed on level 0.
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

The last line is {"ok": true, "device": {...}}; the line before it holds the
per-kernel JSON record, and the line before that the card. Imports nothing
of JAX.
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


def time_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Median over `rounds` of the mean time of `reps` back-to-back calls of
    fn(), in ms, from CUDA events on the current stream (after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


# ---------------------------------------------------------------- phase 2

def check_frontend(img, dev, record):
    import torch
    from orb_slam3_ros2_tpu_torch.ops import frontend_packed as fp
    from orb_slam3_ros2_tpu_torch.ops import pyramid as pyr

    levels = pyr.build_pyramid(torch.from_numpy(img).to(dev), 8, 1.2)
    score, keep, blur, raw, layout = fp.frontend_pass_packed(levels)
    s_r, k_r, b_r, r_r, lay_r = fp.frontend_pass_packed_ref(levels)
    torch.cuda.synchronize()
    _, total = fp.pack_layout([tuple(l.shape) for l in levels])
    require(layout == lay_r and tuple(score.shape) == (total, WIDTH),
            f"frontend layout {layout}, canvas {tuple(score.shape)}")
    B = 4
    err = 0.0
    for (r0, h, w) in layout:
        sl = (slice(r0 + B, r0 + h - B), slice(B, w - B))
        ds = (score[sl] - s_r[sl]).abs().max().item()
        require(ds <= 1e-4, f"frontend score differs by {ds} at level {r0}")
        require(bool((keep[sl] == k_r[sl]).all()),
                f"frontend keep differs at level row {r0}")
        db = (blur[sl] - b_r[sl]).abs()
        require(bool((db <= 1e-3 + 1e-5 * b_r[sl].abs()).all()),
                f"frontend blur differs by {db.max().item()} at row {r0}")
        full = (slice(r0, r0 + h), slice(0, w))
        require(bool((raw[full] == r_r[full]).all()), "frontend raw differs")
        err = max(err, ds, db.max().item())
    for (r0, h, w) in layout[:-1]:
        gap = slice(r0 + h, r0 + h + fp.PACK_GAP)
        require(bool((score[gap] == 0).all()) and not bool(keep[gap].any()),
                "frontend gap rows are not zero")
    record["frontend_packed"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: fp.frontend_pass_packed(levels)),
        plain_ms=time_ms(lambda: fp.frontend_pass_packed_ref(levels)))


def _match_case(rng, N, M, radius):
    """Random ±1 descriptors with planted near-duplicates inside the window
    and an exact-duplicate landmark pair (argmin tie, second-best edge)."""
    sa = np.where(rng.integers(0, 2, (N, 256)), 1.0, -1.0).astype(np.float32)
    sb = np.where(rng.integers(0, 2, (M, 256)), 1.0, -1.0).astype(np.float32)
    uva = rng.uniform(0, [WIDTH, HEIGHT], (N, 2)).astype(np.float32)
    uvb = rng.uniform(0, [WIDTH, HEIGHT], (M, 2)).astype(np.float32)
    ma = rng.random(N) > 0.1
    mb = rng.random(M) > 0.1
    for i in range(min(400, N, M // 2)):
        j = 2 * i
        sb[j] = sa[i]
        flips = rng.choice(256, size=rng.integers(0, 8), replace=False)
        sb[j, flips] *= -1.0
        uvb[j] = uva[i] + rng.uniform(-radius / 3, radius / 3, 2)
        ma[i] = mb[j] = True
    sb[M - 1] = sb[M - 2] = sa[7]
    uvb[M - 1] = uvb[M - 2] = uva[7]
    mb[M - 2] = mb[M - 1] = True
    return sa, ma, uva, sb, mb, uvb


def check_match(dev, record):
    """Tracking's shape (1000 x 4096 visible landmarks, 15 px) under every
    ratio/mutual setting, and SearchAndFuse's (1000 x all 8192 landmark
    slots, 4 px, max_dist 45, no ratio test, not mutual)."""
    import torch
    from orb_slam3_ros2_tpu_torch.ops import fused_match as fm
    from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as desc

    def t(x):
        return torch.from_numpy(x).to(dev)

    def case(seed, M, radius):
        sa, ma, uva, sb, mb, uvb = _match_case(np.random.default_rng(seed),
                                               1000, M, radius)
        return (desc.pack_bits(t(sa) > 0), t(ma), t(uva),
                desc.pack_bits(t(sb) > 0), t(mb), t(uvb), radius)

    args = case(0, 4096, 15.0)
    settings = [(args, dict(ratio=ratio, mutual=mutual))
                for ratio in (0.9, None) for mutual in (True, False)]
    settings.append((case(2, 8192, 4.0),
                     dict(max_dist=45.0, ratio=None, mutual=False)))
    err = 0.0
    for a, kw in settings:
        got = fm.match_window(*a, **kw)
        ref = fm.match_window_ref(*a, **kw)
        torch.cuda.synchronize()
        what = f"M={a[3].shape[0]}, radius {a[6]}, {kw}"
        n_ok = int(ref.valid.sum())
        require(n_ok > 300, f"match case {what} has only {n_ok} matches")
        require(bool((got.valid == ref.valid).all())
                and bool((got.idx == ref.idx).all()),
                f"match idx/valid differ ({what})")
        v = ref.valid
        err = max(err, (got.dist[v] - ref.dist[v]).abs().max().item())
    require(err == 0.0, f"match distances differ by {err}")
    record["fused_match"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: fm.match_window(*args)),
        plain_ms=time_ms(lambda: fm.match_window_ref(*args)))


def check_pose(dev, record):
    import torch
    from orb_slam3_ros2_tpu_torch.backend import pose_opt, pose_opt_fused
    from orb_slam3_ros2_tpu_torch.geom import lie

    rng = np.random.default_rng(1)
    N = 1000
    X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N),
                  rng.uniform(4, 10, N)], -1).astype(np.float32)
    fx = fy = 400.0
    cx, cy = 320.0, 240.0
    R_true = lie.so3_exp(torch.tensor([0.05, -0.1, 0.02])).numpy()
    t_true = np.array([0.1, -0.05, 0.2], np.float32)
    xc = X @ R_true.T + t_true
    uv = np.stack([fx * xc[:, 0] / xc[:, 2] + cx,
                   fy * xc[:, 1] / xc[:, 2] + cy], -1).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    out = rng.random(N) < 0.3
    uv[out] += rng.uniform(-80, 80, (out.sum(), 2)).astype(np.float32)
    mask = rng.random(N) > 0.05
    invs2 = (1.2 ** (-2.0 * rng.integers(0, 8, N))).astype(np.float32)

    def t(x):
        return torch.from_numpy(np.asarray(x)).to(dev)

    args = (torch.eye(3, device=dev), torch.zeros(3, device=dev), t(X), t(uv),
            t(invs2), t(mask), fx, fy, cx, cy)
    got = pose_opt_fused.optimize_pose_fused(*args)
    ref = pose_opt.optimize_pose(*args)
    torch.cuda.synchronize()
    dR = (got.R - ref.R).abs().max().item()
    dt = (got.t - ref.t).abs().max().item()
    require(dR <= 5e-5 and dt <= 5e-4, f"pose differs: dR {dR}, dt {dt}")
    require(bool((got.inliers == ref.inliers).all())
            and int(got.n_inliers) == int(ref.n_inliers),
            "pose inlier sets differ")
    require(np.abs(got.R.cpu().numpy() - R_true).max() < 2e-3
            and np.abs(got.t.cpu().numpy() - t_true).max() < 1e-2,
            "pose kernel did not converge to the true pose")
    record["pose_opt_fused"] = dict(
        max_abs_err=max(dR, dt),
        ms=time_ms(lambda: pose_opt_fused.optimize_pose_fused(*args)),
        plain_ms=time_ms(lambda: pose_opt.optimize_pose(*args)))


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
    record["fast_nms"] = dict(
        launches=launches[0], max_abs_err=err["fast_nms"],
        ms=time_ms(lambda: fl.fast_nms(level0)),
        plain_ms=time_ms(lambda: fl.fast_nms_ref(level0)))
    record["blur7"] = dict(
        launches=launches[1], max_abs_err=err["blur7"],
        ms=time_ms(lambda: fl.blur7(level0)),
        plain_ms=time_ms(lambda: fl.blur7_ref(level0)))
    record["frontend_pass"] = dict(
        launches=launches[2] + launches[3], max_abs_err=err["frontend_pass"],
        ms=time_ms(lambda: fl.frontend_pass(level0)),
        plain_ms=time_ms(lambda: fl.frontend_pass_ref(level0)),
        lite_ms=time_ms(lambda: fl.frontend_pass_lite(level0)),
        lite_plain_ms=time_ms(lambda: fl.frontend_pass_lite_ref(level0)))


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
    for name, n_l in launches.items():
        record[name]["launches"] = n_l
    return ms_k, ms_p


# ---------------------------------------------------------------- phase 4

def run_system(dev, record):
    """System.track_monocular from a blank map over the clip of
    `tools/system_run.py`; `record` receives the run's launch counts.
    Returns a dict of the results. Every check raises PhaseError."""
    import torch
    from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused
    from orb_slam3_ros2_tpu_torch.frontend import tracking as trk
    from orb_slam3_ros2_tpu_torch.ops import frontend_packed as fp
    from orb_slam3_ros2_tpu_torch.ops import fused_match as fm
    from orb_slam3_ros2_tpu_torch.runtime import system as sysm
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    imgs, R_gt, t_gt, ts = sr.render()
    slam = sr.make_system(dev)
    # SearchAndFuse must reach the match kernel: count its launches per call
    fuse_deltas = []
    fuse = trk.fuse_map_points

    def counted_fuse(*args, **kwargs):
        before = fm.match_window.launches
        out = fuse(*args, **kwargs)
        fuse_deltas.append(fm.match_window.launches - before)
        return out

    insert_ms = []
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
    trk.fuse_map_points = counted_fuse
    try:
        for k in range(sr.N_FRAMES):
            n_kf = int(slam.map.n_kf)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                T = slam.track_monocular(imgs[k], float(ts[k]))
            except NotImplementedError as e:  # the LOST branch
                raise PhaseError(f"frame {k}: tracking was lost ({e})")
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            require(T.shape == (4, 4) and np.isfinite(T).all(),
                    f"frame {k}: non-finite pose")
            inserted.append(int(slam.map.n_kf) > n_kf
                            and slam.tracking_log[-1]["state"] == 1 and n_kf > 0)
    finally:
        trk.fuse_map_points = fuse
    launches = dict(zip(("frontend_packed", "fused_match", "pose_opt_fused"),
                        (fn.launches for fn in counters)))
    tracked = sr.tracked_frames(slam)
    init_at = tracked[0] if tracked else None
    n_kf = int(slam.map.n_kf)
    n_lm = int(slam.map.lm_valid.sum())
    require(slam.get_tracking_state() == sysm.TrackingState.OK,
            f"System ends in state {slam.get_tracking_state().name}")
    require(len(tracked) > MIN_TRACKED, f"only {len(tracked)} tracked frames")
    ate = sr.ate(slam, slam.get_frame_trajectory(), R_gt, t_gt)
    ate_raw = sr.ate(slam, slam.get_trajectory(), R_gt, t_gt)
    n_ins = sum(inserted)
    # tracking's own calls: 2 or 3 per tracked frame after the first
    n_track_calls = launches["fused_match"] - sum(fuse_deltas)
    plain_ms = [ms for k, ms in enumerate(frame_ms)
                if k in tracked and k != init_at and not inserted[k]]
    kf_ms = [ms for k, ms in enumerate(frame_ms) if inserted[k]]
    out = dict(init_frame=init_at, n_kf=n_kf, n_lm=n_lm,
               n_tracked=len(tracked), ate_m=ate, ate_raw_m=ate_raw,
               keyframes_inserted=n_ins, fuse_launches=fuse_deltas,
               launches=launches,
               frame_ms=statistics.median(plain_ms) if plain_ms else None,
               keyframe_frame_ms=statistics.median(kf_ms) if kf_ms else None,
               insert_ms=statistics.median(insert_ms) if insert_ms else None,
               init_frame_ms=frame_ms[init_at] if tracked else None)
    print(f"system: init at frame {init_at}, {n_kf} keyframes "
          f"({n_ins} inserted after init), {n_lm} landmarks, "
          f"{len(tracked)} tracked, ATE {ate:.4f} m (raw {ate_raw:.4f} m)")
    print(f"system: median frame {out['frame_ms']} ms without keyframe, "
          f"{out['keyframe_frame_ms']} ms with a keyframe insertion "
          f"(insertion alone {out['insert_ms']} ms), initializing frame "
          f"{out['init_frame_ms']} ms; launches {launches}, fuse launches "
          f"{fuse_deltas}")
    require(n_kf >= MIN_KF, f"only {n_kf} keyframes")
    require(n_lm > MIN_LM, f"only {n_lm} landmarks")
    require(ate < ATE_MAX_M, f"ATE {ate:.4f} m >= {ATE_MAX_M}")
    require(ate_raw < ATE_RAW_MAX_M, f"raw ATE {ate_raw:.4f} m")
    require(len(fuse_deltas) == n_ins, f"{len(fuse_deltas)} SearchAndFuse "
            f"calls for {n_ins} keyframe insertions")
    require(all(d == 1 for d in fuse_deltas),
            f"SearchAndFuse match kernel launches {fuse_deltas}")
    require(n_track_calls >= 2 * (len(tracked) - 1),
            f"{n_track_calls} tracking match launches")
    require(launches["frontend_packed"] == sr.N_FRAMES,
            "frontend kernel not on the System path")
    require(launches["pose_opt_fused"] == 2 * (len(tracked) - 1),
            "pose kernel not on the System path")
    for name, n_l in launches.items():
        record[name]["launches"] = n_l
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

    record = {}
    img0 = render_sequence(n_frames=1, width=WIDTH, height=HEIGHT, fx=FX,
                           fy=FY, seed=1)[0][0]
    check_frontend(img0, dev, record)
    check_match(dev, record)
    check_pose(dev, record)
    check_frontend_level(img0, dev, record)
    for name, r in record.items():
        print(f"{name}: max_abs_err {r['max_abs_err']:.3g}, kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    ms_k, ms_p = run_slice(dev, record)
    slice_launches = {n: record[n]["launches"] for n in
                      ("frontend_packed", "fused_match", "pose_opt_fused")}
    print(f"slice launches: {slice_launches}")
    system = run_system(dev, record)

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=record[name]["launches"],
                    max_abs_err=record[name]["max_abs_err"],
                    ms=record[name]["ms"], plain_ms=record[name]["plain_ms"])
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"frame_step_ms": ms_k, "frame_step_plain_ms": ms_p,
                      "slice_launches": slice_launches,
                      "frontend_pass_lite_ms": record["frontend_pass"]["lite_ms"],
                      "frontend_pass_lite_plain_ms":
                          record["frontend_pass"]["lite_plain_ms"],
                      "system": system}))
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
