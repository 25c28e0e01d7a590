"""Timing of the port's kernels on the card, and one kernel of any checkout
timed alone.

`time_ms` takes CUDA events around back-to-back calls (what a caller pays,
host enqueue included); `device_events` reads the kernels' own device time
from torch.profiler. `chip_smoke.py` times every kernel with both.
`pose_case` and `match_case` make the pose LM's and the windowed match's
test cases (numpy, from a seed).

Run as a script, it times one kernel of the checkout at `--root` (this
repository at any commit, e.g. unpacked with `git archive` into a
directory that `.gitignore` lists), built from that checkout's sources:

    python3 orb_slam3_ros2_tpu_torch/tools/kernel_timing.py --root DIR \\
        [--label NAME] [--kernel frontend_packed|pose_opt_fused|fused_match]
        [--shapes 752x480 1241x376 512x512] [--points 1000 2000]
        [--matches track:1000x4096 track:2000x4096 fuse:1000x8192]

and prints one JSON line per shape: device ms per launch of the kernel
(profiler, 50 calls), the other device ops of those calls, and the
wrapper's ms. `frontend_packed` (the default) runs on the 8-level pyramid
of a rendered frame of each `--shapes`; `pose_opt_fused` on `pose_case`
at each `--points`; `fused_match` on `match_case` at each `--matches`
(`track`: 15 px, ratio 0.9, mutual; `fuse`: SearchAndFuse's 4 px,
max_dist 45, no ratio, not mutual), with each match kernel's device time
apart and the device time of every op of a call. Run two checkouts in one
call, in turns (A, B, B, A), to compare them on one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np


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


def kernel_events(fn, calls: int = 20) -> dict:
    """{device op name: [µs of each event]} of every kernel, copy and
    memset while fn() runs `calls` times under torch.profiler (after a
    warm-up)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            events.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return events


def device_events(fn, names, calls: int = 20):
    """Run fn() `calls` times under torch.profiler (after a warm-up).
    Returns (device ms per call of the kernels whose name holds one of
    `names`, or None if the profiler saw none; {device op name: count} of
    every kernel, copy and memset of the window). Each named kernel must
    run once a call: a call's time is the sum of their mean durations, so
    an event the profiler drops at the window's edge does not count."""
    events = kernel_events(fn, calls)
    us = [sum(t) / len(t) for name, t in events.items()
          if any(n in name for n in names)]
    return ((sum(us) / 1e3 if us else None),
            {name: len(t) for name, t in events.items()})


def pose_case(N: int, seed: int, outlier_frac: float = 0.3):
    """N observations of random points 4-10 m ahead under a known pose,
    with 0.5 px noise, `outlier_frac` of them moved by up to 80 px, 5%
    masked out and 8 pyramid levels' weights (the case of
    tests/test_fused_kernels.py). Returns numpy (X, uv, invs2, mask), the
    intrinsics (fx, fy, cx, cy) and the true (R, t)."""
    from orb_slam3_ros2_tpu_torch.geom import lie
    import torch

    rng = np.random.default_rng(seed)
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
    out = rng.random(N) < outlier_frac
    uv[out] += rng.uniform(-80, 80, (out.sum(), 2)).astype(np.float32)
    mask = rng.random(N) > 0.05
    invs2 = (1.2 ** (-2.0 * rng.integers(0, 8, N))).astype(np.float32)
    return X, uv, invs2, mask, (fx, fy, cx, cy), R_true, t_true


# the match cases' image (752x480, EuRoC) and call settings: tracking's
# first match (frontend/tracking.py), SearchAndFuse's, and relocalization's
# tries from the last pose and from a BoW keyframe (runtime/system.py)
MATCH_WIDTH, MATCH_HEIGHT = 752, 480
MATCH_SETTINGS = {
    "track": dict(radius=15.0, max_dist=50.0, ratio=0.9, mutual=True),
    "fuse": dict(radius=4.0, max_dist=45.0, ratio=None, mutual=False),
    "reloc80": dict(radius=80.0, max_dist=45.0, ratio=0.9, mutual=True),
    "reloc60": dict(radius=60.0, max_dist=45.0, ratio=0.9, mutual=True),
}


def match_case(N: int, M: int, radius: float, seed: int):
    """Random ±1 descriptors (N, 256) and (M, 256) at uniform positions of
    a 752x480 image, 10% masked on each side, with up to 400 planted
    near-duplicates (0-7 flipped bits) inside a third of the window and an
    exact-duplicate landmark pair (an argmin tie and the second best's
    edge). Returns numpy (signs_a, mask_a, uv_a, signs_b, mask_b, uv_b)."""
    rng = np.random.default_rng(seed)
    sa = np.where(rng.integers(0, 2, (N, 256)), 1.0, -1.0).astype(np.float32)
    sb = np.where(rng.integers(0, 2, (M, 256)), 1.0, -1.0).astype(np.float32)
    size = [MATCH_WIDTH, MATCH_HEIGHT]
    uva = rng.uniform(0, size, (N, 2)).astype(np.float32)
    uvb = rng.uniform(0, size, (M, 2)).astype(np.float32)
    ma = rng.random(N) > 0.1
    mb = rng.random(M) > 0.1
    for i in range(min(400, N, M // 2)):
        j = 2 * i
        sb[j] = sa[i]
        flips = rng.choice(256, size=rng.integers(0, 8), replace=False)
        sb[j, flips] *= -1.0
        uvb[j] = uva[i] + rng.uniform(-radius / 3, radius / 3, 2)
        ma[i] = mb[j] = True
    if N > 7 and M > 1:
        sb[M - 1] = sb[M - 2] = sa[7]
        uvb[M - 1] = uvb[M - 2] = uva[7]
        mb[M - 2] = mb[M - 1] = True
    return sa, ma, uva, sb, mb, uvb


def match_tensors(N: int, M: int, setting: str, seed: int, device):
    """`match_case` for one of MATCH_SETTINGS on `device`: the six
    `match_window` arguments (bits packed) and its keyword arguments."""
    import torch
    from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as desc

    kw = dict(MATCH_SETTINGS[setting])
    sa, ma, uva, sb, mb, uvb = (torch.from_numpy(a).to(device) for a in
                                match_case(N, M, kw["radius"], seed))
    return (desc.pack_bits(sa > 0), ma, uva, desc.pack_bits(sb > 0), mb,
            uvb), kw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose orb_slam3_ros2_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--kernel", default="frontend_packed",
                    choices=("frontend_packed", "pose_opt_fused",
                             "fused_match"))
    ap.add_argument("--shapes", nargs="+",
                    default=["752x480", "1241x376", "512x512"])
    ap.add_argument("--points", nargs="+", type=int, default=[1000, 2000])
    ap.add_argument("--matches", nargs="+",
                    default=["track:1000x4096", "track:2000x4096",
                             "fuse:1000x8192"])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        ap.error("times the card: no CUDA device is available")
    sys.path.insert(0, args.root)
    if args.kernel == "pose_opt_fused":
        return time_pose(args)
    if args.kernel == "fused_match":
        return time_match(args)
    from orb_slam3_ros2_tpu_torch.io.synthetic import render_sequence
    from orb_slam3_ros2_tpu_torch.ops import frontend_packed as fp
    from orb_slam3_ros2_tpu_torch.ops import pyramid as pyr

    dev = torch.device("cuda", 0)
    for shape in args.shapes:
        width, height = (int(v) for v in shape.split("x"))
        img = render_sequence(n_frames=1, width=width, height=height,
                              fx=0.61 * width, fy=0.61 * width, seed=1)[0][0]
        levels = pyr.build_pyramid(torch.from_numpy(img).to(dev), 8, 1.2)
        dev_ms, ops = device_events(lambda: fp.frontend_pass_packed(levels),
                                    ("frontend_packed_kernel",), calls=50)
        print(json.dumps(dict(
            label=args.label or args.root, shape=shape, device_ms=dev_ms,
            device_ops_of_50_calls=ops,
            wrapper_ms=time_ms(lambda: fp.frontend_pass_packed(levels)))))
    return 0


def time_pose(args) -> int:
    """The pose LM of the checkout at --root on `pose_case` at each N."""
    import torch
    from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused

    dev = torch.device("cuda", 0)
    for N in args.points:
        X, uv, invs2, mask, K, _, _ = pose_case(N, seed=N)
        call_args = [torch.from_numpy(a).to(dev) for a in (X, uv, invs2, mask)]
        R0, t0 = torch.eye(3, device=dev), torch.zeros(3, device=dev)

        def call():
            return pose_opt_fused.optimize_pose_fused(R0, t0, *call_args, *K)

        dev_ms, ops = device_events(call, ("pose_opt_kernel",), calls=50)
        print(json.dumps(dict(
            label=args.label or args.root, kernel=args.kernel, points=N,
            device_ms=dev_ms, device_ops_of_50_calls=ops,
            wrapper_ms=time_ms(call))))
    return 0


def time_match(args) -> int:
    """The windowed match of the checkout at --root on `match_case` at each
    `setting:NxM`: the match kernels' device time (each apart and summed),
    every device op of a call, and the wrapper's time."""
    import torch
    from orb_slam3_ros2_tpu_torch.ops import fused_match as fm

    dev = torch.device("cuda", 0)
    calls = 50
    for case in args.matches:
        setting, shape = case.split(":")
        N, M = (int(v) for v in shape.split("x"))
        call_args, kw = match_tensors(N, M, setting, N + M, dev)

        def call():
            return fm.match_window(*call_args, **kw)

        events = kernel_events(call, calls)
        split = {name: sum(t) / len(t) for name, t in events.items()
                 if "match_" in name}
        print(json.dumps(dict(
            label=args.label or args.root, kernel=args.kernel, case=case,
            device_ms=sum(split.values()) / 1e3 if split else None,
            kernel_us=split,
            all_ops_device_us=sum(map(sum, events.values())) / calls,
            device_ops_of_50_calls={n: len(t) for n, t in events.items()},
            wrapper_ms=time_ms(call))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
