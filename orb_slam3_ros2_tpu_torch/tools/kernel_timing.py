"""Timing of the port's kernels on the card, and one kernel of any checkout
timed alone.

`time_ms` takes CUDA events around back-to-back calls (what a caller pays,
host enqueue included); `device_events` reads the kernels' own device time
from torch.profiler. `chip_smoke.py` times every kernel with both.
`pose_case` makes the pose LM's test case (numpy, from a seed).

Run as a script, it times one kernel of the checkout at `--root` (this
repository at any commit, e.g. unpacked with `git archive` into a
directory that `.gitignore` lists), built from that checkout's sources:

    python3 orb_slam3_ros2_tpu_torch/tools/kernel_timing.py --root DIR \\
        [--label NAME] [--kernel frontend_packed|pose_opt_fused]
        [--shapes 752x480 1241x376 512x512] [--points 1000 2000]

and prints one JSON line per shape: device ms per launch of the kernel
(profiler, 50 calls), the other device ops of those calls, and the
wrapper's ms. `frontend_packed` (the default) runs on the 8-level pyramid
of a rendered frame of each `--shapes`; `pose_opt_fused` on `pose_case`
at each `--points`. Run two checkouts in one call, in turns (A, B, B, A),
to compare them on one card.
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


def device_events(fn, names, calls: int = 20):
    """Run fn() `calls` times under torch.profiler (after a warm-up).
    Returns (device ms per call of the kernels whose name holds one of
    `names`, or None if the profiler saw none; {device op name: count} of
    every kernel, copy and memset of the window). Each named kernel must
    run once a call: a call's time is the sum of their mean durations, so
    an event the profiler drops at the window's edge does not count."""
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
    ops, us = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ops[e.name] = ops.get(e.name, 0) + 1
            if any(n in e.name for n in names):
                us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us()
    per_call_us = sum(t / ops[name] for name, t in us.items())
    return (per_call_us / 1e3 if us else None), ops


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose orb_slam3_ros2_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--kernel", default="frontend_packed",
                    choices=("frontend_packed", "pose_opt_fused"))
    ap.add_argument("--shapes", nargs="+",
                    default=["752x480", "1241x376", "512x512"])
    ap.add_argument("--points", nargs="+", type=int, default=[1000, 2000])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        ap.error("times the card: no CUDA device is available")
    sys.path.insert(0, args.root)
    if args.kernel == "pose_opt_fused":
        return time_pose(args)
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


if __name__ == "__main__":
    sys.exit(main())
