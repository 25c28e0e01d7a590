"""Timing of the port's kernels on the card, and the packed frontend of any
checkout timed alone.

`time_ms` takes CUDA events around back-to-back calls (what a caller pays,
host enqueue included); `device_events` reads the kernels' own device time
from torch.profiler. `chip_smoke.py` times every kernel with both.

Run as a script, it times the packed frontend of the checkout at `--root`
(this repository at any commit, e.g. unpacked with `git archive` into a
directory that `.gitignore` lists), built from that checkout's sources:

    python3 orb_slam3_ros2_tpu_torch/tools/kernel_timing.py --root DIR \\
        [--label NAME] [--shapes 752x480 1241x376 512x512]

and prints one JSON line per shape: device ms per launch of
`frontend_packed_kernel` (profiler, 50 calls), the other device ops of
those calls, and the wrapper's ms, on the 8-level pyramid of a rendered
frame. Run two checkouts in one call, in turns (A, B, B, A), to compare
them on one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose orb_slam3_ros2_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--shapes", nargs="+",
                    default=["752x480", "1241x376", "512x512"])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        ap.error("times the card: no CUDA device is available")
    sys.path.insert(0, args.root)
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


if __name__ == "__main__":
    sys.exit(main())
