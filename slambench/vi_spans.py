"""The profiled slice reduced to the program's visual-inertial BA spans.

While a profiler runs, the program's inertial BA opens `vi.*` host spans
(`orb_slam3_ros2_tpu_torch/utils/tracing.py` lists them): one
`vi.iteration` an LM iteration, holding the stages `vi.reduce`,
`vi.inertial`, `vi.solve`, `vi.back_substitute` and `vi.cost`. The
profiler records each stage as a user annotation on the host and, for the
device work launched inside it, a device annotation on the device's clock
from that work's first start to its last end.

A span's device time is read by time: the union of the device operations
clipped to the span's device annotations. That needs no pairing of launch
calls with operations, so it holds where a stage replays a CUDA graph (one
graph launch, many operations). `Slice` files the device annotations
apart where the profiler's events carry no activity type (the card's
torch 2.11): by their device, which is the card's. In a slice that still
files them with the host spans (`harness.Slice`), they are told apart
through the launch pairing of `ba_spans.annotations`.

Each reduction gives None where the slice has no `vi.iteration` span (a
program without the spans) or no device operation (a run without a card).
"""

from __future__ import annotations

import re
from typing import Iterable, Optional

from slambench import ba_spans, harness

ITERATION = "vi.iteration"
STAGES = ("vi.reduce", "vi.inertial", "vi.solve", "vi.back_substitute",
          "vi.cost")
# launch calls of the host: kernels, copies, fills and graph launches
LAUNCH = re.compile(r"cu(da)?(LaunchKernel|Memcpy|Memset|GraphLaunch)")
DEVICE_ANNOTATION = "gpu_user_annotation"


class Slice(harness.Slice):
    """`harness.Slice` that files a user annotation on the card's clock as
    a device annotation where the profiler gives its events no activity
    type."""

    def stop(self, units: int):
        prof = self._prof
        super().stop(units)
        evs = prof.profiler.kineto_results.events()
        if evs and hasattr(evs[0], "activity_type"):
            return
        self.events = [
            (n, DEVICE_ANNOTATION if c == "user_annotation"
             and "CUDA" in str(e.device_type()) else c, s, d)
            for (n, c, s, d), e in zip(self.events, evs)]


def annotations(events):
    """(host, device): the slice's annotations, (name, start, end) each,
    by start."""
    if any(c == DEVICE_ANNOTATION for _, c, _, _ in events):
        host = [(n, s, s + d) for n, c, s, d in events
                if c == "user_annotation"]
        dev = [(n, s, s + d) for n, c, s, d in events
               if c == DEVICE_ANNOTATION]
        return (sorted(host, key=lambda x: x[1]),
                sorted(dev, key=lambda x: x[1]))
    return ba_spans.annotations(events)


def iterations(events) -> int:
    """The program's count of VI LM iterations in the slice."""
    return sum(1 for n, _, _ in annotations(events)[0] if n == ITERATION)


def _readable(events) -> bool:
    return iterations(events) > 0 and bool(harness.device_intervals(events))


def device_us(events, names: Iterable[str]) -> Optional[float]:
    """Device busy time inside the device annotations of the spans named
    in `names`: the union of the device operations clipped to the union of
    those annotations; None where the slice has none of them."""
    if not _readable(events):
        return None
    names = set(names)
    gpu = [(s, e) for n, s, e in annotations(events)[1] if n in names]
    if not gpu:
        return None
    return ba_spans.overlap_us(
        ba_spans.union(harness.device_intervals(events)),
        ba_spans.union(gpu))


def launches(events) -> Optional[int]:
    """Launch calls (kernels, copies, fills, graph launches) whose host
    start lies in a `vi.iteration` span."""
    if not _readable(events):
        return None
    its = [(s, e) for n, s, e in annotations(events)[0] if n == ITERATION]
    calls = sorted(s for n, c, s, _ in events
                   if c in ba_spans.HOST_CATS and LAUNCH.match(n))
    return sum(1 for t in calls if ba_spans.inside(t, its))


def stage_ms(readings, names) -> Optional[float]:
    """Device ms an iteration inside the spans `names`, read from the
    run's profiled slice."""
    sl = readings.get("slice")
    us = None if sl is None else device_us(sl.events, names)
    return None if us is None else us / 1e3 / iterations(sl.events)
