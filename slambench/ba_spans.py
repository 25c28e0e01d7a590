"""The profiled slice reduced to the program's bundle-adjustment spans.

While a profiler runs, the program's BA opens `ba.*` host spans
(`orb_slam3_ros2_tpu_torch/utils/tracing.py` lists them): one
`ba.iteration` an LM iteration, holding `ba.reduce`, `ba.solve_cameras`
and the other stages. The profiler records each as a user annotation on
the host, and, for the device work launched directly inside it, a device
annotation on the device's clock from that work's first start to its last
end. These reductions read only the slice's events, (name, category,
start_us, dur_us); each gives None where the slice has no `ba.iteration`
span (a program without the spans) or no device operation (a run without
a card).

Where the profiler's events carry no activity type (torch 2.11, the
card's), `harness.Slice` files a device annotation under
"user_annotation", as a host span, and a runtime call under "cpu_op". The
device annotations are then found through the launches: on the BA's one
stream the k-th launch call enqueues the k-th device operation, so each
host span's operations are known, and the annotation of the same name
that starts where the first of them starts and ends where the last ends
is that span's device annotation. That finds the device annotation of a
span that holds no launching span: each stage of the BA. `ba.iteration`
launches nothing itself, so it has none; those of `ba.local` and
`ba.global` (a fill, the window) are not told apart, and no reader reads
them.
"""

from __future__ import annotations

import bisect
import re
from typing import List, Optional

from slambench import harness

ITERATION = "ba.iteration"
LAUNCH = re.compile(r"cu(da)?(LaunchKernel|Memcpy|Memset)")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op")
# an annotation's end is its start plus its duration, two floats; a float
# microsecond near 1.8e15 (Unix-epoch nanoseconds over 1e3) is rounded to
# 0.25 us
END_TOL_US = 0.5


def paired(events) -> Optional[tuple]:
    """(launch call times, device operations), the k-th call enqueuing the
    k-th operation, both in order; None where their counts differ."""
    calls = launch_times(events)
    ops = harness.device_intervals(events)
    return (calls, ops) if len(calls) == len(ops) else None


def annotations(events):
    """(host, device): the slice's annotations, (name, start, end) each,
    by start. Without the "gpu_user_annotation" category, the user
    annotations that are device annotations are told apart through the
    launches (the module's docstring); without paired launches they all
    count as host spans."""
    device = [(n, s, s + d) for n, c, s, d in events
              if c == "gpu_user_annotation"]
    users = [(n, s, s + d) for n, c, s, d in events
             if c == "user_annotation"]
    pairs = paired(events)
    if not device and pairs:
        calls, ops = pairs
        by_start = {(n, s): e for n, s, e in users}
        found = set()
        for n, s, e in users:
            lo = bisect.bisect_left(calls, s)
            hi = bisect.bisect_left(calls, e)
            if hi > lo:
                first, last = ops[lo][0], ops[hi - 1][1]
                end = by_start.get((n, first))
                if end is not None and abs(end - last) <= END_TOL_US:
                    found.add((n, first))
        device = [u for u in users if (u[0], u[1]) in found]
        users = [u for u in users if (u[0], u[1]) not in found]
    return (sorted(users, key=lambda x: x[1]),
            sorted(device, key=lambda x: x[1]))


def host_spans(events, name: str) -> List[tuple]:
    """(start, end) of the host spans named `name`, by start."""
    return [(s, e) for n, s, e in annotations(events)[0] if n == name]


def launch_times(events) -> List[float]:
    """Host start of each launch call (a kernel launch, copy or fill
    enqueued through the runtime or the driver), in order."""
    return sorted(s for n, c, s, _ in events
                  if c in HOST_CATS and LAUNCH.match(n))


def inside(t: float, spans: List[tuple]) -> bool:
    """Whether time t lies in one of `spans` (sorted, disjoint: one name's
    spans never nest in each other)."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t < spans[i][1]


def union(intervals) -> List[tuple]:
    """The sorted disjoint union of (start, end) intervals."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def overlap_us(a: List[tuple], b: List[tuple]) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def iterations(events) -> int:
    """The program's count of LM iterations in the slice."""
    return len(host_spans(events, ITERATION))


def _readable(events) -> bool:
    return iterations(events) > 0 and bool(harness.device_intervals(events))


def device_us(events, name: str) -> Optional[float]:
    """Device busy time inside the spans named `name`: the union of the
    device operations clipped to the span's device annotations. Where the
    slice has no device annotation named `name`, the operations enqueued
    by the launch calls that lie in a `name` host span are summed (the
    k-th call enqueues the k-th operation: the BA runs on one stream, in
    order); None where the counts of calls and operations differ."""
    if not _readable(events):
        return None
    ops = harness.device_intervals(events)
    host, device = annotations(events)
    gpu = [(s, e) for n, s, e in device if n == name]
    if gpu:
        return overlap_us(union(ops), union(gpu))
    pairs = paired(events)
    if pairs is None:
        return None
    spans = [(s, e) for n, s, e in host if n == name]
    return sum(e - s for s, e in union(
        op for t, op in zip(*pairs) if inside(t, spans)))


def launches(events) -> Optional[int]:
    """Launch calls whose host start lies in a `ba.iteration` span."""
    if not _readable(events):
        return None
    its = host_spans(events, ITERATION)
    return sum(1 for t in launch_times(events) if inside(t, its))


def idle_us(events) -> Optional[float]:
    """Device idle time that begins while the host is inside a
    `ba.iteration` span: the device's idle gaps (between the union of its
    operations) filed, as `harness.breakdown` files them, under the
    innermost host span at the gap's start, summed over those filed under
    `ba.iteration` or a span nested in it. Spans of one thread nest, so
    those are the gaps whose start lies in a `ba.iteration` span."""
    if not _readable(events):
        return None
    its = host_spans(events, ITERATION)
    busy = union(harness.device_intervals(events))
    return sum(s - prev_end for (_, prev_end), (s, _) in zip(busy, busy[1:])
               if inside(prev_end, its))


def per_iteration_ms(events, us: Optional[float]) -> Optional[float]:
    """`us` microseconds a slice over its iterations, in ms."""
    return None if us is None else us / 1e3 / iterations(events)
