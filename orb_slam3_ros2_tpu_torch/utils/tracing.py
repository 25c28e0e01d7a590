"""Per-stage wall-clock tracing and a torch.profiler capture.

`StageTracer` is copied from `orb_slam3_ros2_tpu/utils/tracing.py` (plain
Python), with one addition (a stage is a profiler span while a profiler
runs, below):

    with trace.stage("track_frame"):
        ...
    trace.report()   # {"track_frame": {"n":..., "mean_ms":..., "p95_ms":...}}

A stage reads the host clock around work that the System enqueues on the
device, as the JAX stages read it around asynchronous dispatch. It never
synchronizes the device itself: a stage's time includes the device work
only where the code inside it waits for a result anyway (the System's
stages that fetch a summary, such as `track_frame` and `mapping_fused`).
The rest of a stage's device work lands in whichever later stage waits.
For device time, `capture(logdir)` wraps `torch.profiler.profile` (CPU and
CUDA activities) and writes a Chrome trace; it replaces the JAX
`jax.profiler.trace` capture. While a profiler runs, each stage is also a
`record_function` span of its name (one flag read when none runs), and
`stage_summary(trace)` counts the kernel launches each span issued and
the device time of those kernels.

`span(name)` is that profiler half alone, for code that holds no tracer.
The bundle adjustment opens these spans, nested as its calls nest:

    ba.global            frontend/tracking.py global_ba
      ba.local           frontend/tracking.py local_ba (also the
                         insertion's local BA on the frame path)
        ba.obs_table     the observation table and the problem's gather
        ba.iteration     backend/ba.py bundle_adjust, one LM iteration
          ba.refresh_weights   the chi2 re-gate, on the gated iterations
          ba.reduce            schur.schur_reduce
          ba.solve_cameras     schur.solve_cameras
          ba.back_substitute   the landmark step and the pose update
          ba.cost              the candidate's cost and the LM accept
        ba.cost          the final cost
        ba.write_back    the pose scatters and the landmark select

and, inside a stage, `ba.graph_capture` where the stage's CUDA graph is
captured (`backend/stage_graphs.py`; on the card a stage otherwise
replays its graph inside its span).

They are read in a capture's Chrome trace (`stage_summary`) and by the
benchmark's backend-BA metrics (`slambench/ba_spans.py`).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch


@contextlib.contextmanager
def span(name: str):
    """A `torch.profiler.record_function` range named `name` while a
    profiler runs; otherwise one flag read. It adds no device
    synchronization, so the work inside runs the same either way."""
    if torch.autograd._profiler_enabled():
        with torch.profiler.record_function(name):
            yield
    else:
        yield


class StageTracer:
    """Aggregating wall-clock timer keyed by stage name. Negligible overhead
    (~1 µs/stage): two perf_counter calls and a list append."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self._samples[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        if self.enabled:
            self._samples[name].append(seconds)

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in sorted(self._samples.items()):
            s = sorted(xs)
            n = len(s)
            out[name] = {
                "n": n,
                "total_ms": round(sum(s) * 1e3, 2),
                "mean_ms": round(sum(s) / n * 1e3, 3),
                "p50_ms": round(s[n // 2] * 1e3, 3),
                "p95_ms": round(s[min(n - 1, int(n * 0.95))] * 1e3, 3),
                "max_ms": round(s[-1] * 1e3, 3),
            }
        return out

    def reset(self):
        self._samples.clear()


@contextlib.contextmanager
def capture(logdir: str):
    """Device-level trace of the enclosed work: torch.profiler with the CPU
    and CUDA activities (CUDA only when a card is present), written as a
    Chrome trace to `logdir/trace.json` (open it in chrome://tracing or
    Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def stage_summary(trace_path: str) -> Dict[str, Dict[str, float]]:
    """Per-stage launch and device counts from a `capture` Chrome trace.

    For each stage span: `n` spans, `host_ms` their host time, `launches`
    the kernel launch calls made inside them (by the call's host time;
    a nested stage's launches count in every stage around it) and
    `device_ms` the run time of those kernels on the device. The entry
    `"_trace"` holds the whole trace: its `window_ms` (first event to last),
    its `launches`, and `device_busy_ms` (kernels, copies and fills)."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    calls = sorted((e for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "LaunchKernel" in e.get("name", "")),
                   key=lambda e: e["ts"])
    call_ts = [e["ts"] for e in calls]
    kernel_us = {e["args"].get("correlation"): e["dur"] for e in events
                 if e.get("cat") == "kernel"}
    out: Dict[str, Dict[str, float]] = {}
    for sp in spans:
        lo = bisect.bisect_left(call_ts, sp["ts"])
        hi = bisect.bisect_right(call_ts, sp["ts"] + sp["dur"])
        r = out.setdefault(sp["name"], {"n": 0, "host_ms": 0.0,
                                        "launches": 0, "device_ms": 0.0})
        r["n"] += 1
        r["host_ms"] += sp["dur"] / 1e3
        r["launches"] += hi - lo
        r["device_ms"] += sum(
            kernel_us.get(c["args"].get("correlation"), 0.0)
            for c in calls[lo:hi]) / 1e3
    t0 = min((e["ts"] for e in events), default=0.0)
    t1 = max((e["ts"] + e["dur"] for e in events), default=0.0)
    out["_trace"] = {
        "window_ms": (t1 - t0) / 1e3, "launches": len(calls),
        "device_busy_ms": sum(e["dur"] for e in events
                              if e.get("cat") in _DEVICE_CATS) / 1e3}
    return out
