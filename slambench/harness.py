"""What every cell's run shares: the process's settings, the device
checks, the profiler slice and its reduction to device time, the probes
that keep a sample of the timed path's outputs, and the result line."""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HOST_THREADS = 2  # torch intra-op and BLAS threads of the benchmark process
FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam3_ros2_tpu")


def pin_host_threads() -> None:
    """Fix this process's BLAS and OpenMP pools before numpy and torch
    load (the process's own setting, never the machine's)."""
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = str(HOST_THREADS)
    os.environ["USE_FLAX"] = "0"
    # caches inside the checkout, at fixed paths, so later runs hit them
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (the port's name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def write_settings(settings: dict, path: Path) -> str:
    """An OpenCV-FileStorage YAML of the configuration's settings."""
    lines = ["%YAML:1.0"]
    for k, v in settings.items():
        if isinstance(v, dict):
            data = ", ".join(repr(float(x)) for x in v["data"])
            lines += [f"{k}: !!opencv-matrix", f"  rows: {v['rows']}",
                      f"  cols: {v['cols']}", "  dt: f", f"  data: [{data}]"]
        elif isinstance(v, str):
            lines.append(f'{k}: "{v}"')
        else:
            lines.append(f"{k}: {v}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


class Reservoir:
    """A uniform sample of `size` items from a stream of unknown length,
    drawn from a seeded generator."""

    def __init__(self, size: int, rng):
        self.size, self.rng = size, rng
        self.items: list = []
        self.seen = 0

    def offer(self) -> Optional[int]:
        """The slot the next item goes to, or None to drop it."""
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(self.seen))
        return j if j < self.size else None


def sync() -> None:
    """Wait for the card, where there is one."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def patch(module, name: str, make: Callable) -> Callable:
    """Replace `module.name` by `make(original)`; returns the original.
    The replacement takes the original's attributes (the kernel wrappers'
    `launches` counters, which they bump through their module's name)."""
    import functools

    orig = getattr(module, name)
    setattr(module, name, functools.update_wrapper(make(orig), orig))
    return orig


class BACosts:
    """Records, for each bundle adjustment the program runs, the robust
    cost at each linearization (`schur.schur_reduce`'s `cost0`) and of
    each candidate (`schur.robust_cost`), and each refreshed χ² gate
    (`schur.refresh_weights`), as device tensors (no wait): its accept
    decisions are candidate < linearization, iteration by iteration
    (`backend/ba.py` `bundle_adjust`), and its gates the weights it
    solved with after each refresh. It records only between `start` and
    `record`, around the one solve that is compared."""

    def __init__(self):
        from orb_slam3_ros2_tpu_torch.backend import schur

        self.cost0: list = []
        self.cost1: list = []
        self.gates: list = []
        self.on = False

        def reduce(orig):
            def f(*a, **k):
                terms = orig(*a, **k)
                if self.on:
                    self.cost0.append(terms.cost0)
                return terms
            return f

        def cost(orig):
            def f(*a, **k):
                c = orig(*a, **k)
                if self.on:
                    self.cost1.append(c)
                return c
            return f

        def gate(orig):
            def f(*a, **k):
                w = orig(*a, **k)
                if self.on:
                    self.gates.append(w)
                return w
            return f

        patch(schur, "schur_reduce", reduce)
        patch(schur, "robust_cost", cost)
        patch(schur, "refresh_weights", gate)

    def start(self):
        self.cost0, self.cost1, self.gates = [], [], []
        self.on = True

    def record(self) -> tuple:
        """(cost0, cost1, gates) of the solve recorded since `start`; the
        recording stops."""
        self.on = False
        return self.cost0, self.cost1, self.gates


def replay(cost0, cost1, gates) -> dict:
    """The accept decisions and χ² gates of a solve `BACosts` recorded,
    as `reference.ba.bundle_adjust` takes them."""
    return dict(accepts=[bool(c1 < c0) for c0, c1 in zip(cost0, cost1)],
                gates=gates)


# ---------------------------------------------------------------- profiler

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Slice:
    """torch.profiler over a bounded slice of the window; `events` are
    (name, category, start_us, dur_us) tuples, `wall_s` the slice's host
    time."""

    def __init__(self):
        self.events: List[tuple] = []
        self.wall_s = 0.0
        self.units = 0  # frames or solves in the slice
        self._prof = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self, units: int):
        sync()
        self.wall_s = time.perf_counter() - self._t0
        self.units = units
        self._prof.__exit__(None, None, None)
        evs = self._prof.profiler.kineto_results.events()
        out = []
        for e in evs:
            if hasattr(e, "activity_type"):
                cat = str(e.activity_type())
            elif e.is_user_annotation():
                cat = "user_annotation"
            else:
                cat = ("kernel" if "CUDA" in str(e.device_type())
                       else "cpu_op")
            out.append((e.name(), cat, e.start_ns() / 1e3,
                        e.duration_ns() / 1e3))
        self.events = out
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None


def warm_profiler() -> None:
    """Start and stop the profiler once in set-up, so that the window's
    slice does not pay its first start (CUPTI's)."""
    sl = Slice()
    sl.start()
    import torch

    torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu")
    sl.stop(0)


def device_intervals(events) -> List[tuple]:
    return sorted((s, s + d) for _, c, s, d in events if c in DEVICE_CATS)


def busy_us(events) -> float:
    """Length of the union of the device's operation intervals."""
    total, end = 0.0, float("-inf")
    for s, e in device_intervals(events):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def breakdown(events, top: int = 10) -> dict:
    """The device operations that took most time (by name), and the idle
    gaps of the device summed by what the host was doing when each began:
    the innermost stage span (the System's tracer stages, the harness's
    "frame" or "solve") around the gap's start, else "between calls"."""
    import bisect

    dev: Dict[str, float] = {}
    for n, c, s, d in events:
        if c in DEVICE_CATS:
            dev[n] = dev.get(n, 0.0) + d / 1e6
    spans = sorted((s, s + d, n) for n, c, s, d in events
                   if c == "user_annotation")
    starts = [x[0] for x in spans]
    gaps: Dict[str, float] = {}
    iv = device_intervals(events)
    end = iv[0][1] if iv else 0.0
    for s, e in iv[1:]:
        if s > end:
            label, best = "between calls", None
            i = bisect.bisect_right(starts, end)
            for x in spans[max(0, i - 64):i]:
                if x[0] <= end < x[1] and (best is None or x[0] >= best):
                    label, best = x[2], x[0]
            gaps[label] = gaps.get(label, 0.0) + (s - end) / 1e6
        end = max(end, e)
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order(dev)],
            "idle_gaps": [[k, v] for k, v in order(gaps)]}


# ---------------------------------------------------------------- results


def print_result(correct: bool, attempted: int, failed: int,
                 metrics: dict, device: dict, checks: List[tuple],
                 breakdown_: Optional[dict] = None,
                 slice_: Optional[dict] = None) -> None:
    """The contract's last line on stdout, the compared numbers last on
    stderr and last in the line."""
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if slice_ is not None:
        line["slice"] = slice_
    if breakdown_ is not None:
        line["breakdown"] = breakdown_
    line["checks"] = {n: {"value": v, "limit": l} for n, v, l in checks}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
