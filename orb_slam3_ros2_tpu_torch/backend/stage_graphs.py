"""CUDA graphs of the bundle adjustments' LM stages (`backend/ba.py`,
`backend/vi_ba.py`).

An LM iteration of `backend/ba.py` issues some 700 small device operations
(elementwise ops on (K, L) planes, `block_diag`'s copies, the LU), each of
which takes the host longer to issue than the device to run. Here each
stage is captured once as a `torch.cuda.CUDAGraph` and then replayed: one
launch a stage, plus the copies of its inputs.

    graphs = cache.solve(R, X, fx, fy, cx, cy, chi2_th)  # None off CUDA
    out = stage_graphs.run(graphs, "reduce", fn, *args)

A stage's key is what its kernels bake in: the stage, its function, each
argument's shape and dtype (a tensor) or value (anything else), the
float32 matmul precision, and which tensors are another graph's outputs
(below). The first call of a key runs `fn` eagerly (which also makes the
libraries' handles); the second warms `fn` up on a side stream, captures
it and replays it; every later call replays. A capture makes no host sync.

Inputs. A tensor argument is copied into the graph's own buffer before a
replay, once a solve where the same tensor (same object, same version)
comes back within the solve. A tensor that is an output of a graph of the
same group (one solve's problem shape and scalars) is read where it lies:
a replay needs that very tensor again, else the call runs eagerly.

Outputs. `run` returns the graph's output tensors themselves: they hold
until the same key replays next. The callers clone what they hand on (the
costs and the χ² gate that `slambench` keeps); the large terms of one LM
iteration (`schur.SchurTerms`) stay graph-owned.

Memory. The graphs of a group share one memory pool, so a capture may
reuse what an earlier capture freed (its temporaries), never a live
output. That holds a stage's output intact for as long as it is read
before a graph captured before its own replays again, as in
`bundle_adjust`, where each is read within the iteration or cloned. At
most `MAX_GROUPS` groups are kept; beyond that the least recently used
one is dropped with its pool.

A stage whose capture fails (a library call that refuses capture) stays
eager for its key, with a warning naming it. The events are reported to
the cache's `count` callback: "graph_captures", "graph_replays" or
"eager_stages" (a CUDA stage call that ran eagerly).
"""

from __future__ import annotations

import collections
import contextlib
import warnings
from typing import Callable, Optional

import torch

from orb_slam3_ros2_tpu_torch.utils import tracing

MAX_GROUPS = 4  # problem shapes whose graphs are kept (LRU)


def run(graphs: Optional["Solve"], stage: str, fn: Callable, *args):
    """`fn(*args)`, through the solve's graphs where there are any."""
    if graphs is None:
        return fn(*args)
    return graphs.run(stage, fn, *args)


class _Graph:
    """One captured stage: its graph, input buffers and outputs."""

    def __init__(self, graph, static, alias, out):
        self.graph, self.static, self.alias, self.out = (graph, static,
                                                         alias, out)

    def load(self, args, copied: dict) -> bool:
        """Copy `args` into the input buffers; False where an aliased
        input is not the tensor the graph reads."""
        for a, s, al in zip(args, self.static, self.alias):
            if al and a is not s:
                return False
        for i, (a, s, al) in enumerate(zip(args, self.static, self.alias)):
            if al or not isinstance(a, torch.Tensor):
                continue
            slot = (id(self), i)
            prev = copied.get(slot)
            if prev is not None and prev[0] is a and prev[1] == a._version:
                continue
            s.copy_(a)
            copied[slot] = (a, a._version)
        return True


class _Group:
    """The graphs of one problem shape on one device, in one pool."""

    def __init__(self, device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = None  # the side stream of warm-ups and captures
        self.seen: set = set()  # keys run once, eagerly
        self.graphs: dict = {}  # key -> _Graph, or None: stays eager
        self.owned: dict = {}  # id -> output tensor of a graph here

    def capture(self, key, stage: str, fn: Callable, args):
        """Warm `fn` up and capture it on the side stream (no host sync);
        the `_Graph`, or None where the capture failed."""
        static = [a if id(a) in self.owned else a.clone()
                  if isinstance(a, torch.Tensor) else a for a in args]
        alias = [isinstance(a, torch.Tensor) and id(a) in self.owned
                 for a in args]
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        try:
            with tracing.span("ba.graph_capture"), \
                    torch.cuda.stream(self.stream):
                fn(*static)  # the warm-up, on the capturing stream
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    out = fn(*static)
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
        except RuntimeError as e:
            cur.wait_stream(self.stream)
            warnings.warn(f"BA stage {stage!r} stays eager: its CUDA graph "
                          f"capture failed: {e}", RuntimeWarning)
            self.graphs[key] = None
            return None
        cur.wait_stream(self.stream)
        for t in (out,) if isinstance(out, torch.Tensor) else out:
            self.owned[id(t)] = t
        g = _Graph(graph, static, alias, out)
        self.graphs[key] = g
        return g


class Solve:
    """One solve's view of a group: the copies made within the solve."""

    def __init__(self, group: _Group, count: Callable[[str], None]):
        self.group, self.count = group, count
        self.copied: dict = {}  # (graph, slot) -> (source, its version)

    def run(self, stage: str, fn: Callable, *args):
        g = self.group
        key = (stage, fn, torch.get_float32_matmul_precision()) + tuple(
            (a.shape, a.dtype, id(a) in g.owned)
            if isinstance(a, torch.Tensor) else a for a in args)
        event = "graph_replays"
        entry = g.graphs.get(key, False)
        if entry is False:
            if key not in g.seen:
                g.seen.add(key)
                entry = None
            else:
                entry = g.capture(key, stage, fn, args)
                event = "graph_captures"
        if entry is None or not entry.load(args, self.copied):
            self.count("eager_stages")
            return fn(*args)
        entry.graph.replay()
        self.count(event)
        return entry.out


class StageGraphs:
    """The process's stage graphs, grouped by problem (`solve`)."""

    def __init__(self, count: Callable[[str], None]):
        self.count = count
        self.groups: collections.OrderedDict = collections.OrderedDict()

    def solve(self, *problem) -> Optional[Solve]:
        """A `Solve` for a problem given by its tensors (their device,
        shapes and dtypes) and scalars, or None off CUDA."""
        dev = problem[0].device
        if dev.type != "cuda":
            return None
        key = (dev,) + tuple((a.shape, a.dtype)
                             if isinstance(a, torch.Tensor) else a
                             for a in problem)
        group = self.groups.pop(key, None) or _Group(dev)
        self.groups[key] = group
        while len(self.groups) > MAX_GROUPS:
            self.groups.popitem(last=False)  # drops its graphs and pool
        return Solve(group, self.count)
