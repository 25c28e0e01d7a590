"""The inertial BA's profiler spans and counters on the CPU, and the five
`vi_*` readers (`slambench/vi_spans.py`, `slambench/metrics/vi_*.py`) on
canned slices.

The spans nest as `utils/tracing.py` lists them, with `n_iters`
`vi.iteration` spans a solve; the counters read the last solve's 255
intervals and state dimension 2,312 at 256 keyframes. The readers take a
stage's device time from the device operations inside its device
annotations, by time: a slice whose stages ran eagerly (a launch call an
operation) and one whose stages replayed CUDA graphs (one graph launch a
stage, no kernel launch) read the same device times, and the launch count
is the host's calls in each."""

import json

import pytest
import torch

from slambench import harness, vi_spans
from slambench.gen import vi_gba_map
from slambench.metrics import _load
from orb_slam3_ros2_tpu_torch.backend import vi_ba
from orb_slam3_ros2_tpu_torch.utils import tracing

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def workload(**traffic):
    cfg = harness.load_json(harness.ROOT / "slambench" / "configs"
                            / "euroc_vi.json")
    tr = harness.load_json(harness.ROOT / "slambench" / "traffic"
                           / "vi_gba_map.json")
    tr.update(keyframes=8, landmarks=128, candidates=1500, n_iters=3)
    tr.update(traffic)
    wl = vi_gba_map.Workload(cfg, tr, 2147483659, CPU, False)
    wl.setup()
    return wl


def test_vi_spans_nest_as_the_solve(tmp_path):
    """One `vi.ba` holding `vi.obs_table`, the iterations and
    `vi.write_back` in that order; each `vi.iteration` holds its five
    stages in order, and every operation of an iteration lies in one of
    them."""
    wl = workload()
    with tracing.capture(str(tmp_path / "prof")):
        wl.solve()
    path = str(tmp_path / "prof" / "trace.json")
    s = tracing.stage_summary(path)
    n = wl.n_iters
    assert {k: v["n"] for k, v in s.items() if k.startswith("vi.")} == {
        "vi.ba": 1, "vi.obs_table": 1, "vi.write_back": 1,
        "vi.iteration": n, **{st: n for st in vi_spans.STAGES}}
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("vi."))

    def inside(outer):
        a, b, _ = outer
        return [x for x in spans if x != outer and a <= x[0] and x[1] <= b]

    (top,) = [x for x in spans if x[2] == "vi.ba"]
    assert len(inside(top)) == len(spans) - 1
    iters = [x for x in spans if x[2] == "vi.iteration"]
    nested = {x for it in iters for x in inside(it)}
    assert [x[2] for x in inside(top) if x not in nested] == (
        ["vi.obs_table"] + ["vi.iteration"] * n + ["vi.write_back"])
    ops = [(e["ts"], e["ts"] + e["dur"]) for e in ev
           if e.get("cat") == "cpu_op"]
    for it in iters:
        assert [x[2] for x in inside(it)] == list(vi_spans.STAGES)
        for a, b in ops:
            if it[0] <= a < it[1]:
                assert any(x[0] <= a and b <= x[1] for x in inside(it))


def test_counters_read_the_cells_intervals_and_state():
    """At 256 keyframes (a short interval and a few landmarks, so that
    the CPU solves it quickly): 255 intervals, D = 9 x 256 + 8."""
    workload(keyframes=256, landmarks=96, candidates=1500, kf_dt_s=0.02,
             n_iters=1)
    assert vi_ba.vi_bundle_adjust.intervals == 255
    assert vi_ba.vi_bundle_adjust.state_dim == 2312


# ------------------------------------------------------------ canned slices

U, G = "user_annotation", vi_spans.DEVICE_ANNOTATION
RT = "cuda_runtime"
# two iterations of the five stages: (name, host start, host end, device
# operations (start, duration))
STAGE_OPS = [
    ("vi.reduce", 11.0, 30.0, [(13.0, 7.0), (20.0, 6.0)]),
    ("vi.inertial", 30.0, 40.0, [(31.0, 2.0), (34.0, 1.0)]),
    ("vi.solve", 40.0, 55.0, [(42.0, 8.0)]),
    ("vi.back_substitute", 55.0, 58.0, [(56.0, 1.0)]),
    ("vi.cost", 58.0, 60.0, [(58.5, 0.5)]),
    ("vi.reduce", 61.0, 75.0, [(62.0, 9.0)]),
    ("vi.inertial", 75.0, 80.0, [(76.0, 1.0), (77.5, 1.5)]),
    ("vi.solve", 80.0, 100.0, [(82.0, 8.0), (91.0, 3.0)]),
    ("vi.back_substitute", 100.0, 105.0, [(101.0, 1.0)]),
    ("vi.cost", 105.0, 110.0, [(106.0, 1.0)]),
]
OUTSIDE = [("vi.ba", U, 0.0, 120.0), ("vi.obs_table", U, 2.0, 8.0),
           ("vi.iteration", U, 10.0, 50.0), ("vi.iteration", U, 60.0, 50.0),
           ("vi.write_back", U, 112.0, 6.0),
           ("cudaLaunchKernel", RT, 3.0, 1.0), ("gather", "kernel", 4.0, 2.0),
           ("cudaLaunchKernel", RT, 113.0, 1.0),
           ("index", "kernel", 114.0, 2.0)]


def canned(graphs: bool, typed: bool = True):
    """The events of the two iterations: each stage a host span, a device
    annotation from its first operation's start to its last one's end,
    and its operations, enqueued by a launch call each (eager) or by one
    graph launch (graphs). `typed` False files the device annotations with
    the host spans (`harness.Slice` on torch 2.11)."""
    ev = list(OUTSIDE)
    for name, a, b, ops in STAGE_OPS:
        ev.append((name, U, a, b - a))
        first, last = ops[0][0], ops[-1][0] + ops[-1][1]
        ev.append((name, G if typed else U, first, last - first))
        if graphs:
            ev.append(("cudaGraphLaunch", RT, a + 0.5, 0.3))
        for i, (s, d) in enumerate(ops):
            if not graphs:
                ev.append(("cudaLaunchKernel", "cpu_op" if not typed else RT,
                           a + 0.5 + 0.1 * i, 0.05))
            ev.append((f"{name}_op{i}", "kernel", s, d))
    return ev


class _Slice:
    def __init__(self, events):
        self.events, self.wall_s, self.units = events, 120e-6, 1


def readings(events):
    return dict(kind="solves", n_solves=1, n_iters=2, window_s=1.0,
                slice=_Slice(events), free_solve_s=120e-6,
                vi=dict(bound_ms=0.005))


REDUCE_MS = (13.0 + 9.0) / 2 / 1e3
INERTIAL_MS = (3.0 + 2.5) / 2 / 1e3
SOLVE_MS = (8.0 + 11.0) / 2 / 1e3
ITER_MS = REDUCE_MS + INERTIAL_MS + SOLVE_MS + (1.0 + 1.0 + 0.5 + 1.0) \
    / 2 / 1e3
DEVICE = {"vi_iter_device_ms": ITER_MS, "vi_inertial_device_ms": INERTIAL_MS,
          "vi_solve_device_ms": SOLVE_MS,
          "vi_iter_roofline": 100 * 0.005 / ITER_MS}


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graphs"])
def test_readers_read_device_time_by_annotation(graphs):
    r = readings(canned(graphs))
    for name, want in DEVICE.items():
        assert _load(name).read(r) == pytest.approx(want, rel=1e-12), name
    n_calls = 10 if graphs else sum(len(x[3]) for x in STAGE_OPS)
    assert _load("vi_launches_per_iter").read(r) == n_calls / 2


def test_untyped_eager_slices_read_the_same_through_the_launches():
    """Where the device annotations are filed with the host spans and
    every operation has its launch call, `ba_spans`' pairing tells them
    apart, and the readers read as on a typed slice."""
    ev = canned(False, typed=False)
    ev = [(n, "cpu_op" if c == RT else c, s, d) for n, c, s, d in ev]
    r = readings(ev)
    for name, want in DEVICE.items():
        assert _load(name).read(r) == pytest.approx(want, rel=1e-12), name


def test_readers_read_nothing_without_the_spans():
    """A program without the `vi.*` spans, or a slice without a card:
    every reader gives None."""
    no_spans = [e for e in canned(False) if not e[0].startswith("vi.")]
    no_card = [e for e in canned(False) if e[1] != "kernel"]
    for ev in (no_spans, no_card):
        r = readings(ev)
        for name in list(DEVICE) + ["vi_launches_per_iter"]:
            assert _load(name).read(r) is None, name
