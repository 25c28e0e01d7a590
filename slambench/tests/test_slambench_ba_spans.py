"""The four backend-BA readers of the program's `ba.*` spans
(`slambench/ba_spans.py`) on a canned slice of two LM iterations: host
spans, their device annotations, launch calls, device operations and idle
gaps, each value computed by hand; the slice with its events' categories,
and as `harness.Slice` files them where the profiler gives no category
(torch 2.11: device annotations as host annotations, runtime calls as CPU
operations, copies and fills as kernels)."""

import pytest

from slambench import ba_spans, harness
from slambench.metrics import _load

U = "user_annotation"
G = "gpu_user_annotation"
RT, DRV = "cuda_runtime", "cuda_driver"

# (name, category, start_us, duration_us)
HOST = [
    ("solve", U, 0.0, 200.0),
    ("ba.global", U, 1.0, 198.0),
    ("ba.local", U, 2.0, 196.0),
    ("ba.obs_table", U, 3.0, 7.0),
    ("ba.iteration", U, 10.0, 50.0),
    ("ba.reduce", U, 11.0, 19.0),
    ("ba.solve_cameras", U, 30.0, 20.0),
    ("ba.back_substitute", U, 50.0, 5.0),
    ("ba.cost", U, 55.0, 5.0),
    ("ba.iteration", U, 60.0, 50.0),
    ("ba.refresh_weights", U, 61.0, 4.0),
    ("ba.reduce", U, 65.0, 15.0),
    ("ba.solve_cameras", U, 80.0, 20.0),
    ("ba.back_substitute", U, 100.0, 5.0),
    ("ba.cost", U, 105.0, 5.0),
    ("ba.cost", U, 110.0, 5.0),
    ("ba.write_back", U, 115.0, 5.0),
]
# each launch call (host time) and the device operation it enqueued, in
# order on one stream
LAUNCHED = [
    (("cudaMemsetAsync", RT, 4.0, 1.0), ("Memset", "gpu_memset", 5.0, 2.0)),
    (("cudaLaunchKernel", RT, 12.0, 1.0), ("k_jac", "kernel", 13.0, 7.0)),
    (("cuLaunchKernel", DRV, 14.0, 1.0), ("sgemm", "kernel", 20.0, 6.0)),
    (("cudaLaunchKernel", RT, 32.0, 1.0), ("copy", "kernel", 33.0, 2.0)),
    (("cudaLaunchKernel", RT, 40.0, 1.0), ("copy", "kernel", 41.0, 2.0)),
    (("cudaMemcpyAsync", RT, 52.0, 1.0),
     ("Memcpy DtoD", "gpu_memcpy", 53.0, 1.0)),
    (("cudaLaunchKernel", RT, 57.0, 0.5), ("where", "kernel", 57.5, 0.5)),
    (("cudaLaunchKernel", RT, 62.0, 1.0), ("gate", "kernel", 62.0, 2.0)),
    (("cudaLaunchKernel", RT, 66.0, 1.0), ("k_jac", "kernel", 66.0, 9.0)),
    (("cudaLaunchKernel", RT, 82.0, 1.0), ("getrf", "kernel", 82.0, 8.0)),
    (("cudaLaunchKernel", RT, 101.0, 1.0), ("step", "kernel", 101.0, 1.0)),
    (("cudaLaunchKernel", RT, 106.0, 1.0), ("where", "kernel", 106.0, 1.0)),
    (("cudaLaunchKernel", RT, 112.0, 1.0), ("cost", "kernel", 112.0, 1.0)),
    (("cudaLaunchKernel", RT, 116.0, 1.0), ("index", "kernel", 116.0, 2.0)),
]
# each leaf span's device interval: first operation's start to last end
GPU = [
    ("ba.obs_table", G, 5.0, 2.0),
    ("ba.reduce", G, 13.0, 13.0), ("ba.solve_cameras", G, 33.0, 10.0),
    ("ba.back_substitute", G, 53.0, 1.0), ("ba.cost", G, 57.5, 0.5),
    ("ba.refresh_weights", G, 62.0, 2.0), ("ba.reduce", G, 66.0, 9.0),
    ("ba.solve_cameras", G, 82.0, 8.0), ("ba.back_substitute", G, 101.0, 1.0),
    ("ba.cost", G, 106.0, 1.0), ("ba.cost", G, 112.0, 1.0),
    ("ba.write_back", G, 116.0, 2.0),
]
OTHER = [("cudaStreamIsCapturing", RT, 31.0, 0.5),
         ("aten::mul", "cpu_op", 12.0, 1.5)]
EVENTS = (HOST + [c for c, _ in LAUNCHED] + [op for _, op in LAUNCHED]
          + GPU + OTHER)
UNTYPED = {G: U, RT: "cpu_op", DRV: "cpu_op", "gpu_memcpy": "kernel",
           "gpu_memset": "kernel"}
SLICES = {"typed": EVENTS,
          "untyped": [(n, UNTYPED.get(c, c), s, d) for n, c, s, d in EVENTS]}
DEVICE_ANNOTATIONS = {(n, s) for n, _, s, _ in GPU}

# launch calls 2-12 lie in the two iterations
LAUNCHES = 11 / 2
# reduce: [13, 26] and [66, 75]; solve: [33, 35], [41, 43] and [82, 90]
REDUCE_MS = (13.0 + 9.0) / 2 / 1e3
SOLVE_MS = (2.0 + 2.0 + 8.0) / 2 / 1e3
# gaps starting in an iteration: 26-33, 35-41, 43-53, 54-57.5, 58-62,
# 64-66, 75-82, 90-101, 102-106, 107-112 (7-13 and 113-116 lie outside)
IDLE_MS = (7 + 6 + 10 + 3.5 + 4 + 2 + 7 + 11 + 4 + 5) / 2 / 1e3


class _Slice:
    def __init__(self, events):
        self.events, self.wall_s, self.units = events, 200e-6, 1


def readings(events):
    return dict(kind="solves", n_solves=1, n_iters=2, window_s=1.0,
                slice=_Slice(events), free_solve_s=200e-6)


READERS = {"ba_reduce_device_ms": REDUCE_MS, "ba_solve_device_ms": SOLVE_MS,
           "ba_launches_per_iter": LAUNCHES, "ba_iter_idle_ms": IDLE_MS}


@pytest.mark.parametrize("kind", sorted(SLICES))
@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_the_canned_slice(name, kind):
    assert _load(name).read(readings(SLICES[kind])) == pytest.approx(
        READERS[name])


@pytest.mark.parametrize("kind", sorted(SLICES))
def test_host_spans_and_device_annotations_told_apart(kind):
    host, device = ba_spans.annotations(SLICES[kind])
    assert {(n, s) for n, s, _ in device} == DEVICE_ANNOTATIONS
    assert sorted((n, s) for n, s, _ in host) == sorted(
        (n, s) for n, _, s, _ in HOST)


@pytest.mark.parametrize("kind", sorted(SLICES))
@pytest.mark.parametrize("name", sorted(READERS))
def test_no_reading_without_iteration_spans(name, kind):
    """A program without the spans (or a slice with no device operation)
    gives nothing to read."""
    events = SLICES[kind]
    no_iter = [e for e in events if e[0] != "ba.iteration"]
    assert _load(name).read(readings(no_iter)) is None
    no_device = [e for e in events if e[1] not in harness.DEVICE_CATS]
    assert _load(name).read(readings(no_device)) is None
    assert _load(name).read(dict(readings(events), slice=None)) is None


@pytest.mark.parametrize("kind", sorted(SLICES))
@pytest.mark.parametrize("name", ["ba_reduce_device_ms",
                                  "ba_solve_device_ms"])
def test_device_time_pairs_launches_without_device_spans(name, kind):
    """Without device annotations the device time comes from pairing
    launch calls with operations in order: the same values; with one
    operation more than launches, no reading."""
    host_only = [e for e in SLICES[kind]
                 if (e[0], e[2]) not in DEVICE_ANNOTATIONS]
    assert _load(name).read(readings(host_only)) == pytest.approx(
        READERS[name])
    stray = ("stray", "kernel", 150.0, 1.0)
    assert _load(name).read(readings(host_only + [stray])) is None
    # device annotations in their own category need no pairing; filed as
    # host annotations, they are found only through it
    got = _load(name).read(readings(SLICES[kind] + [stray]))
    if kind == "typed":
        assert got == pytest.approx(READERS[name])
    else:
        assert got is None


def test_breakdown_files_idle_under_the_ba_stages():
    """`harness.breakdown` names the stage the host was in when each gap
    began: the solve's spans replace the single `solve` entry."""
    gaps = dict(harness.breakdown(EVENTS)["idle_gaps"])
    assert gaps == pytest.approx({
        "ba.solve_cameras": (6 + 10 + 11) / 1e6,
        "ba.reduce": (7 + 7) / 1e6, "ba.cost": (4 + 5 + 3) / 1e6,
        "ba.back_substitute": (3.5 + 4) / 1e6, "ba.obs_table": 6 / 1e6,
        "ba.refresh_weights": 2 / 1e6})
