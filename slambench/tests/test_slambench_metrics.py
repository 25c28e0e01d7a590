"""Every per-layer metric's reader, and the trace reductions, on a canned
profiler slice."""

import json

import pytest

from slambench import harness, roofline
from slambench.metrics import _load


class _Slice:
    def __init__(self, events, wall_s, units):
        self.events, self.wall_s, self.units = events, wall_s, units


# (name, category, start_us, duration_us)
EVENTS = [
    ("frame", "user_annotation", 0.0, 48.0),
    ("extract", "user_annotation", 1.0, 9.0),
    ("aten::add", "cpu_op", 1.0, 2.0),
    ("frontend_packed_kernel(Params, float*)", "kernel", 2.0, 8.0),
    ("void elementwise_kernel<...>", "kernel", 6.0, 6.0),
    ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 20.0, 10.0),
    ("track_frame", "user_annotation", 12.0, 30.0),
    ("frontend_packed_kernel(Params, float*)", "kernel", 36.0, 12.0),
]
STAGES = {"extract": [0.010, 0.030], "track_frame": [0.004, 0.006],
          "insert_kf": [0.1, 0.3, 0.2], "mapping_fused": [0.1]}


def frames_readings(stages=STAGES):
    return dict(kind="frames", n_frames=12, window_s=1.0, frame_ms=[1.0] * 12,
                stage_s=2.0,
                stages=stages, slice=_Slice(EVENTS, 100e-6, 2),
                n_insertions=3,
                frontend=roofline.frontend_cost(480, 752, 8, 1.2))


def solves_readings():
    class P:
        pass

    import torch
    p = P()
    p.k = torch.tensor([0, 0, 1, 1, 1])
    p.l = torch.tensor([0, 1, 0, 1, 2])
    p.R = torch.zeros(2, 3, 3)
    return dict(kind="solves", n_solves=4, n_iters=8, window_s=1.0,
                slice=_Slice(EVENTS, 100e-6, 2), free_solve_s=40e-6,
                ba=roofline.ba_iter_cost(p))


def test_busy_time_is_the_union_of_device_intervals():
    # kernels [2, 10] and [6, 12] overlap: 10 us; copy [20, 30]; [36, 48]
    assert harness.busy_us(EVENTS) == pytest.approx(10.0 + 10.0 + 12.0)


@pytest.mark.parametrize("name,expected", [
    ("launches_per_frame", 3 / 2),
    ("extract_host_ms", 20.0),
    ("track_frame_ms", 5.0),
    ("insert_ms_p50", 200.0),
    ("kf_share", 25.0),
    ("vi_frames_per_s", 6.0),
    ("device_idle.frames", 100.0 * (1 - 32.0 / 100.0)),
    ("frontend_packed_roofline",
     100.0 * roofline.frontend_cost(480, 752, 8, 1.2)["bound_ms"] / 0.010),
])
def test_frame_metrics(name, expected):
    assert _load(name).read(frames_readings()) == pytest.approx(expected)
    assert _load(name).read(solves_readings()) is None


@pytest.mark.parametrize("name", ["ba_iter_device_ms", "ba_iter_roofline",
                                  "device_idle.ba", "vi_local_ba_ms"])
def test_no_reading_where_nothing_to_read(name):
    assert _load(name).read(frames_readings()) is None


def test_vi_local_ba_reads_the_local_ba_stage():
    r = frames_readings(dict(STAGES, local_ba=[0.3, 0.5, 0.4]))
    assert _load("vi_local_ba_ms").read(r) == pytest.approx(400.0)


def test_ba_metrics():
    r = solves_readings()
    ms = 32.0 / 1e3 / (2 * 8)
    assert _load("ba_iter_device_ms").read(r) == pytest.approx(ms)
    # 32 us busy over 2 solves in the slice, 40 us a solve outside it
    assert _load("device_idle.ba").read(r) == pytest.approx(60.0)
    assert _load("device_idle.ba").read(dict(r, free_solve_s=None)) is None
    assert _load("ba_iter_roofline").read(r) == pytest.approx(
        100.0 * r["ba"]["bound_ms"] / ms)
    # 3 landmarks seen 2, 2 and 1 times: the symmetric system needs
    # 3 + 3 + 1 blocks (each pair once, each observation with itself)
    assert r["ba"]["pairs"] == 7


def test_breakdown_names_ops_and_gaps():
    b = harness.breakdown(EVENTS)
    names = [n for n, _ in b["device_ops"]]
    assert names[0].startswith("frontend_packed")
    gaps = dict(b["idle_gaps"])
    # [12, 20] begins inside extract? no: extract ends at 10, so the
    # innermost span at 12 is track_frame; [30, 36] too
    assert gaps == pytest.approx({"track_frame": 14e-6})


def test_every_metric_of_the_benchmark_has_a_reader():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(_load(m["name"]).read)
