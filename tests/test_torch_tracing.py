"""The port's stage tracer against the JAX one (`orb_slam3_ros2_tpu/utils/
tracing.py`, `tests/test_tracing.py`): the same reports from the same
samples, the port System's stage names after a short CPU run (in the
synchronous and the pipelined mode), and the
torch.profiler capture that replaces `jax.profiler.trace`."""

import json
import os
import re
import time

import numpy as np
import pytest

from orb_slam3_ros2_tpu.utils import tracing as jtracing
from orb_slam3_ros2_tpu_torch.io import synthetic
from orb_slam3_ros2_tpu_torch.runtime.system import Sensor, System
from orb_slam3_ros2_tpu_torch.utils import tracing
from tests.test_torch_e2e_stereo import two_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = os.path.join(ROOT, "tests", "data", "synth_cam.yaml")
# the stages of the JAX System's pipelined mode
PIPELINED = {"frame_step", "mapping_dispatch", "summary_fetch"}


def test_tracer_aggregates():
    tr = tracing.StageTracer()
    for _ in range(20):
        with tr.stage("a"):
            time.sleep(0.001)
    with tr.stage("b"):
        pass
    rep = tr.report()
    assert rep["a"]["n"] == 20
    assert rep["a"]["mean_ms"] >= 0.9
    assert rep["a"]["p95_ms"] >= rep["a"]["p50_ms"]
    assert rep["b"]["n"] == 1
    tr.reset()
    assert tr.report() == {}


def test_tracer_disabled_is_free():
    tr = tracing.StageTracer(enabled=False)
    with tr.stage("x"):
        pass
    tr.add("x", 1.0)
    assert tr.report() == {}


def test_report_equals_jax_on_the_same_samples():
    rng = np.random.default_rng(0)
    port, ref = tracing.StageTracer(), jtracing.StageTracer()
    for name in ("extract", "track_frame", "insert_kf"):
        for s in rng.uniform(1e-4, 5e-2, int(rng.integers(1, 40))):
            port.add(name, float(s))
            ref.add(name, float(s))
    assert port.report() == ref.report()


def _jax_stage_names() -> set:
    src = open(os.path.join(ROOT, "orb_slam3_ros2_tpu", "runtime",
                            "system.py")).read()
    return set(re.findall(r'tracer\.stage\("(\w+)"\)', src))


@pytest.mark.parametrize("pipelined", [False, True])
def test_system_records_the_jax_stage_names(two_threads,  # noqa: F811
                                            pipelined):
    """After 20 frames on the CPU (the port's own draws initialize the map
    at frame 14 of this clip) the port System reports JAX stage names
    only: the synchronous System its stages, the pipelined one the
    pipelined mode's (`frame_step` on each frame after the initialization,
    `summary_fetch` on each it consumed, a `mapping_dispatch` and its
    `mapping_fused` per keyframe); and the port's System names
    every stage of the JAX System, under the same name, and no other."""
    images, _, _, ts = synthetic.render_sequence(
        n_frames=20, width=320, height=240, fx=260.0, fy=260.0,
        fps=10.0, seed=1, plane_depths=(6.0, 9.0), traj_scale=1.6)
    slam = System(None, SETTINGS, Sensor.MONOCULAR, pipelined=pipelined,
                  device="cpu")
    for k in range(images.shape[0]):
        slam.track_monocular(images[k], float(ts[k]))
    slam.get_trajectory()
    rep = slam.tracer.report()
    if pipelined:
        assert set(rep) & PIPELINED == PIPELINED
        assert rep["extract"]["n"] + rep["frame_step"]["n"] == 20
        assert rep["summary_fetch"]["n"] == rep["frame_step"]["n"] >= 1
        # each dispatched insertion was finalized (the flush included)
        assert rep["mapping_dispatch"]["n"] == rep["mapping_fused"]["n"]
        assert "track_frame" not in rep and "insert_kf" not in rep
    else:
        assert not set(rep) & PIPELINED
        assert rep["extract"]["n"] == 20
        assert rep["track_frame"]["n"] >= 1
        assert rep["predict"]["n"] == rep["track_frame"]["n"]
        assert rep["insert_kf"]["n"] == rep["mapping_fused"]["n"] >= 1
    jax_names = _jax_stage_names()
    assert set(rep) <= jax_names, set(rep) - jax_names
    src = open(os.path.join(ROOT, "orb_slam3_ros2_tpu_torch", "runtime",
                            "system.py")).read()
    port_names = set(re.findall(r'tracer\.stage\("(\w+)"\)', src))
    assert port_names == jax_names


def test_capture_writes_a_chrome_trace(tmp_path):
    import torch

    with tracing.capture(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "prof" / "trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]


def test_stages_are_profiler_spans_only_while_one_runs(tmp_path):
    import torch

    tr = tracing.StageTracer()
    with tr.stage("outside"):
        torch.ones(8) + 1
    with tracing.capture(str(tmp_path / "prof")):
        for _ in range(3):
            with tr.stage("extract"):
                with tr.stage("inner"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
    s = tracing.stage_summary(str(tmp_path / "prof" / "trace.json"))
    assert s["extract"]["n"] == 3 and s["inner"]["n"] == 3
    assert "outside" not in s
    assert s["extract"]["host_ms"] >= s["inner"]["host_ms"] > 0
    # no card: no launch calls and no device time
    assert s["extract"]["launches"] == s["_trace"]["launches"] == 0
    assert s["_trace"]["device_busy_ms"] == 0
    assert tr.report()["extract"]["n"] == 3


def test_stage_summary_counts_launches_and_their_kernels(tmp_path):
    """A written trace: launch calls are counted in the spans around them
    (nested spans both count), and their kernels' time is found by the
    correlation id."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "extract", "ts": 0,
         "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "inner", "ts": 10,
         "dur": 30},
        {"ph": "X", "cat": "user_annotation", "name": "extract", "ts": 200,
         "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 20, "dur": 2, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel",
         "ts": 60, "dur": 2, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 210, "dur": 2, "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 300, "dur": 2, "args": {"correlation": 4}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 30, "dur": 2, "args": {"correlation": 5}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 25, "dur": 4,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 70, "dur": 6,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k3", "ts": 220, "dur": 8,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "k4", "ts": 310, "dur": 90,
         "args": {"correlation": 4}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 40, "dur": 2,
         "args": {"correlation": 5}},
        {"ph": "i", "cat": "instant", "name": "marker", "ts": 500},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = tracing.stage_summary(str(path))
    approx = pytest.approx
    assert s["extract"] == {"n": 2, "host_ms": approx(0.15), "launches": 3,
                            "device_ms": approx(0.018)}
    assert s["inner"] == {"n": 1, "host_ms": approx(0.03), "launches": 1,
                          "device_ms": approx(0.004)}
    assert s["_trace"] == {"window_ms": approx(0.4), "launches": 4,
                           "device_busy_ms": approx(0.11)}


def test_span_is_a_profiler_range_only_while_one_runs(tmp_path,
                                                      monkeypatch):
    """`tracing.span` opens no `record_function` while no profiler runs,
    and one range of its name while one does."""
    import torch

    opened = []
    orig = torch.profiler.record_function

    def record(name):
        opened.append(name)
        return orig(name)

    monkeypatch.setattr(torch.profiler, "record_function", record)
    with tracing.span("ba.outside"):
        torch.ones(8) + 1
    assert opened == []
    with tracing.capture(str(tmp_path / "prof")):
        with tracing.span("ba.inside"):
            torch.ones(8) + 1
    assert opened == ["ba.inside"]
    s = tracing.stage_summary(str(tmp_path / "prof" / "trace.json"))
    assert s["ba.inside"]["n"] == 1 and "ba.outside" not in s


def _ba_spans(trace_path):
    """The `ba.*` host spans of a capture, (start, end, name), by start."""
    with open(trace_path) as f:
        ev = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith("ba."))


def test_global_ba_spans_nest_as_the_solve(tmp_path):
    """A CPU global BA of 11 iterations under a capture: one `ba.global`
    around one `ba.local`, which holds `ba.obs_table`, the iterations, the
    final `ba.cost` and `ba.write_back` in that order; each `ba.iteration`
    holds one `ba.reduce`, `ba.solve_cameras`, `ba.back_substitute` and
    `ba.cost`, and a `ba.refresh_weights` first on the iterations the χ²
    gate refreshes (5 and 10, `reclassify_every` 5)."""
    from orb_slam3_ros2_tpu_torch.frontend import tracking as trk
    from tests.test_torch_ba_no_sync import CAM, tiny_map

    n_iters = 11
    m, n_kf = tiny_map("cpu")
    with tracing.capture(str(tmp_path / "prof")):
        trk.global_ba(m, n_kf, *CAM, n_iters=n_iters)
    path = str(tmp_path / "prof" / "trace.json")
    s = tracing.stage_summary(path)
    assert {k: v["n"] for k, v in s.items() if k.startswith("ba.")} == {
        "ba.global": 1, "ba.local": 1, "ba.obs_table": 1,
        "ba.write_back": 1, "ba.iteration": n_iters, "ba.reduce": n_iters,
        "ba.solve_cameras": n_iters, "ba.back_substitute": n_iters,
        "ba.cost": n_iters + 1, "ba.refresh_weights": 2}
    spans = _ba_spans(path)

    def inside(outer):
        a, b, _ = outer
        return [x for x in spans if x != outer and a <= x[0] and x[1] <= b]

    (glob,) = [x for x in spans if x[2] == "ba.global"]
    (loc,) = [x for x in spans if x[2] == "ba.local"]
    assert [x[2] for x in inside(glob)][0] == "ba.local"
    assert len(inside(glob)) == len(spans) - 1
    iters = [x for x in spans if x[2] == "ba.iteration"]
    in_iters = {x for it in iters for x in inside(it)}
    assert [x[2] for x in inside(loc) if x not in in_iters] == (
        ["ba.obs_table"] + ["ba.iteration"] * n_iters
        + ["ba.cost", "ba.write_back"])
    stages = ["ba.reduce", "ba.solve_cameras", "ba.back_substitute",
              "ba.cost"]
    with open(path) as f:
        ops = [(e["ts"], e["ts"] + e["dur"]) for e in
               json.load(f)["traceEvents"] if e.get("cat") == "cpu_op"]
    for i, it in enumerate(iters):
        gated = ["ba.refresh_weights"] if i in (5, 10) else []
        assert [x[2] for x in inside(it)] == gated + stages, i
        # an iteration runs nothing outside its stages, so a device trace
        # gives `ba.iteration` no device annotation of its own
        for a, b in ops:
            if it[0] <= a < it[1]:
                assert any(x[0] <= a and b <= x[1] for x in inside(it))


def test_spans_leave_the_solve_bitwise_unchanged(tmp_path):
    """The global BA's poses and landmarks are the same bits with a
    profiler running as without."""
    import torch

    from orb_slam3_ros2_tpu_torch.frontend import tracking as trk
    from tests.test_torch_ba_no_sync import CAM, tiny_map

    m, n_kf = tiny_map("cpu", seed=1)
    plain = trk.global_ba(m, n_kf, *CAM, n_iters=8)
    with tracing.capture(str(tmp_path / "prof")):
        traced = trk.global_ba(m, n_kf, *CAM, n_iters=8)
    for name in ("kf_R", "kf_t", "lm_X"):
        assert torch.equal(getattr(plain, name), getattr(traced, name)), name
    assert not torch.equal(plain.lm_X, m.lm_X)
