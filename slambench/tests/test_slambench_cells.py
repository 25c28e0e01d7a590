"""Each cell's command path on the CPU at a tiny size (the look for a card
skipped), and the same path with the timed path broken underneath: each
fault the cell can have takes a compared number past its limit. The two
orbit cells are not in `BENCHMARK.json` (PERF.md, section 7: their local
BAs have no limit yet); their path is run here as a cell would be, and
is not correct for that reason alone."""

import copy
import dataclasses

import pytest
import torch

from slambench import harness, run

BENCH = copy.deepcopy(harness.load_json(harness.ROOT / "BENCHMARK.json"))
# the orbit cells kept for later: their configurations and entries
BENCH["configs"] += [
    {"name": "euroc_vi", "file": "slambench/configs/euroc_vi.json"}]
BENCH["workloads"] += [
    {"name": "euroc_mono.orbit", "config": "euroc_mono", "traffic": "orbit",
     "chips": 1},
    {"name": "euroc_vi.orbit", "config": "euroc_vi", "traffic": "orbit",
     "chips": 1}]
ORBITS = ["euroc_mono.orbit", "euroc_vi.orbit"]
BENCH["end_to_end"] += [
    {"name": n, "unit": u, "workloads": ORBITS}
    for n, u in (("frames_per_s", "frames/s"), ("frame_ms_p95", "ms"))]
BENCH["per_layer"] += [
    {"name": n, "unit": u, "workloads": ORBITS}
    for n, u in (("launches_per_frame", "launches/frame"),
                 ("extract_host_ms", "ms"), ("track_frame_ms", "ms"),
                 ("insert_ms_p50", "ms"), ("kf_share", "%"),
                 ("frontend_packed_roofline", "%"),
                 ("device_idle.frames", "%"))]
# the local BAs' numbers, which have no limit yet, and the VI BA's, which
# has no reading yet
UNLIMITED = {"local_ba_cost_gap", "local_ba_point_gap", "vi_ba_gap"}
CPU = torch.device("cpu")


def tiny(cell: str):
    """The cell's configuration and traffic, cut for the CPU: a 376x240
    (or 320x186) camera, 500 features, a 64 x 2048 map, a short set-up."""
    w, c = run.cell_of(BENCH, cell)
    cfg = harness.load_json(harness.ROOT / c["file"])
    tr = harness.load_json(harness.ROOT / "slambench" / "traffic"
                           / f"{w['traffic']}.json")
    s = cfg["settings"]
    if "Camera.newWidth" in s:
        s["Camera.newWidth"], s["Camera.newHeight"] = 320, 186
    else:
        s["Camera.width"], s["Camera.height"] = 376, 240
        for k in ("Camera1.fx", "Camera1.fy", "Camera1.cx", "Camera1.cy"):
            s[k] *= 0.5
    s["ORBextractor.nFeatures"] = 500
    cfg["map"] = {"max_kf": 64, "max_lm": 2048}
    if tr["generator"] == "orbit":
        tr["setup"] = {"MONOCULAR": {"frames": 40},
                       "IMU_MONOCULAR": {"intervals": 10}}
        tr["trace_frames"] = 4
    else:
        tr.update(keyframes=16, landmarks=400, candidates=3000,
                  trace_solves=2)
    return cfg, tr


def run_tiny(cell, seconds=4.0, trace=False, seed=2147483659):
    cfg, tr = tiny(cell)
    torch.set_num_threads(2)
    return run.run_cell(BENCH, cell, seed, seconds, trace, CPU, config=cfg,
                        traffic=tr)


def limits(cell):
    return harness.load_json(harness.ROOT / "slambench" / "limits"
                             / f"{cell}.json")


def past_limits(checks):
    """The compared numbers with a limit that their reading does not meet
    (no reading counts as not met)."""
    return [n for n, v, lim in checks
            if lim is not None and (v is None or v > lim)]


def held(cell, correct, checks):
    """The run's compared numbers are the cell's limits (and, for the
    orbit cells, the unlimited ones), every limited one within its limit;
    the gba cell is correct, an orbit cell is not."""
    names = {n for n, _, _ in checks}
    orbit = cell.endswith(".orbit")
    extra = names - set(limits(cell))
    assert extra <= (UNLIMITED if orbit else set()), names
    assert set(limits(cell)) <= names, names
    assert not past_limits(checks), checks
    assert correct == (not orbit), checks


@pytest.mark.parametrize("cell", ["euroc_mono.orbit", "euroc_mono.gba"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_path(cell, trace):
    correct, att, failed, metrics, device, checks, brk, sl = run_tiny(
        cell, trace=trace)
    assert att > 0 and failed == 0
    held(cell, correct, checks)
    if trace:
        assert brk is not None and "device_ops" in brk
        want = {m["name"] for m in run.for_cell(BENCH["per_layer"], cell)}
        assert set(metrics) <= want
    else:
        want = {m["name"] for m in run.for_cell(BENCH["end_to_end"], cell)}
        assert set(metrics) == want


def test_vi_cell_path():
    correct, att, failed, metrics, _, checks, _, _ = run_tiny(
        "euroc_vi.orbit")
    held("euroc_vi.orbit", correct, checks)
    assert dict((n, v) for n, v, _ in checks)["vi_ba_gap"] is None
    assert metrics["frame_ms_p95"]["value"] > 0


@pytest.mark.parametrize("raw,limits,correct", [
    ([("a", 1.0, None)], {"a": 2.0}, True),
    ([("a", 3.0, None)], {"a": 2.0}, False),
    ([("a", 1.0, None)], {"a": 2.0, "b": 1.0}, False),  # b has no reading
    ([("a", 1.0, None), ("b", 0.0, None)], {"a": 2.0}, False),  # b no limit
    ([("a", None, None)], {"a": 2.0}, False),  # an empty sample
    ([("a", float("nan"), None)], {"a": 2.0}, False),
    ([], {}, False),  # nothing compared
])
def test_judge(raw, limits, correct):
    checks, ok = run.judge(raw, limits)
    assert ok == correct
    assert {n for n, _, _ in checks} == {n for n, _, _ in raw} | set(limits)


# ------------------------------------------------------------------ faults


def _alter_pose(orig):
    def f(*a, **k):
        res = orig(*a, **k)
        return res._replace(t=res.t + 0.02)  # 2 cm
    return f


def _alter_features(orig_make):
    def make(cfg):
        ext = orig_make(cfg)

        def f(img):
            out = ext(img)
            bits = out.bits.clone()
            bits[::7, 0] ^= 1  # one bit of every seventh descriptor
            return dataclasses.replace(out, bits=bits)
        return f
    return make


def _half_observations(orig):
    def f(m, kf_ids):
        uv, w, ok = orig(m, kf_ids)
        w = w.clone()
        w[:, ::2] = 0.0  # every other landmark's observations left out
        return uv, w, ok
    return f


def _alter_preint(orig):
    def f(*a, **k):
        out = orig(*a, **k)
        return out._replace(dv=out.dv * 1.01)  # the velocity delta, 1%
    return f


def _unchanged_gba(orig):
    return lambda m, *a, **k: m


def _alter_gba(orig):
    def f(*a, **k):
        out = orig(*a, **k)
        return out._replace(kf_t=out.kf_t + 0.01)
    return f


def _alter_gba_points(orig):
    def f(*a, **k):
        out = orig(*a, **k)
        return out._replace(lm_X=out.lm_X + 0.01)  # every landmark, 1 cm
    return f


FAULTS = {
    "euroc_mono.orbit": [
        ("backend.pose_opt_fused", "optimize_pose_fused", _alter_pose),
        ("frontend.extractor", "make_extractor", _alter_features),
    ],
    "euroc_vi.orbit": [
        ("backend.pose_opt_fused", "optimize_pose_fused", _alter_pose),
        ("imu.preintegration", "preintegrate", _alter_preint),
    ],
    "euroc_mono.gba": [
        ("frontend.tracking", "global_ba", _unchanged_gba),
        ("frontend.tracking", "global_ba", _alter_gba),
        ("frontend.tracking", "global_ba", _alter_gba_points),
        ("atlas.map_state", "observation_table", _half_observations),
    ],
}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c, fs in FAULTS.items() for f in fs],
    ids=lambda x: x if isinstance(x, str) else f"{x[1]}-{x[2].__name__}")
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    import importlib

    mod = importlib.import_module(f"orb_slam3_ros2_tpu_torch.{fault[0]}")
    monkeypatch.setattr(mod, fault[1], fault[2](getattr(mod, fault[1])))
    correct, _, _, _, _, checks, _, _ = run_tiny(cell)
    assert not correct and past_limits(checks), checks
