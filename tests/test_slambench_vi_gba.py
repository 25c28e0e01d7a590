"""The inertial global BA of the `euroc_vi.gba` cell on the CPU at a tiny
size: the program's solve (`runtime/system.vi_ba2`, as the cell runs it)
against the plain float64 VI BA of `slambench/reference/vi_ba.py` on
whole seeded maps of the `vi_gba_map` traffic; the true state as a fixed
point of both at zero noise; the program with its inertial factor or its
bias correction taken out, past the cell's limits; and the cell's command
path (`run.run_cell`) with the traffic cut to the CPU.

Tolerances of the seeded comparison, float32 against float64: the total
costs (~3e3) are sums of ~1.5e3 float32 terms, so they part by ~1e-7
relative, tolerance 1e-5; the end states part where float32 rounding
moves the LM's steps, 1e-5 of the centres' spread and of the speed in
readings, tolerance 5e-4 (the cell's sound runs read ~5e-6, its control
~1e-3); the biases 1e-7 in readings, tolerance 1e-5 rad/s for the
gyro (0.1% of the true bias) and 1e-4 m/s² for the accelerometer (its
prior holds it within 1e-3 of zero)."""

import ast
import copy

import numpy as np
import pytest
import torch

from slambench import harness, run, scene
from slambench.gen import vi_gba_map
from slambench.reference import vi_ba as ref_vi

CELL = "euroc_vi.gba"
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CPU = torch.device("cpu")
SEED = 2147483659


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(**traffic):
    """The cell's configuration and traffic cut for the CPU: 8
    keyframes (7 intervals of 50 IMU samples) and 192 landmarks."""
    w, c = run.cell_of(BENCH, CELL)
    cfg = harness.load_json(harness.ROOT / c["file"])
    tr = harness.load_json(harness.ROOT / "slambench" / "traffic"
                           / f"{w['traffic']}.json")
    tr.update(keyframes=8, landmarks=192, candidates=1500, trace_solves=1)
    tr.update(traffic)
    return cfg, tr


def limits():
    return harness.load_json(harness.ROOT / "slambench" / "limits"
                             / f"{CELL}.json")


def solved(seed=SEED, cfg=None, tr=None):
    """(workload after its set-up's solve, the reference's end state, the
    gaps between the two)."""
    if cfg is None:
        cfg, tr = tiny()
    wl = vi_gba_map.Workload(cfg, tr, seed, CPU, False)
    wl.setup()
    prob = wl.reference_problem()
    ref = ref_vi.bundle_adjust(prob, wl.cam, wl.n_iters)
    return wl, ref, ref_vi.gaps(prob, wl.cam, wl.sample, ref)


@pytest.mark.parametrize("seed", [SEED, 3000000019, 4100000023])
def test_vi_ba2_matches_the_plain_vi_ba(seed):
    wl, ref, g = solved(seed)
    assert g["cost_gap"] <= 1e-5, g
    assert g["pose_gap"] <= 5e-4, g
    assert g["velocity_gap"] <= 5e-4, g
    assert g["bg_gap"] <= 1e-5 and g["ba_gap"] <= 1e-4, g
    # the solve did work: the start was 3 cm and 0.005 rad off
    c0 = ref_vi.centres(wl.prob.R.double(), wl.prob.t.double())
    assert float((ref_vi.centres(ref[0], ref[1]) - c0).norm(
        dim=-1).max()) > 5e-3


@pytest.mark.parametrize("seed", [SEED, 3000000019])
def test_each_step_is_the_float64_step(seed, monkeypatch):
    """From each float32 state of the solve, the program's LM step lies
    within 5e-4 (relative norm) of the step its own code takes from that
    state in float64 throughout: its linearization is float64 but for
    S = V Vᵀ. Readings 5e-8–7e-5 over 10 iterations; a float32
    linearization reads 2e-5 at the first step and 6e-4–5e-1 from the
    third on, as the gradient shrinks to its rounding."""
    from orb_slam3_ros2_tpu_torch.backend import schur, vi_ba

    reduce, inertial, solve = (schur.schur_reduce, vi_ba._inertial_stage,
                               vi_ba._solve)
    f64 = lambda x: (x.double() if isinstance(x, torch.Tensor)
                     and x.is_floating_point() else x)
    twin, errs = {}, []

    def twin_reduce(*a, **k):
        twin["reduce"] = reduce(*map(f64, a))
        return reduce(*a, **k)

    def twin_inertial(*a):
        twin["inertial"] = inertial(*map(f64, a))
        return inertial(*a)

    def compared_solve(S_off, Hcc_p, rhs_p, JtJ, Jtr, *rest):
        t, (_, JtJ64, Jtr64) = twin["reduce"], twin["inertial"]
        ref = solve(t.S_off, t.Hcc_p, t.rhs_p, JtJ64, Jtr64,
                    *map(f64, rest))
        dx = solve(S_off, Hcc_p, rhs_p, JtJ, Jtr, *rest)
        errs.append(float((dx.double() - ref).norm() / ref.norm()))
        return dx

    monkeypatch.setattr(schur, "schur_reduce", twin_reduce)
    monkeypatch.setattr(vi_ba, "_inertial_stage", twin_inertial)
    monkeypatch.setattr(vi_ba, "_solve", compared_solve)
    cfg, tr = tiny()
    vi_gba_map.Workload(cfg, tr, seed, CPU, False).setup()
    assert len(errs) == tr["n_iters"] and max(errs) <= 5e-4, errs


def _exact_deltas(wl, tr, T):
    """(ΔR, Δv, Δp) of each interval from the true body states at the
    keyframe times (float64): the deltas an exact preintegration of a
    noise-free IMU would give."""
    body = scene.BodyTrajectory(vi_gba_map.orbit_of(tr), T)
    ts, h = wl.times, 1e-4
    R, p = body.rotation(ts), body.position(ts)
    v = (body.position(ts + h) - body.position(ts - h)) / (2 * h)
    g = np.asarray(ref_vi.GRAVITY)
    dt = np.diff(ts)[:, None]
    RiT = np.swapaxes(R[:-1], 1, 2)
    dR = RiT @ R[1:]
    dv = np.einsum("eij,ej->ei", RiT, v[1:] - v[:-1] - g * dt)
    dp = np.einsum("eij,ej->ei", RiT,
                   p[1:] - p[:-1] - v[:-1] * dt - 0.5 * g * dt * dt)
    return v, dR, dv, dp


def test_the_true_state_is_a_fixed_point_of_both():
    """No pixel noise and no perturbation, the true velocities and biases,
    and each interval's deltas exact (from the true body states; an Euler
    preintegration of the orbit parts from them by its discretization,
    ~mm over an interval): neither solve moves a centre by more than
    1e-5 m or a velocity by more than 1e-4 m/s, which float32's rounding
    of the map's poses and of the deltas leaves."""
    cfg, tr = tiny(obs_noise_px=0.0, pose_perturb_m=0.0,
                   pose_perturb_rad=0.0, point_perturb_m=0.0,
                   bias_start_sigma=0.0, n_iters=3)
    st = cfg["settings"]
    for k in ("IMU.GyroWalk", "IMU.AccWalk"):
        st[k] = 0.0
    wl = vi_gba_map.Workload(cfg, tr, SEED, CPU, False)
    wl.setup()
    T = np.asarray(st["IMU.T_b_c1"]["data"], np.float64).reshape(4, 4)
    v_true, dR, dv, dp = _exact_deltas(wl, tr, T)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    f64 = lambda x: torch.as_tensor(np.asarray(x, np.float64))
    wl.args["v0"] = f32(v_true)
    wl.args["pres"] = wl.args["pres"]._replace(dR=f32(dR), dv=f32(dv),
                                                dp=f32(dp))
    prog = wl.solve()
    prob = wl.reference_problem()
    prob = prob._replace(v=f64(np.float32(v_true)), pre=prob.pre._replace(
        dR=f64(dR), dv=f64(dv), dp=f64(dp)))
    ref = ref_vi.bundle_adjust(prob, wl.cam, wl.n_iters)
    c0 = ref_vi.centres(wl.prob.R.double(), wl.prob.t.double())
    v0 = f64(v_true)
    for R, t, v in ((prog[0], prog[1], prog[3]), (ref[0], ref[1], ref[3])):
        moved = ref_vi.centres(R.double(), t.double()) - c0
        assert float(moved.norm(dim=-1).max()) <= 1e-5
        assert float((v.double() - v0).norm(dim=-1).max()) <= 1e-4


def _no_inertial(orig):
    def f(*a, **k):
        r, J = orig(*a, **k)
        return r * 0.0, None if J is None else J * 0.0
    return f


def _no_bias_correction(orig):
    return lambda pre, bg, ba: (pre.dR, pre.dv, pre.dp)


@pytest.mark.parametrize("module,name,fault", [
    ("backend.vi_ba", "_inertial_terms", _no_inertial),
    ("imu.preintegration", "bias_corrected", _no_bias_correction),
], ids=["no_inertial_factor", "no_bias_correction"])
def test_a_broken_solve_is_past_a_limit(module, name, fault, monkeypatch):
    import importlib

    mod = importlib.import_module(f"orb_slam3_ros2_tpu_torch.{module}")
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    _, _, g = solved()
    lim = limits()
    assert any(g[k[3:]] > v for k, v in lim.items()), (g, lim)


def test_the_control_is_the_program_a_precision_step_down():
    """The control linearizes in float32 with TF32 on, and both settings
    come back after it; its solve is another than the program's."""
    from orb_slam3_ros2_tpu_torch.backend import vi_ba

    tf32 = torch.backends.cuda.matmul.allow_tf32
    with vi_gba_map.stepped_down():
        assert vi_ba.LIN is torch.float32
        assert torch.backends.cuda.matmul.allow_tf32
    assert vi_ba.LIN is torch.float64
    assert torch.backends.cuda.matmul.allow_tf32 == tf32
    wl, _, _ = solved()
    raw = wl.check(control=True)
    assert all(c is not None for _, _, c in raw)
    assert any(c != r for _, r, c in raw), raw


@pytest.mark.parametrize("trace", [False, True])
def test_cell_path(trace):
    """Two iterations a solve, so that a loaded CPU completes solves in
    the window, the traced one under the profiler included."""
    cfg, tr = tiny(n_iters=2)
    correct, att, failed, metrics, _, checks, brk, _ = run.run_cell(
        BENCH, CELL, SEED, 3.0, trace, CPU, config=cfg, traffic=tr)
    assert att > 0 and failed == 0
    assert {n for n, _, _ in checks} == set(limits())
    assert correct, checks
    layer = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in run.for_cell(BENCH[layer], CELL)}
    if trace:
        assert brk is not None and set(metrics) <= want
    else:
        assert set(metrics) == want == {"gba_ms", "setup_s"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".", 1)[0]


def test_the_reference_imports_nothing_of_the_program_or_jax():
    bench = harness.ROOT / "slambench"
    ref = set(_imports(bench / "reference" / "vi_ba.py"))
    assert not ref & {"jax", "jaxlib", "flax", "orb_slam3_ros2_tpu",
                      "orb_slam3_ros2_tpu_torch"}, ref
    for path in [bench / "gen" / "vi_gba_map.py", bench / "vi_spans.py",
                 bench / "vi_costs.py", bench / "roofline_vi.py"] + sorted(
            (bench / "metrics").glob("vi_*.py")):
        assert not set(_imports(path)) & {"jax", "jaxlib", "flax",
                                          "orb_slam3_ros2_tpu"}, path


def test_the_benchmark_entries():
    """The configuration and the cell as the benchmark runs them: the
    published file, one chip, and `gba_ms` and the five `vi_*` metrics
    listing the cell."""
    cfg = next(c for c in BENCH["configs"] if c["name"] == "euroc_vi")
    assert cfg["file"] == "slambench/configs/euroc_vi.json"
    assert cfg["reduced"] == ["frames", "trajectory"]
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "euroc_vi", "vi_gba_map", 1)
    tr = harness.load_json(harness.ROOT / "slambench" / "traffic"
                           / "vi_gba_map.json")
    assert (tr["keyframes"], tr["landmarks"], tr["n_iters"]) == (
        256, 8192, 10)
    names = {m["name"] for m in run.for_cell(BENCH["per_layer"], CELL)}
    assert names == {"vi_iter_device_ms", "vi_inertial_device_ms",
                     "vi_solve_device_ms", "vi_launches_per_iter",
                     "vi_iter_roofline"}
    assert {m["name"] for m in run.for_cell(BENCH["end_to_end"],
                                            CELL)} == {"gba_ms", "setup_s"}
    assert copy.deepcopy(limits()).keys() == {
        "vi_cost_gap", "vi_pose_gap", "vi_velocity_gap"}
