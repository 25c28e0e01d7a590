"""The BA's LM stages as CUDA graphs (`backend/stage_graphs.py`): a solve
that replays is bitwise the eager solve, what a caller keeps is never a
graph's buffer, each key is captured once, and the direct callers of
`schur.*` leave `bundle_adjust`'s graphs alone (the sharded BAs stay
eager; the VI BA keeps graphs of its own, `tests/test_torch_vi_ba_no_sync.
py`). The tests marked `cuda` skip without a card; the
CPU test holds `bundle_adjust` to the loop it ran before the graphs."""

import pytest
import torch

from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
from orb_slam3_ros2_tpu_torch.backend import ba, schur, stage_graphs
from orb_slam3_ros2_tpu_torch.backend import vi_ba
from orb_slam3_ros2_tpu_torch.frontend import tracking as trk
from orb_slam3_ros2_tpu_torch.geom import lie
from orb_slam3_ros2_tpu_torch.imu import preintegration as pre
from orb_slam3_ros2_tpu_torch.parallel import mesh as mesh_mod
from orb_slam3_ros2_tpu_torch.parallel import sharded_ba
from tests.test_torch_ba_no_sync import CAM, tiny_map

COUNTERS = ("graph_captures", "graph_replays", "eager_stages")
N_ITERS = 8  # iteration 5 refreshes the chi2 gate


def problem(device, n_kf=8, max_kf=16, n_lm=256, seed=0):
    """The global BA's problem over tiny_map's n_kf keyframes (a power of
    two, so the window has no pad), as `local_ba` builds it."""
    m, n_kf = tiny_map(device, n_kf=n_kf, max_kf=max_kf, n_lm=n_lm,
                       seed=seed)
    ids, fix = trk.global_ba_window(n_kf, max_kf, device)
    uv, w, ok = ms.observation_table(m, ids)
    ids = ids.long()
    return ba.BAProblem(R=m.kf_R[ids], t=m.kf_t[ids], X=m.lm_X, uv=uv,
                        w=w * ok[:, None], fixed=fix | ~ok,
                        point_valid=m.lm_valid)


def counts():
    return {c: getattr(ba.bundle_adjust, c) for c in COUNTERS}


def delta(before):
    return {c: getattr(ba.bundle_adjust, c) - before[c] for c in COUNTERS}


class Record:
    """Wrappers on `schur.*` as `slambench/harness.BACosts` sets them: each
    call's cost0, candidate cost and chi2 gate, as returned."""

    def __init__(self, monkeypatch):
        self.cost0, self.cost1, self.gates = [], [], []

        def wrap(name, keep):
            orig = getattr(schur, name)

            def f(*a, **k):
                out = orig(*a, **k)
                keep(out)
                return out
            monkeypatch.setattr(schur, name, f)

        wrap("schur_reduce", lambda t: self.cost0.append(t.cost0))
        wrap("robust_cost", lambda c: self.cost1.append(c))
        wrap("refresh_weights", lambda w: self.gates.append(w))

    def take(self):
        out = (self.cost0, self.cost1, self.gates)
        self.cost0, self.cost1, self.gates = [], [], []
        return out


class _Eager:
    """A stand-in for the graph cache that gives every solve no graphs."""

    def solve(self, *problem):
        return None


def solve(p):
    return ba.bundle_adjust(p, *CAM, n_iters=N_ITERS)


def eager_solve(p, monkeypatch):
    with monkeypatch.context() as mp:
        mp.setattr(ba, "_GRAPHS", _Eager())
        return solve(p)


def assert_same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, list):
            assert len(x) == len(y)
            assert_same(x, y)
        else:
            assert torch.equal(x, y)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def fresh_graphs(monkeypatch):
    """A graph cache of the test's own, so that each key is new."""
    monkeypatch.setattr(ba, "_GRAPHS", stage_graphs.StageGraphs(ba._count))


@pytest.mark.cuda
def test_replayed_solve_is_bitwise_the_eager_solve(cuda_device,
                                                   fresh_graphs,
                                                   monkeypatch):
    p = problem(cuda_device)
    rec = Record(monkeypatch)
    ref = eager_solve(p, monkeypatch)
    ref_costs = rec.take()
    assert len(ref_costs[2]) == 1
    for _ in range(3):  # captures, then the last stages', then replays
        before = counts()
        out = solve(p)
        assert_same(out, ref)
        assert_same(rec.take(), ref_costs)
    assert delta(before) == dict(graph_captures=0, graph_replays=34,
                                 eager_stages=0)


@pytest.mark.cuda
def test_kept_tensors_are_not_graph_buffers(cuda_device, fresh_graphs,
                                            monkeypatch):
    """What a caller keeps holds its value while later solves of another
    map of the same shape replay."""
    p, q = problem(cuda_device), problem(cuda_device, seed=1)
    rec = Record(monkeypatch)
    for _ in range(3):
        out = solve(p)
    kept = rec.take()
    values = ([[x.clone() for x in xs] for xs in kept],
              [x.clone() for x in out])
    for _ in range(2):
        other = solve(q)
    assert not torch.equal(other.X, out.X)
    assert_same((list(kept), list(out)), values)


@pytest.mark.cuda
def test_each_key_is_captured_once(cuda_device, fresh_graphs):
    p = problem(cuda_device)
    torch.cuda.synchronize()
    before = counts()
    solve(p)
    # a stage that reads another's outputs is keyed apart while that one
    # still runs eagerly, so the captures follow the data: the reduce and
    # the cost (of copied poses and points, the final cost's key too) in
    # iteration 1, the solve in 2, the update in 3, the cost of the
    # update's outputs in 4; the refresh (iteration 5) is seen once
    assert delta(before) == dict(graph_captures=5, graph_replays=20,
                                 eager_stages=9)
    before = counts()
    solve(p)
    assert delta(before) == dict(graph_captures=1, graph_replays=33,
                                 eager_stages=0)
    before = counts()
    solve(p)
    assert delta(before) == dict(graph_captures=0, graph_replays=34,
                                 eager_stages=0)


@pytest.mark.cuda
def test_a_second_size_has_its_own_graphs(cuda_device, fresh_graphs,
                                          monkeypatch):
    small, large = problem(cuda_device), problem(cuda_device, n_kf=16)
    ref = eager_solve(small, monkeypatch)
    for _ in range(3):
        solve(small)
    before = counts()
    for _ in range(3):
        solve(large)
    assert delta(before)["graph_captures"] == 6
    before = counts()
    assert_same(solve(small), ref)
    assert delta(before) == dict(graph_captures=0, graph_replays=34,
                                 eager_stages=0)


@pytest.mark.cuda
def test_the_least_recent_size_is_dropped(cuda_device, fresh_graphs):
    sizes = [2 ** i for i in range(1, stage_graphs.MAX_GROUPS + 2)]
    problems = [problem(cuda_device, n_kf=n, max_kf=sizes[-1])
                for n in sizes]
    for p in problems:
        solve(p)
    assert len(ba._GRAPHS.groups) == stage_graphs.MAX_GROUPS
    before = counts()
    solve(problems[0])  # its graphs went with its group: seen anew
    assert delta(before) == dict(graph_captures=5, graph_replays=20,
                                 eager_stages=9)


@pytest.mark.cuda
def test_direct_callers_stay_eager(cuda_device, fresh_graphs):
    p = problem(cuda_device)
    solve(p)
    before = counts()
    mesh = mesh_mod.make_mesh(1, devices=[cuda_device])
    sharded_ba.make_sharded_ba(mesh, *CAM, n_iters=N_ITERS)(p)
    K = p.R.shape[0]
    n = 10
    imu = pre.stack([pre.preintegrate(
        torch.zeros((n, 3), device=cuda_device),
        torch.tensor([0.0, 0.0, 9.81], device=cuda_device).expand(n, 3),
        torch.full((n,), 0.005, device=cuda_device),
        torch.ones(n, dtype=torch.bool, device=cuda_device))
        for _ in range(K - 1)])
    zero = torch.zeros(3, device=cuda_device)
    vi_ba.vi_bundle_adjust(p, imu, torch.zeros((K, 3), device=cuda_device),
                           zero, zero, *CAM, n_iters=N_ITERS)
    torch.cuda.synchronize()
    assert delta(before) == dict(graph_captures=0, graph_replays=0,
                                 eager_stages=0)


def test_cpu_bundle_adjust_runs_eagerly():
    """On the CPU the counters stay still and the solve is bitwise the
    loop `bundle_adjust` ran before its stages took graphs."""
    p = problem(torch.device("cpu"), n_lm=64)
    before = counts()
    out = ba.bundle_adjust(p, *CAM, n_iters=6, reclassify_every=3)
    assert delta(before) == dict(graph_captures=0, graph_replays=0,
                                 eager_stages=0)
    fx, fy, cx, cy = CAM
    R, t, X, w = p.R, p.t, p.X, p.w
    lam = torch.full((), 1e-4)
    for it in range(6):
        if it == 3:
            w = schur.refresh_weights(R, t, X, p.uv, p.w, *CAM,
                                      ba.res.CHI2_MONO)
        terms = schur.schur_reduce(R, t, X, p.uv, w, *CAM, lam)
        dxc = schur.solve_cameras(terms.Hcc_p, terms.S_off, terms.rhs_p,
                                  p.fixed, lam, ba.FIXED_PRIOR)
        dxl = schur.back_substitute(terms, dxc, p.point_valid)
        R1, t1 = lie.se3_retract(R, t, dxc)
        R1, X1 = lie.se3_normalize(R1), X + dxl
        better = schur.robust_cost(R1, t1, X1, p.uv, w, fx, fy, cx,
                                   cy) < terms.cost0
        R, t, X = (torch.where(better, a, b)
                   for a, b in ((R1, R), (t1, t), (X1, X)))
        lam = torch.where(better, lam * 0.3, lam * 5.0).clamp(1e-9, 1e3)
    cost = schur.robust_cost(R, t, X, p.uv, w, *CAM)
    assert_same(out, (R, t, X, cost, w))
