"""Parity of the port's landmark-sharded BA (`parallel/sharded_ba.py`,
`parallel/mesh.py`) with the JAX solver on the conftest's 8-device CPU
mesh: the same problem (tests/test_sharded_ba.py's) through JAX at N
shards and the port at N CPU shards, N in {1, 2, 4, 8}; the port's N
shards against its own 1 shard; its 1 shard against the one-device
`backend/ba.bundle_adjust` (the same iterations, so the same numbers);
and shard isolation."""

import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.parallel import mesh as jmesh
from orb_slam3_ros2_tpu.parallel import sharded_ba as jsba
from orb_slam3_ros2_tpu_torch.backend import ba as tba
from orb_slam3_ros2_tpu_torch.backend import residuals as tres
from orb_slam3_ros2_tpu_torch.backend import schur as tschur
from orb_slam3_ros2_tpu_torch.parallel import mesh as tmesh
from orb_slam3_ros2_tpu_torch.parallel import sharded_ba as tsba
from tests.test_sharded_ba import _problem

# tests/test_multiprocess.py:107-109: a psum in another order, amplified
# by the damped LM iterations
R_ATOL, T_ATOL, COST_RTOL = 1e-4, 3e-3, 2e-2
N_ITERS = 10


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads, as the System e2e tests: the suite's workers
    share the cores, and torch's default count oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def torch_problem(p) -> tba.BAProblem:
    """A JAX BAProblem's arrays as a CPU torch BAProblem."""
    return tba.BAProblem(*(torch.from_numpy(np.array(f)) for f in p))


def cpu_mesh(n: int) -> tmesh.Mesh:
    return tmesh.make_mesh(n, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def problem():
    return _problem()


@pytest.fixture(scope="module")
def port_one_shard(problem):
    sc, p = problem
    return tsba.make_sharded_ba(cpu_mesh(1), sc.fx, sc.fy, sc.cx, sc.cy,
                                n_iters=N_ITERS)(torch_problem(p))


def assert_close(out, R, t, cost):
    np.testing.assert_allclose(out.R.numpy(), np.asarray(R), atol=R_ATOL)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(t), atol=T_ATOL)
    np.testing.assert_allclose(float(out.cost), float(cost), rtol=COST_RTOL)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_ba_matches_jax_at_n_shards(problem, port_one_shard, n):
    sc, p = problem
    mesh = jmesh.make_mesh(n)
    ref = jsba.make_sharded_ba(mesh, sc.fx, sc.fy, sc.cx, sc.cy,
                               n_iters=N_ITERS)(jsba.shard_problem(p, mesh))
    tm = cpu_mesh(n)
    out = tsba.make_sharded_ba(tm, sc.fx, sc.fy, sc.cx, sc.cy,
                               n_iters=N_ITERS)(
        tsba.shard_problem(torch_problem(p), tm))
    assert tm.shape == {"lm": n}
    assert out.X.shape == tuple(p.X.shape)
    assert_close(out, ref.R, ref.t, ref.cost)
    np.testing.assert_allclose(out.X.numpy(), np.asarray(ref.X), atol=1e-3)
    # and against the port's own single shard
    assert_close(out, port_one_shard.R, port_one_shard.t,
                 port_one_shard.cost)
    t_err = np.linalg.norm(out.t.numpy() - sc.t_cw, axis=-1).mean()
    assert t_err < 5e-3, t_err


def test_one_shard_is_the_one_device_solver(problem, port_one_shard):
    """With one shard the psums add nothing: the iterations are
    `bundle_adjust`'s (same chi2 refresh period), so poses and landmarks
    agree to rounding."""
    sc, p = problem
    ref = tba.bundle_adjust(torch_problem(p), sc.fx, sc.fy, sc.cx, sc.cy,
                            n_iters=N_ITERS,
                            reclassify_every=tsba.REFRESH_EVERY)
    np.testing.assert_allclose(port_one_shard.R.numpy(), ref.R.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(port_one_shard.t.numpy(), ref.t.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(port_one_shard.X.numpy(), ref.X.numpy(),
                               atol=1e-5)


def test_shard_terms_stay_finite_beside_a_poisoned_shard(problem):
    """Shard isolation: landmarks of shard 2 set to NaN where they are
    masked out (point_valid False, no observation). Every other shard's
    first partial sums stay finite, since a shard reads only its own
    slices; shard 2's own terms are what the poison reaches."""
    sc, p = problem
    tp = torch_problem(p)
    n, k = 4, 2
    Ls = tp.X.shape[0] // n
    sl = slice(k * Ls, (k + 1) * Ls)
    X, w, pv = tp.X.clone(), tp.w.clone(), tp.point_valid.clone()
    X[sl] = float("nan")
    w[:, sl] = 0.0
    pv[sl] = False
    poisoned = tp._replace(X=X, w=w, point_valid=pv)
    shards = tsba.shard_problem(poisoned, cpu_mesh(n))
    lam = torch.tensor(1e-4)
    for s, fields in enumerate(zip(*shards)):
        R, t, Xs, uv, ws, fixed, pvs = fields
        parts = next(tsba._shard_step(R, t, Xs, uv, ws, fixed, pvs, lam,
                                      sc.fx, sc.fy, sc.cx, sc.cy))
        finite = all(bool(torch.isfinite(x).all()) for x in parts)
        assert finite == (s != k), (s, finite)


def test_psum_adds_shards_in_order():
    """`Mesh.psum` adds each field over the shards and hands every shard
    the same sums; `run_shards` returns each body's value."""
    mesh = cpu_mesh(3)
    parts = [(torch.tensor([1.0, 2.0]), torch.tensor(3.0 * s))
             for s in range(3)]
    sums = mesh.psum(parts)
    assert len(sums) == 3
    for a, b in sums:
        assert a.tolist() == [3.0, 6.0] and float(b) == 9.0

    def body(s):
        total, = yield (torch.tensor(float(s)),)
        return s, float(total)

    assert tmesh.run_shards(mesh, (body(s) for s in range(3))) == [
        (0, 3.0), (1, 3.0), (2, 3.0)]


def test_uneven_landmark_split_raises(problem):
    sc, p = problem
    with pytest.raises(ValueError, match="not divisible"):
        tsba.shard_problem(torch_problem(p), cpu_mesh(7))


def test_chi2_refresh_is_shard_local(problem):
    """The refresh gates each shard's observations alone: on a shard its
    weights equal those of the whole problem's refresh on its slice."""
    sc, p = problem
    tp = torch_problem(p)
    full = tschur.refresh_weights(tp.R, tp.t, tp.X, tp.uv, tp.w, sc.fx,
                                  sc.fy, sc.cx, sc.cy, tres.CHI2_MONO)
    shards = tsba.shard_problem(tp, cpu_mesh(4))
    parts = [tschur.refresh_weights(R, t, X, uv, w, sc.fx, sc.fy, sc.cx,
                                    sc.cy, tres.CHI2_MONO)
             for R, t, X, uv, w, _, _ in zip(*shards)]
    assert torch.equal(torch.cat(parts, dim=1), full)
