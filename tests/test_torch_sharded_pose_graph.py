"""Parity of the port's edge-sharded pose graph
(`parallel/sharded_pose_graph.py`) with the JAX optimizer on the 8-device
CPU mesh, at N in {1, 2, 4, 8} shards, on tests/test_sharded_pose_graph.py's
drifted loop, and with the port's replicated
`loop/pose_graph.optimize_pose_graph`."""

import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.parallel import mesh as jmesh
from orb_slam3_ros2_tpu.parallel import sharded_pose_graph as jspg
from orb_slam3_ros2_tpu_torch.loop import pose_graph as tpg
from orb_slam3_ros2_tpu_torch.parallel import mesh as tmesh
from orb_slam3_ros2_tpu_torch.parallel import sharded_pose_graph as tspg
from tests.test_sharded_pose_graph import _loop_problem
from tests.test_torch_sharded_ba import two_threads  # noqa: F401

# tests/test_sharded_pose_graph.py:103-108: sharded against replicated
R_ATOL, T_ATOL, S_ATOL = 5e-4, 5e-3, 5e-4
N_ITERS = 15


@pytest.fixture(scope="module")
def loop():
    out = _loop_problem()
    jargs = out[:10]
    targs = tuple(torch.from_numpy(np.array(a)) for a in jargs)
    return jargs, targs, out[10], out[11]


@pytest.fixture(scope="module")
def replicated(loop):
    _, targs, _, _ = loop
    return tpg.optimize_pose_graph(*targs, n_iters=N_ITERS)


def assert_close(out, R, t, s):
    np.testing.assert_allclose(out.R.numpy(), np.asarray(R), atol=R_ATOL)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(t), atol=T_ATOL)
    np.testing.assert_allclose(out.s.numpy(), np.asarray(s), atol=S_ATOL)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_pose_graph_matches_jax_and_replicated(loop, replicated, n):
    jargs, targs, Rg, tg = loop
    K = jargs[0].shape[0]
    ref = jspg.make_sharded_pose_graph(jmesh.make_mesh(n), K,
                                       n_iters=N_ITERS)(*jargs)
    out = tspg.make_sharded_pose_graph(
        tmesh.make_mesh(n, devices=["cpu"] * n), K, n_iters=N_ITERS)(*targs)
    assert_close(out, ref.R, ref.t, ref.s)
    assert_close(out, replicated.R, replicated.t, replicated.s)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=2e-2,
                               atol=1e-6)
    # the loop closed: camera centres near the ground truth
    c = -np.einsum("kji,kj->ki", out.R.numpy(), out.t.numpy()) / \
        out.s.numpy()[:, None]
    cg = -np.einsum("kji,kj->ki", Rg, tg)
    assert np.linalg.norm(c - cg, axis=-1).max() < 0.08


def test_uneven_edge_split_raises(loop):
    _, targs, _, _ = loop
    with pytest.raises(ValueError, match="not divisible"):
        tspg.make_sharded_pose_graph(
            tmesh.make_mesh(5, devices=["cpu"] * 5), targs[0].shape[0])(
                *targs)
