"""Parity of the port's block x landmark sharded BA (`parallel/block_ba.py`)
with the JAX solver on the conftest's 2-D ("kf", "lm") = (2, 4) mesh, on
tests/test_block_ba.py's four map blocks, and of each block with the
port's 1-D sharded solver run on it alone."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.backend import ba as jba
from orb_slam3_ros2_tpu.parallel import block_ba as jblock
from orb_slam3_ros2_tpu.parallel import mesh as jmesh
from orb_slam3_ros2_tpu_torch.backend import ba as tba
from orb_slam3_ros2_tpu_torch.parallel import block_ba as tblock
from orb_slam3_ros2_tpu_torch.parallel import mesh as tmesh
from orb_slam3_ros2_tpu_torch.parallel import sharded_ba as tsba
from tests.test_block_ba import _one_problem
from tests.test_torch_sharded_ba import (  # noqa: F401
    torch_problem, two_threads)

B = 4
T_ATOL = 1e-4  # tests/test_block_ba.py:199: blocks vs the per-block solver
R_ATOL, COST_RTOL = 1e-4, 2e-2  # tests/test_multiprocess.py:107-109


@pytest.fixture(scope="module")
def blocks():
    scenes, problems = zip(*[_one_problem(seed) for seed in range(B)])
    jbatched = jba.BAProblem(*[jnp.stack([getattr(p, f) for p in problems])
                               for f in jba.BAProblem._fields])
    return scenes, problems, jbatched


def test_block_mesh_shape():
    mesh = tmesh.make_mesh(8, axis_names=(tmesh.KF_AXIS, tmesh.LM_AXIS),
                           devices=["cpu"] * 8)
    assert mesh.shape == {"kf": 2, "lm": 4}


def test_block_ba_matches_jax_and_per_block_solver(blocks):
    scenes, problems, jbatched = blocks
    sc0 = scenes[0]
    jm = jmesh.make_mesh(8, axis_names=(jmesh.KF_AXIS, jmesh.LM_AXIS))
    ref = jblock.make_block_sharded_ba(jm, sc0.fx, sc0.fy, sc0.cx, sc0.cy,
                                       n_iters=10)(
        jblock.shard_block_problem(jbatched, jm))
    tm = tmesh.make_mesh(8, axis_names=(tmesh.KF_AXIS, tmesh.LM_AXIS),
                         devices=["cpu"] * 8)
    tbatched = torch_problem(jbatched)
    out = tblock.make_block_sharded_ba(tm, sc0.fx, sc0.fy, sc0.cx, sc0.cy,
                                       n_iters=10)(
        tblock.shard_block_problem(tbatched, tm))
    assert out.R.shape[0] == B and out.cost.shape == (B,)
    np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=R_ATOL)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=T_ATOL)
    np.testing.assert_allclose(out.cost.numpy(), np.asarray(ref.cost),
                               rtol=COST_RTOL)
    assert np.isfinite(out.cost.numpy()).all()
    # every block reproduces the 1-D landmark-sharded solver run on its
    # problem alone, as tests/test_block_ba.py:189-203 holds the JAX one
    m4 = tmesh.make_mesh(4, devices=["cpu"] * 4)
    for b, (sc, p) in enumerate(zip(scenes, problems)):
        one = tsba.make_sharded_ba(m4, sc.fx, sc.fy, sc.cx, sc.cy,
                                   n_iters=10)(torch_problem(p))
        np.testing.assert_allclose(out.t[b].numpy(), one.t.numpy(),
                                   atol=T_ATOL, err_msg=f"block {b}")
        t_err = np.linalg.norm(out.t[b].numpy() - sc.t_cw, axis=-1).mean()
        assert t_err < 8e-3, (b, t_err)  # scene noise floor


def test_uneven_blocks_raise(blocks):
    _, _, jbatched = blocks
    tm = tmesh.make_mesh(8, axis_names=(tmesh.KF_AXIS, tmesh.LM_AXIS),
                         devices=["cpu"] * 8)
    three = tba.BAProblem(*(f[:3] for f in torch_problem(jbatched)))
    with pytest.raises(ValueError, match="divisible"):
        tblock.make_block_sharded_ba(tm, 300.0, 300.0, 160.0, 120.0)(three)
