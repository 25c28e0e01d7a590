"""Parity of the port's sharded visual-inertial BA
(`parallel/sharded_vi_ba.py`) with the JAX solver on the 8-device CPU
mesh, at N in {1, 2, 4, 8} shards, on tests/test_sharded_vi_ba.py's clip,
and with the port's one-device `backend/vi_ba.vi_bundle_adjust` under the
same priors. With `opt_gravity=True` the port returns the solved gravity
tangent, equal to the one-device solver's; the JAX wrapper returns zeros
(its sharded_vi_ba.py:183), which the port does not carry over."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.parallel import mesh as jmesh
from orb_slam3_ros2_tpu.parallel import sharded_vi_ba as jsvi
from orb_slam3_ros2_tpu_torch.backend import vi_ba as tvi
from orb_slam3_ros2_tpu_torch.imu import preintegration as tpre
from orb_slam3_ros2_tpu_torch.parallel import mesh as tmesh
from orb_slam3_ros2_tpu_torch.parallel import sharded_vi_ba as tsvi
from tests.test_sharded_vi_ba import _vi_problem
from tests.test_torch_sharded_ba import (  # noqa: F401
    torch_problem, two_threads)

R_ATOL, T_ATOL, COST_RTOL = 1e-4, 3e-3, 2e-2  # test_multiprocess.py:107-109
V_ATOL, BG_ATOL = 3e-3, 1e-4
THG_ATOL = 1e-3
N_ITERS = 10
PRIORS = dict(prior_bg=1e1, prior_ba=1e0)  # test_sharded_vi_ba.py:60


@pytest.fixture(scope="module")
def clip():
    sc, p, pres, v_init, v_gt, true_bg = _vi_problem(K=6, L=128)
    tpres = tpre.Preintegrated(*(torch.from_numpy(np.array(f))
                                 for f in pres))
    return dict(sc=sc, p=p, pres=pres, v_init=v_init, v_gt=v_gt,
                true_bg=true_bg, tp=torch_problem(p), tpres=tpres,
                tv=torch.from_numpy(np.array(v_init)))


def port_solve(c, n, opt_gravity=False):
    sc = c["sc"]
    solver = tsvi.make_sharded_vi_ba(
        tmesh.make_mesh(n, devices=["cpu"] * n), sc.fx, sc.fy, sc.cx, sc.cy,
        n_iters=N_ITERS, opt_gravity=opt_gravity, **PRIORS)
    z = torch.zeros(3)
    return solver(c["tp"], c["tpres"], c["tv"], z, z)


def one_device(c, opt_gravity=False):
    sc = c["sc"]
    z = torch.zeros(3)
    return tvi.vi_bundle_adjust(
        c["tp"], c["tpres"], c["tv"], z, z, sc.fx, sc.fy, sc.cx, sc.cy,
        n_iters=N_ITERS, opt_gravity=opt_gravity, **PRIORS)


def assert_close(out, ref):
    np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=R_ATOL)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=T_ATOL)
    np.testing.assert_allclose(out.v.numpy(), np.asarray(ref.v), atol=V_ATOL)
    np.testing.assert_allclose(out.bg.numpy(), np.asarray(ref.bg),
                               atol=BG_ATOL)
    np.testing.assert_allclose(float(out.cost), float(ref.cost),
                               rtol=COST_RTOL)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_vi_ba_matches_jax_and_one_device(clip, n):
    sc = clip["sc"]
    mesh = jmesh.make_mesh(n)
    ref = jsvi.make_sharded_vi_ba(mesh, sc.fx, sc.fy, sc.cx, sc.cy,
                                  n_iters=N_ITERS, **PRIORS)(
        jsvi.shard_vi_problem(clip["p"], mesh), clip["pres"],
        clip["v_init"], jnp.zeros(3), jnp.zeros(3))
    out = port_solve(clip, n)
    assert_close(out, ref)
    assert_close(out, one_device(clip))
    t_err = np.linalg.norm(out.t.numpy() - sc.t_cw, axis=-1).mean()
    assert t_err < 2e-2, t_err
    np.testing.assert_allclose(out.bg.numpy(), clip["true_bg"], atol=5e-3)


@pytest.mark.parametrize("n", [1, 8])
def test_solved_gravity_tangent_is_returned(clip, n):
    sc = clip["sc"]
    ref = one_device(clip, opt_gravity=True)
    out = port_solve(clip, n, opt_gravity=True)
    assert float(out.thg.abs().max()) > 0.0
    np.testing.assert_allclose(out.thg.numpy(), ref.thg.numpy(),
                               atol=THG_ATOL)
    assert_close(out, ref)
    # the JAX wrapper drops it
    mesh = jmesh.make_mesh(n)
    jout = jsvi.make_sharded_vi_ba(mesh, sc.fx, sc.fy, sc.cx, sc.cy,
                                   n_iters=N_ITERS, opt_gravity=True,
                                   **PRIORS)(
        jsvi.shard_vi_problem(clip["p"], mesh), clip["pres"],
        clip["v_init"], jnp.zeros(3), jnp.zeros(3))
    assert np.all(np.asarray(jax.device_get(jout.thg)) == 0.0)
