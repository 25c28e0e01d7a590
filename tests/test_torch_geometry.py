"""Parity of the port's geometry (lie, cameras, chol_small, residuals) with
the JAX package on the CPU, on the same seeded numpy inputs (atol 1e-5)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_ros2_tpu.backend import residuals as jres
from orb_slam3_ros2_tpu.geom import lie as jlie
from orb_slam3_ros2_tpu.models import cameras as jcam
from orb_slam3_ros2_tpu.ops import chol_small as jchol
from orb_slam3_ros2_tpu_torch.backend import residuals as tres
from orb_slam3_ros2_tpu_torch.geom import lie as tlie
from orb_slam3_ros2_tpu_torch.models import cameras as tcam
from orb_slam3_ros2_tpu_torch.ops import chol_small as tchol

ATOL = 1e-5


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _rand_pose(rng, batch, scale=1.0):
    phi = rng.normal(0, scale, (batch, 3)).astype(np.float32)
    t = rng.normal(0, 1, (batch, 3)).astype(np.float32)
    return _np(jlie.so3_exp(jnp.asarray(phi))), t


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 0.5, 2.0])
def test_so3_exp_and_se3_exp(scale):
    """Both sides of the Taylor guard (theta^2 < 1e-8)."""
    rng = np.random.default_rng(0)
    xi = rng.normal(0, scale, (64, 6)).astype(np.float32)
    np.testing.assert_allclose(tlie.so3_exp(_t(xi[:, 3:])).numpy(),
                               _np(jlie.so3_exp(jnp.asarray(xi[:, 3:]))),
                               atol=ATOL)
    Rj, tj = jlie.se3_exp(jnp.asarray(xi))
    Rt, tt = tlie.se3_exp(_t(xi))
    np.testing.assert_allclose(Rt.numpy(), _np(Rj), atol=ATOL)
    np.testing.assert_allclose(tt.numpy(), _np(tj), atol=ATOL)


def test_se3_compose_inverse_apply():
    rng = np.random.default_rng(1)
    Ra, ta = _rand_pose(rng, 16)
    Rb, tb = _rand_pose(rng, 16)
    x = rng.normal(0, 3, (16, 3)).astype(np.float32)
    for fj, ft, args in [
        (jlie.se3_compose, tlie.se3_compose, (Ra, ta, Rb, tb)),
        (jlie.se3_inverse, tlie.se3_inverse, (Ra, ta)),
    ]:
        for a, b in zip(fj(*map(jnp.asarray, args)), ft(*map(_t, args))):
            np.testing.assert_allclose(b.numpy(), _np(a), atol=ATOL)
    np.testing.assert_allclose(
        tlie.se3_apply(_t(Ra), _t(ta), _t(x)).numpy(),
        _np(jlie.se3_apply(jnp.asarray(Ra), jnp.asarray(ta), jnp.asarray(x))),
        atol=ATOL)


@pytest.mark.parametrize("scale", [1e-6, 0.05])
def test_se3_retract_and_normalize(scale):
    rng = np.random.default_rng(2)
    R, t = _rand_pose(rng, 32)
    xi = rng.normal(0, scale, (32, 6)).astype(np.float32)
    Rj, tj = jlie.se3_retract(jnp.asarray(R), jnp.asarray(t), jnp.asarray(xi))
    Rt, tt = tlie.se3_retract(_t(R), _t(t), _t(xi))
    np.testing.assert_allclose(Rt.numpy(), _np(Rj), atol=ATOL)
    np.testing.assert_allclose(tt.numpy(), _np(tj), atol=ATOL)
    noisy = R + rng.normal(0, 1e-2, R.shape).astype(np.float32)
    np.testing.assert_allclose(tlie.se3_normalize(_t(noisy)).numpy(),
                               _np(jlie.se3_normalize(jnp.asarray(noisy))),
                               atol=ATOL)


RADTAN = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)


@pytest.mark.parametrize("model,dist", [("PinHole", RADTAN),
                                        ("PinHole", (0.0,) * 5),
                                        ("Rectified", ())])
def test_camera_project_unproject(model, dist):
    """EuRoC cam0 intrinsics and radtan coefficients."""
    args = (model, 458.654, 457.296, 367.215, 248.375, dist, 752, 480)
    cj, ct = jcam.make_camera(*args), tcam.make_camera(*args)
    assert ct.params == cj.params and ct.model == int(cj.model)
    rng = np.random.default_rng(3)
    uv = rng.uniform([0, 0], [752, 480], (256, 2)).astype(np.float32)
    np.testing.assert_allclose(tcam.unproject(ct, _t(uv)).numpy(),
                               _np(jcam.unproject(cj, jnp.asarray(uv))),
                               atol=ATOL)
    x = np.stack([rng.uniform(-2, 2, 256), rng.uniform(-1.5, 1.5, 256),
                  rng.uniform(2, 8, 256)], -1).astype(np.float32)
    np.testing.assert_allclose(tcam.project(ct, _t(x)).numpy(),
                               _np(jcam.project(cj, jnp.asarray(x))),
                               atol=1e-3)  # pixels: 1e-5 relative to ~500
    np.testing.assert_allclose(ct.K().numpy(),
                               _np(cj.K), atol=ATOL)


def test_kb8_is_not_ported_yet():
    """Named for the time KB8 raised; it is ported now, so the same camera
    unprojects (the image corner included) and projects as the JAX
    functions do, within ATOL on rays and 1e-3 px on pixels."""
    cam = tcam.make_camera("KannalaBrandt8", 190.0, 190.0, 254.0, 256.0,
                           (0.0034, 0.0007, -0.002, 0.0002), 512, 512)
    jc = jcam.make_camera("KannalaBrandt8", 190.0, 190.0, 254.0, 256.0,
                          (0.0034, 0.0007, -0.002, 0.0002), 512, 512)
    uv = np.array([[0.0, 0.0], [254.0, 256.0], [400.0, 100.0],
                   [130.5, 480.25]], np.float32)
    rays = tcam.unproject(cam, _t(uv)).numpy()
    np.testing.assert_allclose(rays, _np(jcam.unproject(jc, jnp.asarray(uv))),
                               atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(
        tcam.project(cam, _t(rays)).numpy(),
        _np(jcam.project(jc, jnp.asarray(rays))), atol=1e-3)


@pytest.mark.parametrize("n", [3, 6])
def test_cholesky_solve_small(n):
    rng = np.random.default_rng(4)
    A = rng.normal(size=(n, n)).astype(np.float32)
    A = (A @ A.T + n * np.eye(n)).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    got = tchol.cholesky_solve_small(_t(A), _t(b)).numpy()
    np.testing.assert_allclose(
        got, _np(jchol.cholesky_solve_small(jnp.asarray(A), jnp.asarray(b))),
        atol=ATOL)
    np.testing.assert_allclose(got, np.linalg.solve(A, b), atol=1e-4)


def test_reproj_residual_and_huber():
    rng = np.random.default_rng(5)
    R, t = _rand_pose(rng, 1, scale=0.1)
    R, t = R[0], t[0] * 0.1
    X = np.stack([rng.uniform(-3, 3, 128), rng.uniform(-2, 2, 128),
                  rng.uniform(3, 9, 128)], -1).astype(np.float32)
    uv = rng.uniform(0, 640, (128, 2)).astype(np.float32)
    cam = (400.0, 410.0, 320.0, 240.0)
    pj = jres.reproj_residual(jnp.asarray(R), jnp.asarray(t), jnp.asarray(X),
                              jnp.asarray(uv), *cam)
    pt = tres.reproj_residual(_t(R), _t(t), _t(X), _t(uv), *cam)
    for name in ("r", "J_pose", "J_point", "depth"):
        a, b = _np(getattr(pj, name)), getattr(pt, name).numpy()
        np.testing.assert_allclose(b, a, atol=ATOL * max(1.0, np.abs(a).max()),
                                   err_msg=name)
    r2 = rng.uniform(0, 30, 128).astype(np.float32)
    np.testing.assert_allclose(tres.huber_weight(_t(r2), 2.4477).numpy(),
                               _np(jres.huber_weight(jnp.asarray(r2), 2.4477)),
                               atol=ATOL)
