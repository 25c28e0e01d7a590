"""Parity of the port's KannalaBrandt8 camera with the JAX package on the
CPU, on the two cameras of `config/Stereo/TUM-VI.yaml`: `project` on points
up to 1.2 rad off the optical axis within 1e-3 px, `unproject` on pixels
over the whole 512x512 image within 1e-5 (unit-length rays: near θ = π/2
the unit-z ray's x and y grow without bound), and the port's own round
trip pixel -> ray -> pixel within 1e-4 px."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_ros2_tpu.io import settings as jsettings
from orb_slam3_ros2_tpu.models import cameras as jcam
from orb_slam3_ros2_tpu_torch.io import settings as tsettings
from orb_slam3_ros2_tpu_torch.models import cameras as tcam

TUMVI = "config/Stereo/TUM-VI.yaml"
PIX_ATOL = 1e-3  # projected pixels, port vs JAX
RAY_ATOL = 1e-5  # unit rays, port vs JAX
ROUND_TRIP_ATOL = 1e-4  # px, project(unproject(uv)) - uv


@pytest.fixture(scope="module", params=["camera", "camera2"])
def cams(request):
    return (getattr(jsettings.load_settings(TUMVI), request.param),
            getattr(tsettings.load_settings(TUMVI), request.param))


def _points(seed, n=4000, max_theta=1.2):
    rng = np.random.default_rng(seed)
    th = rng.uniform(0.0, max_theta, n)
    ph = rng.uniform(-np.pi, np.pi, n)
    z = rng.uniform(0.3, 12.0, n)
    return np.stack([np.tan(th) * np.cos(ph) * z,
                     np.tan(th) * np.sin(ph) * z, z], -1).astype(np.float32)


def _unit(r):
    return r / np.linalg.norm(r, axis=-1, keepdims=True)


def test_kb8_parameters_and_model(cams):
    jc, tc = cams
    assert tc.model == tcam.CameraModel.KANNALA_BRANDT8
    assert tc.params == jc.params and (tc.width, tc.height) == (512, 512)


def test_kb8_project_matches_jax(cams):
    jc, tc = cams
    X = _points(0)
    got = tcam.project(tc, torch.from_numpy(X)).numpy()
    want = np.asarray(jcam.project(jc, jnp.asarray(X)))
    np.testing.assert_allclose(got, want, atol=PIX_ATOL)
    # the field spans most of the image
    assert (want.min(0) < 60).all() and (want.max(0) > 450).all()


def test_kb8_unproject_matches_jax(cams):
    jc, tc = cams
    uv = np.random.default_rng(1).uniform(0, 512, (4000, 2))
    uv = uv.astype(np.float32)
    got = tcam.unproject(tc, torch.from_numpy(uv)).numpy()
    want = np.asarray(jcam.unproject(jc, jnp.asarray(uv)))
    np.testing.assert_array_equal(got[:, 2], 1.0)
    np.testing.assert_allclose(_unit(got), _unit(want), atol=RAY_ATOL)


def test_kb8_round_trip(cams):
    _, tc = cams
    uv = tcam.project(tc, torch.from_numpy(_points(2)))
    back = tcam.project(tc, tcam.unproject(tc, uv))
    np.testing.assert_allclose(back.numpy(), uv.numpy(), atol=ROUND_TRIP_ATOL)
