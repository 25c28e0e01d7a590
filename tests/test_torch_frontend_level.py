"""Parity of the port's per-level frontend ops (`ops/frontend_level.py`) with
the JAX Pallas kernels in interpret mode on the CPU, at the JAX oracle tests'
size and tolerances (`tests/test_pallas_kernels.py`), and of the CUDA kernel
with its plain version on a GPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_ros2_tpu.ops import orb_descriptor as jdesc
from orb_slam3_ros2_tpu.ops import pallas_kernels as pk
from orb_slam3_ros2_tpu_torch.ops import frontend_level as tfl
from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as tdesc

# interiors: score/keep/blur agree >= 4 px from the border (zero vs reflect
# padding), the moment maps >= 16 px (disc radius 15 + 1)
B, BM = 4, 16
TOL = dict(score=dict(atol=1e-4), blur=dict(rtol=1e-5, atol=1e-3),
           moments=dict(rtol=2e-4, atol=2.0))


def _img(h=96, w=160, seed=0):
    """The JAX oracle tests' image: boxes plus noise."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for _ in range(25):
        y, x = rng.integers(5, h - 15), rng.integers(5, w - 15)
        bh, bw = rng.integers(4, 12, size=2)
        img[y:y + bh, x:x + bw] = rng.uniform(30, 250)
    img += rng.normal(0, 1.5, size=img.shape)
    return np.clip(img, 0, 255).astype(np.float32)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _interior(a, b):
    return a[b:-b, b:-b]


def _check_score_keep(score, keep, score_ref, keep_ref):
    np.testing.assert_allclose(_interior(_np(score), B),
                               _interior(_np(score_ref), B), **TOL["score"])
    np.testing.assert_array_equal(_interior(_np(keep), B),
                                  _interior(_np(keep_ref), B))


def _check_blur(blur, blur_ref):
    np.testing.assert_allclose(_interior(_np(blur), B),
                               _interior(_np(blur_ref), B), **TOL["blur"])


def _check_moments(m01, m10, m01_ref, m10_ref):
    for a, b in ((m01, m01_ref), (m10, m10_ref)):
        np.testing.assert_allclose(_interior(_np(a), BM), _interior(_np(b), BM),
                                   **TOL["moments"])


@pytest.mark.parametrize("seed", [0, 3])
def test_fast_nms_matches_pallas(seed):
    img = _img(seed=seed)
    score, keep = tfl.fast_nms(torch.from_numpy(img))
    s_j, k_j = pk.fast_nms(jnp.asarray(img), interpret=True)
    _check_score_keep(score, keep, s_j, k_j)
    assert keep.dtype == torch.bool and int(keep.sum()) > 10


@pytest.mark.parametrize("seed", [1, 4])
def test_blur7_matches_pallas(seed):
    img = _img(seed=seed)
    _check_blur(tfl.blur7(torch.from_numpy(img)),
                pk.blur7(jnp.asarray(img), interpret=True))


@pytest.mark.parametrize("seed", [3, 5])
def test_frontend_pass_matches_pallas(seed):
    img = _img(seed=seed)
    score, keep, m01, m10, blur = tfl.frontend_pass(torch.from_numpy(img))
    s_j, k_j, m01_j, m10_j, b_j = pk.frontend_pass(jnp.asarray(img),
                                                   interpret=True)
    _check_score_keep(score, keep, s_j, k_j)
    _check_moments(m01, m10, m01_j, m10_j)
    _check_blur(blur, b_j)


def test_frontend_pass_lite_matches_pallas():
    img = _img(seed=6)
    score, keep, blur = tfl.frontend_pass_lite(torch.from_numpy(img))
    s_j, k_j, b_j = pk.frontend_pass_lite(jnp.asarray(img), interpret=True)
    _check_score_keep(score, keep, s_j, k_j)
    _check_blur(blur, b_j)


@pytest.mark.parametrize("shape", [(96, 160), (61, 97)])
def test_moment_maps_match_jax(shape):
    """The float64 plain moment maps against the JAX float32 ones (both
    exact on the interior up to rounding), and against the disc moments of
    gathered patches."""
    img = _img(*shape, seed=7)
    m01, m10 = tdesc.moment_maps(torch.from_numpy(img))
    m01_j, m10_j = jdesc.moment_maps(jnp.asarray(img))
    assert m01.dtype == torch.float32 and m01.shape == shape
    _check_moments(m01, m10, m01_j, m10_j)
    # exact disc moments at a few interior pixels, in float64
    w = tdesc._orientation_weights().astype(np.float64)
    for (y, x) in ((BM, BM), (shape[0] // 2, shape[1] // 2),
                   (shape[0] - BM - 1, shape[1] - BM - 1)):
        patch = img[y - 15:y + 16, x - 15:x + 16].astype(np.float64).ravel()
        want = patch @ w
        np.testing.assert_allclose([m01[y, x].item(), m10[y, x].item()],
                                   want, rtol=1e-6, atol=1e-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(96, 160), (480, 752), (139, 218)])
def test_kernels_match_plain_on_gpu(cuda_device, shape):
    img = torch.from_numpy(_img(*shape, seed=2)).to(cuda_device)
    n0 = [f.launches for f in (tfl.fast_nms, tfl.blur7, tfl.frontend_pass,
                               tfl.frontend_pass_lite)]
    _check_score_keep(*tfl.fast_nms(img), *tfl.fast_nms_ref(img))
    _check_blur(tfl.blur7(img), tfl.blur7_ref(img))
    got = tfl.frontend_pass(img)
    ref = tfl.frontend_pass_ref(img)
    _check_score_keep(got[0], got[1], ref[0], ref[1])
    _check_moments(got[2], got[3], ref[2], ref[3])
    _check_blur(got[4], ref[4])
    got = tfl.frontend_pass_lite(img)
    ref = tfl.frontend_pass_lite_ref(img)
    _check_score_keep(got[0], got[1], ref[0], ref[1])
    _check_blur(got[2], ref[2])
    n1 = [f.launches for f in (tfl.fast_nms, tfl.blur7, tfl.frontend_pass,
                               tfl.frontend_pass_lite)]
    assert [b - a for a, b in zip(n0, n1)] == [1, 1, 1, 1]
