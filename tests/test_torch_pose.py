"""Parity of the port's pose-only LM with the JAX package on the CPU (the
bounds of tests/test_fused_kernels.py:100-116: R atol 5e-5, t atol 5e-4,
identical inlier sets), and of the pose CUDA kernel with its plain version
on a GPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_ros2_tpu.backend import pose_opt as jpo
from orb_slam3_ros2_tpu.backend import pose_opt_fused as jpof
from orb_slam3_ros2_tpu.geom import lie as jlie
from orb_slam3_ros2_tpu_torch.backend import pose_opt as tpo
from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused as tpof


def _pose_case(seed=1, N=300, outlier_frac=0.3):
    """tests/test_fused_kernels.py's case, as numpy arrays."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N),
                  rng.uniform(4, 10, N)], -1).astype(np.float32)
    fx = fy = 400.0
    cx, cy = 320.0, 240.0
    R_true = np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.1, 0.02])))
    t_true = np.array([0.1, -0.05, 0.2], np.float32)
    xc = X @ R_true.T + t_true
    uv = np.stack([fx * xc[:, 0] / xc[:, 2] + cx,
                   fy * xc[:, 1] / xc[:, 2] + cy], -1).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    out = rng.random(N) < outlier_frac
    uv[out] += rng.uniform(-80, 80, (out.sum(), 2)).astype(np.float32)
    mask = rng.random(N) > 0.05
    invs2 = (1.2 ** (-2.0 * rng.integers(0, 8, N))).astype(np.float32)
    return (X, uv, invs2, mask, (fx, fy, cx, cy), R_true, t_true)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("seed,N,frac", [(1, 300, 0.3), (2, 1000, 0.3),
                                         (3, 120, 0.0)])
def test_pose_opt_matches_jax(seed, N, frac):
    X, uv, invs2, mask, K, R_true, t_true = _pose_case(seed, N, frac)
    ref = jpo.optimize_pose(jnp.eye(3), jnp.zeros(3), jnp.asarray(X),
                            jnp.asarray(uv), jnp.asarray(invs2),
                            jnp.asarray(mask), *K)
    refs = [ref]
    if seed == 1:  # the Pallas kernel in interpret mode (slow on a CPU)
        refs.append(jpof.optimize_pose_fused(
            jnp.eye(3), jnp.zeros(3), jnp.asarray(X), jnp.asarray(uv),
            jnp.asarray(invs2), jnp.asarray(mask), *K, interpret=True))
    got = tpof.optimize_pose_fused(torch.eye(3), torch.zeros(3),
                                   torch.from_numpy(X), torch.from_numpy(uv),
                                   torch.from_numpy(invs2),
                                   torch.from_numpy(mask), *K)
    assert np.abs(got.R.numpy() - R_true).max() < 2e-3
    assert np.abs(got.t.numpy() - t_true).max() < 1e-2
    for r in refs:
        np.testing.assert_allclose(got.R.numpy(), np.asarray(r.R), atol=5e-5)
        np.testing.assert_allclose(got.t.numpy(), np.asarray(r.t), atol=5e-4)
        assert int(got.n_inliers) == int(r.n_inliers)
        np.testing.assert_array_equal(got.inliers.numpy(),
                                      np.asarray(r.inliers))
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-3)


def test_pose_opt_from_perturbed_start():
    """6° / 0.3 m initial error, as the JAX docstring's budget claim."""
    X, uv, invs2, mask, K, R_true, t_true = _pose_case(4, 400, 0.2)
    R0 = (np.asarray(jlie.so3_exp(jnp.asarray([0.1, 0.0, 0.0]))) @ R_true
          ).astype(np.float32)
    t0 = (t_true + np.array([0.3, 0.0, 0.0])).astype(np.float32)
    ref = jpo.optimize_pose(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X),
                            jnp.asarray(uv), jnp.asarray(invs2),
                            jnp.asarray(mask), *K)
    got = tpo.optimize_pose(torch.from_numpy(R0), torch.from_numpy(t0),
                            torch.from_numpy(X), torch.from_numpy(uv),
                            torch.from_numpy(invs2), torch.from_numpy(mask),
                            *K)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=5e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=5e-4)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))


@pytest.mark.cuda
def test_pose_kernel_matches_plain_on_gpu(cuda_device):
    X, uv, invs2, mask, K, R_true, t_true = _pose_case(2, 1000, 0.3)
    args = [torch.eye(3), torch.zeros(3), torch.from_numpy(X),
            torch.from_numpy(uv), torch.from_numpy(invs2),
            torch.from_numpy(mask)]
    args = [a.to(cuda_device) for a in args]
    n = tpof.optimize_pose_fused.launches
    got = tpof.optimize_pose_fused(*args, *K)
    ref = tpo.optimize_pose(*args, *K)
    assert tpof.optimize_pose_fused.launches == n + 1
    np.testing.assert_allclose(got.R.cpu().numpy(), ref.R.cpu().numpy(),
                               atol=5e-5)
    np.testing.assert_allclose(got.t.cpu().numpy(), ref.t.cpu().numpy(),
                               atol=5e-4)
    np.testing.assert_array_equal(got.inliers.cpu().numpy(),
                                  ref.inliers.cpu().numpy())


def test_pose_wrapper_raises_off_cpu_without_a_kernel():
    """A non-CPU, non-CUDA tensor is refused, never optimized by the plain
    version."""
    meta = dict(device="meta")
    n = tpof.optimize_pose_fused.launches
    with pytest.raises(ValueError, match="CUDA"):
        tpof.optimize_pose_fused(
            torch.eye(3, **meta), torch.zeros(3, **meta),
            torch.zeros((10, 3), **meta), torch.zeros((10, 2), **meta),
            torch.ones(10, **meta), torch.ones(10, dtype=torch.bool, **meta),
            400.0, 400.0, 320.0, 240.0)
    assert tpof.optimize_pose_fused.launches == n
