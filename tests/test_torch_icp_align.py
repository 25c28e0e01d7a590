"""Parity of the port's map-to-map ICP (`atlas/icp_align.py`) with the JAX
module on the CPU: normals, one ICP solve and `align_maps` on the same
clouds, plus the three bars of tests/test_icp_align.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from orb_slam3_ros2_tpu.atlas import icp_align as jicp
from orb_slam3_ros2_tpu_torch.atlas import icp_align as ticp
from tests.test_icp_align import _room_cloud
from tests.test_torch_sharded_ba import two_threads  # noqa: F401

NORMAL_ATOL = 1e-4  # |n_port - n_jax| per component (both unit, same sign)
# the ICP transform and stats, port vs JAX: the trimmed weights threshold
# each match at a distance quantile, and a point at the threshold falls on
# either side when the f32 sums run in another order; over 40 iterations
# that moved the result by up to 3.4e-4 rad / 2.4e-4 m / rms 3.1e-4 on
# three seeds, a tenth of tests/test_icp_align.py's bars
ROT_RAD, T_M, STAT_ATOL = 1e-3, 1e-3, 1e-3


def _moved_clouds(seed=3):
    """tests/test_icp_align.py's known-transform case."""
    rng = np.random.default_rng(seed)
    dst = _room_cloud(rng)
    R_gt = Rotation.from_euler("zyx", [12.0, -6.0, 4.0],
                               degrees=True).as_matrix()
    t_gt = np.array([0.4, -0.3, 0.2])
    src_full = (dst - t_gt) @ R_gt
    src = src_full[rng.random(len(src_full)) < 0.7]
    dst = dst[rng.random(len(dst)) < 0.7]
    src = src + rng.normal(0, 0.005, src.shape)
    return src, dst, R_gt, t_gt


def test_normals_match_jax_on_room_cloud():
    rng = np.random.default_rng(0)
    pts, mask = ticp._fixed_subsample(_room_cloud(rng, n=1200), 1024, 1)
    jn = np.asarray(jicp.estimate_normals(jnp.asarray(pts),
                                          jnp.asarray(mask), knn=5))
    tn = ticp.estimate_normals(torch.from_numpy(pts),
                               torch.from_numpy(mask), knn=5).numpy()
    np.testing.assert_allclose(tn, jn, atol=NORMAL_ATOL)


def test_normals_on_plane():
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-1, 1, 256), rng.uniform(-1, 1, 256),
                    np.zeros(256)], -1).astype(np.float32)
    n = ticp.estimate_normals(torch.from_numpy(pts),
                              torch.ones(256, dtype=torch.bool), knn=5).numpy()
    assert np.all(np.abs(n[:, 2]) > 0.99)
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-5)


def test_icp_recovers_known_transform_as_jax():
    src, dst, R_gt, t_gt = _moved_clouds()
    T, stats = ticp.align_maps(src, dst, iters=40, device="cpu")
    Tj, statsj = jicp.align_maps(src, dst, iters=40)
    assert Rotation.from_matrix(T[:3, :3] @ Tj[:3, :3].T).magnitude() < \
        ROT_RAD
    assert np.abs(T[:3, 3] - Tj[:3, 3]).max() < T_M
    for k in ("rms", "inlier_frac"):
        assert abs(stats[k] - statsj[k]) < STAT_ATOL, (k, stats, statsj)
    rot_err = Rotation.from_matrix(T[:3, :3] @ R_gt.T).magnitude()
    assert rot_err < 0.01, rot_err
    assert np.linalg.norm(T[:3, 3] - t_gt) < 0.02
    assert stats["rms"] < 0.02
    assert stats["inlier_frac"] > 0.9


def test_icp_identity_on_same_cloud():
    rng = np.random.default_rng(5)
    pts = _room_cloud(rng, n=1200)
    T, stats = ticp.align_maps(pts, pts, iters=15, device="cpu")
    assert np.linalg.norm(T[:3, 3]) < 5e-3
    assert Rotation.from_matrix(T[:3, :3]).magnitude() < 5e-3
    assert stats["rms"] < 5e-3


def test_subsample_draws_the_jax_points():
    pts = _room_cloud(np.random.default_rng(1), n=900).astype(np.float32)
    for n, seed in ((512, 0), (2048, 1)):
        a, ma = ticp._fixed_subsample(pts, n, seed)
        b, mb = jicp._fixed_subsample(pts, n, seed)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ma, mb)


def test_align_maps_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((8, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ticp.align_maps(pts, pts)
