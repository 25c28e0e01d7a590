"""The port's copy of the keyframe partitioner (`parallel/partition.py`)
against the JAX module: the six cases of tests/test_partition.py, each
with the JAX test's bar and the two modules' outputs equal exactly."""

import jax.numpy as jnp
import numpy as np
import torch

from orb_slam3_ros2_tpu.atlas import map_state as jms
from orb_slam3_ros2_tpu.io import synthetic
from orb_slam3_ros2_tpu.parallel import partition as jpart
from orb_slam3_ros2_tpu_torch.atlas import map_state as tms
from orb_slam3_ros2_tpu_torch.parallel import partition as tpart
from tests.test_partition import _planted_covis
from tests.test_torch_sharded_ba import two_threads  # noqa: F401


def test_partition_recovers_planted_regions():
    W, region = _planted_covis()
    assign = tpart.partition_keyframes(W, 2)
    np.testing.assert_array_equal(assign, jpart.partition_keyframes(W, 2))
    for s in (0, 1):
        members = region[assign == s]
        purity = max((members == 0).mean(), (members == 1).mean())
        assert purity >= 0.9, f"shard {s} purity {purity}"
    sizes = np.bincount(assign, minlength=2)
    assert sizes.max() - sizes.min() <= 2


def test_partition_beats_contiguous_and_round_robin():
    W, _ = _planted_covis()
    K = W.shape[0]
    assign = tpart.partition_keyframes(W, 2)
    ours = tpart.cut_fraction(W, assign)
    assert ours == jpart.cut_fraction(W, assign)
    contiguous = tpart.cut_fraction(W, (np.arange(K) >= K // 2).astype(
        np.int32))
    rr = tpart.cut_fraction(W, (np.arange(K) % 2).astype(np.int32))
    assert ours < 0.5 * contiguous, (ours, contiguous)
    assert ours < 0.5 * rr, (ours, rr)


def test_partition_four_shards_balanced():
    W, _ = _planted_covis(seed=3)
    assign = tpart.partition_keyframes(W, 4)
    np.testing.assert_array_equal(assign, jpart.partition_keyframes(W, 4))
    sizes = np.bincount(assign, minlength=4)
    assert sizes.min() >= 1
    assert sizes.max() <= int(np.ceil(64 / 4)) + 1
    assert tpart.cut_fraction(W, assign) <= tpart.cut_fraction(
        W, (np.arange(64) % 4).astype(np.int32))


def test_shard_indices_shapes_and_padding():
    assign = np.array([0, 1, 0, 1, 1, 2], np.int32)
    idx, valid = tpart.shard_indices(assign, 3)
    jidx, jvalid = jpart.shard_indices(assign, 3)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(valid, jvalid)
    assert idx.shape == valid.shape == (3, 3)
    assert valid.sum() == 6
    np.testing.assert_array_equal(np.sort(idx[valid]), np.arange(6))
    assert idx[2, 1] == idx[2, 0]


def test_boundary_keyframes():
    W = np.zeros((4, 4))
    W[0, 1] = W[1, 0] = 5.0
    W[1, 2] = W[2, 1] = 3.0
    assign = np.array([0, 0, 1, 1], np.int32)
    b = tpart.boundary_keyframes(W, assign)
    np.testing.assert_array_equal(b, jpart.boundary_keyframes(W, assign))
    np.testing.assert_array_equal(b, [False, True, True, False])


def test_partition_on_real_covisibility():
    """The port's covisibility of tests/test_partition.py's map equals
    JAX's, and partitions the same way, no worse than round-robin."""
    sc = synthetic.make_scene(n_frames=12, n_points=200, seed=2)
    cfg = jms.MapConfig(max_kf=16, max_lm=256, n_feat=256)
    m = jms.empty_map(cfg)
    obs = np.full((16, 256), -1, np.int32)
    for k in range(12):
        vis = np.where(sc.vis[k])[0][:256]
        obs[k, : len(vis)] = vis
    m = m._replace(
        kf_obs_lm=m.kf_obs_lm.at[:, : obs.shape[1]].set(jnp.asarray(obs)),
        kf_feat_valid=jnp.asarray(obs >= 0),
        kf_valid=m.kf_valid.at[:12].set(True),
        lm_valid=m.lm_valid.at[:200].set(True),
        n_kf=jnp.asarray(12, m.n_kf.dtype),
    )
    tm = tms.from_numpy({k: np.asarray(v) for k, v in m._asdict().items()})
    covis = tms.covisibility_matrix(tm).numpy()[:12, :12]
    np.testing.assert_array_equal(
        covis, np.asarray(jms.covisibility_matrix(m))[:12, :12])
    assert covis.max() > 0
    assign = tpart.partition_keyframes(covis, 2)
    np.testing.assert_array_equal(assign, jpart.partition_keyframes(covis, 2))
    assert tpart.cut_fraction(covis, assign) <= tpart.cut_fraction(
        covis, (np.arange(12) % 2).astype(np.int32)) + 1e-9
    assert isinstance(tms.covisibility_matrix(tm), torch.Tensor)
