"""Parity of the port's map state (`atlas/map_state.py`) with the JAX one on
the CPU: every function of the module on the same random map, carried
across with `from_numpy` / `to_numpy`.

`synthetic_map` (also used by `test_torch_mapping.py` and
`test_torch_ba.py`) builds a small map with real geometry: keyframes
looking at a point cloud, features at the projections (0.3 px noise),
per-point descriptors with a few flipped bits per view, landmarks for part
of the points, duplicate landmarks for SearchAndFuse to merge, and free
features to triangulate. It also returns the next keyframe's data.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_ros2_tpu.atlas import map_state as jms
from orb_slam3_ros2_tpu_torch.atlas import map_state as tms

FX = FY = 260.0
CX, CY, W, H = 160.0, 120.0, 320, 240


def _so3(phi):
    th = np.linalg.norm(phi)
    if th < 1e-12:
        return np.eye(3)
    a = phi / th
    A = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(th) * A + (1 - np.cos(th)) * A @ A


def synthetic_map(seed=0, K=8, N=120, L=400, n_kf=4, n_pts=220, n_lm=110,
                  n_dup=10):
    """(fields, new_kf): a JAX-dtype map dict and the data of keyframe
    n_kf (R, t, time, uv, level, bits, mask, obs) for a mapping step."""
    rng = np.random.default_rng(seed)
    P = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                  rng.uniform(5, 9, n_pts)], -1)
    pt_bits = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    pt_level = rng.integers(0, 3, n_pts).astype(np.int32)
    poses = []
    for k in range(n_kf + 1):
        c = np.array([0.25 * k, 0.03 * k * (-1) ** k, 0.05 * k])
        R = _so3(np.array([0.01 * k, -0.02 * k, 0.005 * k]))
        poses.append((R.astype(np.float32), (-R @ c).astype(np.float32)))

    f = dict(
        kf_R=np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)),
        kf_t=np.zeros((K, 3), np.float32), kf_valid=np.zeros(K, bool),
        kf_time=np.zeros(K, np.float32), kf_uv=np.zeros((K, N, 2), np.float32),
        kf_level=np.zeros((K, N), np.int32),
        kf_bits=np.zeros((K, N, 8), np.uint32),
        kf_feat_valid=np.zeros((K, N), bool),
        kf_obs_lm=np.full((K, N), -1, np.int32),
        lm_X=np.zeros((L, 3), np.float32), lm_valid=np.zeros(L, bool),
        lm_bits=np.zeros((L, 8), np.uint32),
        lm_ref_kf=np.zeros(L, np.int32), lm_n_obs=np.zeros(L, np.int32),
        lm_found=np.ones(L, np.int32), lm_visible=np.ones(L, np.int32),
        n_kf=np.int32(n_kf), n_lm=np.int32(n_lm + n_dup))
    # landmarks: points 0..n_lm-1, then duplicates of points 0..n_dup-1
    lm_pt = np.concatenate([np.arange(n_lm), np.arange(n_dup)])
    f["lm_X"][:n_lm + n_dup] = P[lm_pt] + rng.normal(0, 0.01, (len(lm_pt), 3))
    f["lm_valid"][:n_lm + n_dup] = True
    f["lm_bits"][:n_lm + n_dup] = pt_bits[lm_pt]
    f["lm_ref_kf"][:n_lm + n_dup] = rng.integers(0, n_kf, len(lm_pt))
    f["lm_visible"][:n_lm + n_dup] = rng.integers(1, 12, len(lm_pt))
    f["lm_found"][:n_lm + n_dup] = np.minimum(
        rng.integers(0, 10, len(lm_pt)), f["lm_visible"][:n_lm + n_dup])

    def view(k, R, t):
        xc = P @ R.T + t
        uv = np.stack([FX * xc[:, 0] / xc[:, 2] + CX,
                       FY * xc[:, 1] / xc[:, 2] + CY], -1)
        vis = np.flatnonzero((uv[:, 0] > 5) & (uv[:, 0] < W - 5)
                             & (uv[:, 1] > 5) & (uv[:, 1] < H - 5))
        pts = rng.permutation(vis)[:N - 4]
        n = len(pts)
        uvk = np.zeros((N, 2), np.float32)
        uvk[:n] = uv[pts] + rng.normal(0, 0.3, (n, 2))
        bits = np.zeros((N, 8), np.uint32)
        bits[:n] = pt_bits[pts]
        for i in range(n):  # a few flipped bits per view
            for b in rng.choice(256, rng.integers(0, 4), replace=False):
                bits[i, b // 32] ^= np.uint32(1 << (b % 32))
        level = np.zeros(N, np.int32)
        level[:n] = pt_level[pts]
        mask = np.zeros(N, bool)
        mask[:n] = True
        obs = np.full(N, -1, np.int32)
        assoc = (pts < n_lm) & (rng.random(n) < 0.7)
        obs[:n] = np.where(assoc, pts, -1)
        if k == n_kf - 1:  # this keyframe holds the duplicates instead
            dup = assoc & (pts < n_dup)
            obs[:n] = np.where(dup, n_lm + pts, obs[:n])
        return uvk, level, bits, mask, obs

    for k in range(n_kf):
        uvk, level, bits, mask, obs = view(k, *poses[k])
        f["kf_R"][k], f["kf_t"][k] = poses[k]
        f["kf_valid"][k] = True
        f["kf_time"][k] = 0.1 * k
        f["kf_uv"][k], f["kf_level"][k] = uvk, level
        f["kf_bits"][k], f["kf_feat_valid"][k] = bits, mask
        f["kf_obs_lm"][k] = obs
    has = (f["kf_obs_lm"] >= 0) & f["kf_feat_valid"]
    np.add.at(f["lm_n_obs"], f["kf_obs_lm"][has], 1)
    uvk, level, bits, mask, obs = view(n_kf, *poses[n_kf])
    # the new keyframe's pose comes from tracking: slightly off
    R_new = (_so3(rng.normal(0, 2e-3, 3)) @ poses[n_kf][0]).astype(np.float32)
    t_new = (poses[n_kf][1] + rng.normal(0, 5e-3, 3)).astype(np.float32)
    new_kf = dict(R=R_new, t=t_new, time=np.float32(0.1 * n_kf), uv=uvk,
                  level=level, bits=bits, mask=mask, obs=obs)
    return f, new_kf


def jax_map(fields):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in fields.items()})


def assert_maps_equal(mt, mj, float_atol=0.0, skip=()):
    """Every field of a port map against a JAX map: integer/bool fields
    exactly, float fields within `float_atol`."""
    got = tms.to_numpy(mt)
    for k in jms.MapState._fields:
        if k in skip:
            continue
        want = np.asarray(getattr(mj, k))
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got[k], want, atol=float_atol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want, err_msg=k)


@pytest.fixture(scope="module")
def maps():
    f, _ = synthetic_map(seed=1)
    # some features of keyframe 1 point twice at one landmark (dedupe case)
    obs = f["kf_obs_lm"][1]
    has = np.flatnonzero(obs >= 0)
    obs[has[5:9]] = obs[has[0]]
    # an invalid keyframe with stale associations, and dead landmarks
    f["kf_valid"][2] = False
    f["lm_valid"][[3, 17, 40, 41, 111]] = False
    return f, jax_map(f), tms.from_numpy(f)


def test_to_numpy_round_trip(maps):
    f, mj, mt = maps
    back = tms.to_numpy(mt)
    for k, v in f.items():
        assert back[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert_maps_equal(tms.from_numpy(back), jax_map(back))


@pytest.mark.parametrize("fn", ["recount_observations", "dedupe_observations"])
def test_observation_bookkeeping(maps, fn):
    _, mj, mt = maps
    assert_maps_equal(getattr(tms, fn)(mt), getattr(jms, fn)(mj))


def test_compact_landmarks(maps):
    _, mj, mt = maps
    m2t, rt = tms.compact_landmarks(mt)
    m2j, rj = jms.compact_landmarks(mj)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert_maps_equal(m2t, m2j)


@pytest.mark.parametrize("drop", [(1,), (0, 3), ()])
def test_compact_keyframes(maps, drop):
    _, mj, mt = maps
    keep = np.ones(mj.kf_valid.shape[0], bool)
    keep[list(drop)] = False
    m2t, rt = tms.compact_keyframes(mt, torch.from_numpy(keep))
    m2j, rj = jms.compact_keyframes(mj, jnp.asarray(keep))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert_maps_equal(m2t, m2j)


@pytest.mark.parametrize("min_obs", [2, 4])
def test_keyframe_redundancy(maps, min_obs):
    _, mj, mt = maps
    np.testing.assert_allclose(
        tms.keyframe_redundancy(mt, min_obs).numpy(),
        np.asarray(jms.keyframe_redundancy(mj, min_obs)), atol=1e-7)


def test_observation_and_covisibility_matrices(maps):
    _, mj, mt = maps
    O = tms.observation_matrix(mt)
    assert O.dtype == torch.float32
    np.testing.assert_array_equal(
        O.numpy(), np.asarray(jms.observation_matrix(mj), np.float32))
    C = tms.covisibility_matrix(mt)
    np.testing.assert_array_equal(C.numpy(),
                                  np.asarray(jms.covisibility_matrix(mj)))
    assert int(C.max()) > 10 and C.dtype == torch.int32


@pytest.mark.parametrize("ids", [[0, 1, 3, 0], [3, 1, 1, 2, 0, 0]])
def test_observation_table(maps, ids):
    """Keyframe 1 holds duplicate features of one landmark; the JAX table's
    duplicate write is XLA's choice, so the dedupe-d map is compared."""
    f, _, _ = maps
    m = jms.dedupe_observations(jax_map(f))
    mt = tms.from_numpy({k: np.asarray(v) for k, v in m._asdict().items()})
    idx = np.asarray(ids, np.int32)
    uv_t, w_t, ok_t = tms.observation_table(mt, torch.from_numpy(idx))
    uv_j, w_j, ok_j = jms.observation_table(m, jnp.asarray(idx))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))


def test_insert_and_add_with_device_ids(maps):
    """insert_keyframe + add_landmarks with keyframe ids given as 0-dim
    tensors (the mapping step's form) match the JAX functions."""
    f, mj, mt = maps
    _, new = synthetic_map(seed=1)
    args_j = [jnp.asarray(new[k]) for k in ("R", "t", "time", "uv", "level",
                                            "bits", "mask", "obs")]
    args_t = [torch.from_numpy(np.asarray(new[k]).view(np.int32)
                               if k == "bits" else np.asarray(new[k]))
              for k in ("R", "t", "time", "uv", "level", "bits", "mask",
                        "obs")]
    m1j = jms.insert_keyframe(mj, *args_j)
    m1t = tms.insert_keyframe(mt, *args_t)
    assert_maps_equal(m1t, m1j)
    N = f["kf_uv"].shape[1]
    rng = np.random.default_rng(5)
    X = rng.normal(size=(N, 3)).astype(np.float32)
    acc = rng.random(N) > 0.5
    fa = np.arange(N, dtype=np.int32)
    fb = rng.permutation(N).astype(np.int32)
    m2j = jms.add_landmarks(m1j, jnp.asarray(X), jnp.asarray(new["bits"]),
                            jnp.asarray(acc), 4, 4, jnp.asarray(fa), 3,
                            jnp.asarray(fb))
    k4, k3 = torch.tensor(4, dtype=torch.int32), torch.tensor(3)
    m2t = tms.add_landmarks(m1t, torch.from_numpy(X), args_t[5],
                            torch.from_numpy(acc), k4, k4,
                            torch.from_numpy(fa), k3, torch.from_numpy(fb))
    assert_maps_equal(m2t, m2j)


def test_scatter_last_keeps_the_last_duplicate():
    """Duplicate indices: the last write wins, as XLA's CPU scatter does."""
    idx = np.array([2, 0, 2, 5, 1, 2], np.int64)  # 5 = dropped sentinel
    val = np.array([10, 11, 12, 13, 14, 15], np.int32)
    want = np.asarray(jnp.arange(5, dtype=jnp.int32).at[idx].set(
        val, mode="drop"))
    got = tms.scatter_last(torch.arange(5, dtype=torch.int32),
                           torch.from_numpy(idx), torch.from_numpy(val))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [11, 14, 15, 3, 4]
