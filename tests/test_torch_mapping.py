"""Parity of the port's keyframe mapping (the mapping half of
`frontend/tracking.py` and `runtime/system.mapping_step`) with the JAX
package on the CPU, on the same JAX-built map (`synthetic_map`)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_ros2_tpu.atlas import map_state as jms
from orb_slam3_ros2_tpu.frontend import tracking as jtrk
from orb_slam3_ros2_tpu_torch.atlas import map_state as tms
from orb_slam3_ros2_tpu_torch.frontend import tracking as ttrk
from orb_slam3_ros2_tpu_torch.runtime import system as tsys
from tests.test_torch_map_state import (CX, CY, FX, FY, H, W,
                                        assert_maps_equal, jax_map,
                                        synthetic_map)

X_ATOL = 1e-4  # triangulated points (world units ~5-9 m), port vs JAX
POSE_ATOL = 1e-4  # keyframe pose after a mapping step
POINT_ATOL = 1e-3  # landmark positions after local BA


@pytest.fixture(scope="module")
def maps():
    f, new = synthetic_map(seed=3)
    return f, new, jax_map(f), tms.from_numpy(f)


@pytest.mark.parametrize("pair", [(3, 2), (3, 1), (2, 0)])
@pytest.mark.parametrize("strict", [False, True])
def test_triangulate_between(maps, pair, strict):
    """Default gates and the strict second-partner variant (reproj_th=1.0,
    max_dist=35): equal accept masks and partner features, points within
    1e-4 where accepted."""
    _, _, mj, mt = maps
    kw = dict(reproj_th=1.0, max_dist=35.0) if strict else {}
    a, b = pair
    Xj, bj, accj, faj, fbj = jtrk.triangulate_between(
        mj, jnp.int32(a), jnp.int32(b), FX, FY, CX, CY, **kw)
    Xt, bt, acct, fat, fbt = ttrk.triangulate_between(
        mt, torch.tensor(a), torch.tensor(b), FX, FY, CX, CY, **kw)
    acc = np.asarray(accj)
    np.testing.assert_array_equal(acct.numpy(), acc)
    assert acc.sum() > 5
    np.testing.assert_array_equal(fbt.numpy(), np.asarray(fbj))
    np.testing.assert_array_equal(fat.numpy(), np.asarray(faj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj).view(np.int32))
    np.testing.assert_allclose(Xt.numpy()[acc], np.asarray(Xj)[acc],
                               atol=X_ATOL)


def test_triangulate_refuses_a_low_baseline_pair(maps):
    """The baseline / median-depth gate: a keyframe against a copy of itself
    moved by 1 cm (0.2% of the ~6 m scene depth) accepts nothing."""
    f, _, _, _ = maps
    g = {k: v.copy() for k, v in f.items()}
    g["kf_R"][4] = g["kf_R"][3]
    g["kf_t"][4] = g["kf_t"][3] + np.array([0.01, 0, 0], np.float32)
    for k in ("kf_uv", "kf_level", "kf_bits", "kf_feat_valid", "kf_obs_lm"):
        g[k][4] = g[k][3]
    g["kf_valid"][4] = True
    g["n_kf"] = np.int32(5)
    args = (FX, FY, CX, CY)
    accj = jtrk.triangulate_between(jax_map(g), jnp.int32(4), jnp.int32(3),
                                    *args)[2]
    acct = ttrk.triangulate_between(tms.from_numpy(g), torch.tensor(4),
                                    torch.tensor(3), *args)[2]
    assert not np.asarray(accj).any() and not acct.any()


def _covis_map(weights):
    """A map whose keyframe 0 shares weights[k] landmarks with keyframe k
    (and keyframe k shares one with k+1, for a second ring)."""
    K, N, L = len(weights) + 3, 64, 256
    f, _ = synthetic_map(seed=0, K=K, N=N, L=L, n_kf=2, n_pts=120, n_lm=60,
                         n_dup=0)
    f["kf_obs_lm"][:] = -1
    f["kf_valid"][:] = False
    f["kf_feat_valid"][:] = True
    f["lm_valid"][:] = True
    nxt = 0
    for k, w in enumerate(weights, start=1):
        ids = np.arange(nxt, nxt + w)
        nxt += w
        f["kf_obs_lm"][0, ids] = ids
        f["kf_obs_lm"][k, :w] = ids
        f["kf_valid"][[0, k]] = True
    for k in range(1, len(weights)):
        f["kf_obs_lm"][k, N - 1] = 200 + k
        f["kf_obs_lm"][k + 1, N - 2] = 200 + k
    f["n_kf"] = np.int32(len(weights) + 1)
    return f


@pytest.mark.parametrize("weights", [
    [3, 5, 5, 2, 5, 3, 1, 4, 5, 2], [2] * 12, [4, 0, 4, 1, 4, 0, 4]])
@pytest.mark.parametrize("anchor", [0, 2])
def test_select_local_window_tie_order(weights, anchor):
    """Tied covisibility weights: the lowest keyframe id first, as
    `lax.top_k` orders them (window ids and fixed flags equal)."""
    f = _covis_map(weights)
    ids_j, fix_j = jtrk.select_local_window(jax_map(f), jnp.int32(anchor),
                                            n_window=8, n_fixed_ring=4)
    ids_t, fix_t = ttrk.select_local_window(tms.from_numpy(f),
                                            torch.tensor(anchor),
                                            n_window=8, n_fixed_ring=4)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(fix_t.numpy(), np.asarray(fix_j))


@pytest.mark.parametrize("kf,exclude", [(0, [0]), (0, [0, 2]), (3, [3, 2]),
                                        (5, [5, 4])])
def test_best_covisible(kf, exclude):
    f = _covis_map([3, 5, 5, 2, 5, 3])
    got = ttrk.best_covisible(tms.from_numpy(f), torch.tensor(kf),
                              torch.tensor(exclude))
    want = jtrk.best_covisible(jax_map(f), jnp.int32(kf),
                               jnp.asarray(exclude, jnp.int32))
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(want)


@pytest.mark.parametrize("kf", [3, 2])
def test_fuse_map_points(maps, kf):
    """SearchAndFuse on keyframe 3 (whose features hold the duplicate
    landmarks, so it merges) and keyframe 2 (adoptions only): equal maps
    and counts."""
    _, _, mj, mt = maps
    m2j, adj, mgj = jtrk.fuse_map_points(mj, jnp.int32(kf), FX, FY, CX, CY,
                                         W, H)
    m2t, adt, mgt = ttrk.fuse_map_points(mt, torch.tensor(kf), FX, FY, CX,
                                         CY, W, H)
    assert int(adt) == int(adj) and int(mgt) == int(mgj)
    assert int(adt) > 0
    if kf == 3:
        assert int(mgt) > 0
    assert_maps_equal(m2t, m2j)


def test_cull_landmarks(maps):
    _, _, mj, mt = maps
    got = ttrk.cull_landmarks(mt)
    want = jtrk.cull_landmarks(mj)
    assert_maps_equal(got, want)
    assert int(got.lm_valid.sum()) < int(mt.lm_valid.sum())


@pytest.fixture(scope="module")
def jax_system(tmp_path_factory):
    """A JAX System whose jitted `mapping_step` is the reference."""
    from orb_slam3_ros2_tpu.runtime.system import System

    path = tmp_path_factory.mktemp("cfg") / "cam.yaml"
    path.write_text(
        "%YAML:1.0\nCamera.type: \"Rectified\"\n"
        f"Camera1.fx: {FX}\nCamera1.fy: {FY}\nCamera1.cx: {CX}\n"
        f"Camera1.cy: {CY}\nCamera.width: {W}\nCamera.height: {H}\n"
        "Camera.fps: 10\nORBextractor.nFeatures: 120\n"
        "ORBextractor.nLevels: 1\nloopClosing: 0\n")
    return System(None, str(path), map_cfg=jms.MapConfig(max_kf=8, max_lm=400,
                                                         n_feat=120))


def test_mapping_step_matches_jax(maps, jax_system):
    """One whole keyframe insertion from the same JAX-built map: equal
    n_kf / n_lm and associations, the new keyframe's pose within 1e-4, the
    landmarks within 1e-3."""
    _, new, mj, mt = maps
    keys = ("R", "t", "time", "uv", "level", "bits", "mask", "obs")
    m2j, sj = jax_system._mapping_step(mj, *(jnp.asarray(new[k])
                                             for k in keys))
    args = [torch.from_numpy(np.asarray(new[k]).view(np.int32)
                             if k == "bits" else np.asarray(new[k]))
            for k in keys]
    m2t, st = tsys.mapping_step(mt, *args[:2], float(new["time"]), *args[3:],
                                FX, FY, CX, CY, W, H, n_window=8,
                                n_fixed_ring=4)
    sj, st = np.asarray(sj), st.numpy()
    assert st.shape == (14,)
    assert st[12] == sj[12] == 5 and st[13] == sj[13]
    assert int(m2t.n_lm) > int(mt.n_lm)  # the step triangulated
    np.testing.assert_allclose(st[:12], sj[:12], atol=POSE_ATOL)
    for name, tol in (("kf_R", POSE_ATOL), ("kf_t", POSE_ATOL),
                      ("lm_X", POINT_ATOL)):
        np.testing.assert_allclose(getattr(m2t, name).numpy(),
                                   np.asarray(getattr(m2j, name)), atol=tol,
                                   err_msg=name)
    assert_maps_equal(m2t, m2j, skip=("kf_R", "kf_t", "lm_X"))
