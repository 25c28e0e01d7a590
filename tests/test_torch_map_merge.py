"""Map merging in the port (`atlas/merging.py`) against the JAX module, and
port copies of `tests/test_map_merge.py` and `tests/test_weld_refine.py`.

Tolerances: `merge_maps` is numpy in both packages: every leaf of the
merged map exact, except the transported landmark and keyframe
translations (within 1e-5: the port rounds the Sim3 to f32 before
applying it, as the JAX version does, but sums in another order); the
cross-map Sim3 on JAX's RANSAC samples: R, t, s within 1e-4 and the same
duplicate pairs; `refine_weld_pnp`: R within 1e-4, t within 1e-3, s
within 1e-4 and the same pairs."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.atlas import map_state as jms
from orb_slam3_ros2_tpu.atlas import merging as jmerging
from orb_slam3_ros2_tpu.geom import lie as jlie
from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
from orb_slam3_ros2_tpu_torch.atlas import merging
from orb_slam3_ros2_tpu_torch.io import synthetic
from orb_slam3_ros2_tpu_torch.runtime.system import (Sensor, System,
                                                     TrackingState)
from tests.test_torch_loop_closing import jax_samples

SETTINGS = os.path.join(os.path.dirname(__file__), "data", "synth_cam.yaml")
FX = FY = 300.0
CX, CY = 160.0, 120.0


def _jax_map(A):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in A.items()})


def _port_map(A):
    return ms.from_numpy(A)


def _mini_map(cfg, n_kf, n_lm, seed):
    r = np.random.default_rng(seed)
    A = ms.to_numpy(ms.empty_map(cfg))
    A = {k: np.array(v) for k, v in A.items()}
    for k in range(n_kf):
        A["kf_R"][k] = np.eye(3)
        A["kf_t"][k] = r.normal(0, 1, 3)
        A["kf_valid"][k] = True
        A["kf_time"][k] = float(k)
        A["kf_feat_valid"][k, :8] = True
        A["kf_obs_lm"][k, :8] = r.integers(0, n_lm, 8)
    for j in range(n_lm):
        A["lm_X"][j] = r.normal(0, 2, 3)
        A["lm_valid"][j] = True
        A["lm_n_obs"][j] = r.integers(2, 9)
        A["lm_ref_kf"][j] = r.integers(0, n_kf)
    A["n_kf"] = np.asarray(n_kf, np.int32)
    A["n_lm"] = np.asarray(n_lm, np.int32)
    return A


SIM3 = (np.array([[np.cos(0.3), -np.sin(0.3), 0],
                  [np.sin(0.3), np.cos(0.3), 0], [0, 0, 1]], np.float32),
        np.array([1.0, -2.0, 0.5], np.float32), 1.5)


@pytest.mark.parametrize("cap_kf,cap_lm,alias", [(16, 256, False),
                                                 (8, 70, False),
                                                 (16, 256, True)])
def test_merge_maps_matches_jax(cap_kf, cap_lm, alias):
    """Room for all, keyframe and landmark capacity overflow, aliases."""
    cfg = ms.MapConfig(max_kf=cap_kf, max_lm=cap_lm, n_feat=32)
    A, O = _mini_map(cfg, 5, 40, 1), _mini_map(cfg, 6, 50, 2)
    lm_alias = None
    if alias:
        lm_alias = np.full(cap_lm, -1, np.int32)
        lm_alias[[3, 7, 11]] = [20, 5, 5]
    got, kept, off = merging.merge_maps(_port_map(A), _port_map(O), *SIM3,
                                        cfg, lm_alias=lm_alias)
    ref, kept_j, off_j = jmerging.merge_maps(_jax_map(A), _jax_map(O), *SIM3,
                                             cfg, lm_alias=lm_alias)
    np.testing.assert_array_equal(kept, kept_j)
    assert off == off_j
    got = ms.to_numpy(got)
    for name in ms.MapState._fields:
        want = np.asarray(getattr(ref, name))
        if name in ("lm_X", "kf_t"):
            np.testing.assert_allclose(got[name], want, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_merge_maps_transform_and_capacity():
    """The port copy of `tests/test_map_merge.py`'s merge case."""
    cfg = ms.MapConfig(max_kf=16, max_lm=256, n_feat=32)
    A, O = _mini_map(cfg, 5, 40, 1), _mini_map(cfg, 6, 50, 2)
    R, t, s = SIM3
    merged, kept, off = merging.merge_maps(_port_map(A), _port_map(O), R, t,
                                           s, cfg)
    assert int(merged.n_kf) == 11 and off == 5 and len(kept) == 6
    X_exp = s * O["lm_X"][:50] @ R.T + t
    assert int(merged.lm_valid.sum()) == 90
    np.testing.assert_allclose(merged.lm_X.numpy()[40:90], X_exp, rtol=1e-5,
                               atol=1e-5)
    x = O["lm_X"][7]
    xc_old = O["kf_R"][2] @ x + O["kf_t"][2]
    xc_new = merged.kf_R[7].numpy() @ (s * R @ x + t) + merged.kf_t[7].numpy()
    np.testing.assert_allclose(xc_new, s * xc_old, rtol=1e-4, atol=1e-4)


# ------------------------------------------- tests/test_weld_refine.py

def _project(R, t, X):
    xc = X @ R.T + t
    return np.stack([FX * xc[:, 0] / xc[:, 2] + CX,
                     FY * xc[:, 1] / xc[:, 2] + CY], axis=-1)


def _build_pair(noise_3d=0.03, depth_bias=0.05, seed=0):
    """The JAX test's two map fragments of one scene, as field dicts: the
    old one in a Sim3-transformed world with depth-biased, noisy
    landmarks; both keyframes observe exact pixels."""
    rng = np.random.default_rng(seed)
    N = 120
    X_A = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                    rng.uniform(4, 8, N)], axis=-1).astype(np.float32)
    s_gt = 1.3
    R_gt = np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.1, 0.2])),
                      np.float32)
    t_gt = np.array([0.4, -0.2, 0.3], np.float32)
    X_O_true = ((X_A - t_gt) @ R_gt) / s_gt
    bits = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    cfg = ms.MapConfig(max_kf=8, max_lm=512, n_feat=256)

    def build(X_world, R_kf, t_kf, uv):
        A = {k: np.array(v) for k, v in ms.to_numpy(ms.empty_map(cfg)).items()}
        A["kf_R"][0], A["kf_t"][0], A["kf_valid"][0] = R_kf, t_kf, True
        A["kf_uv"][0, :N] = uv
        A["kf_bits"][0, :N] = bits
        A["kf_feat_valid"][0, :N] = True
        A["kf_obs_lm"][0, :N] = np.arange(N)
        A["lm_X"][:N], A["lm_valid"][:N] = X_world, True
        A["lm_bits"][:N], A["lm_n_obs"][:N] = bits, 2
        A["n_kf"], A["n_lm"] = np.asarray(1, np.int32), np.asarray(N, np.int32)
        return A

    X_A_noisy = (X_A + rng.normal(0, noise_3d, X_A.shape)).astype(np.float32)
    mA = build(X_A_noisy, np.eye(3), np.zeros(3),
               _project(np.eye(3), np.zeros(3), X_A))
    R_o = R_gt
    t_o = np.asarray(t_gt / s_gt, np.float32)
    x_c = X_O_true @ R_o.T + t_o
    X_O = (((x_c * (1.0 + depth_bias)) - t_o) @ R_o
           + rng.normal(0, noise_3d, X_A.shape)).astype(np.float32)
    mO = build(X_O, R_o, t_o, _project(R_o, t_o, X_O_true))
    return mA, mO, (R_gt, t_gt, s_gt), cfg


def _sim3_err(cand, gt):
    R_gt, t_gt, s_gt = gt
    return (float(np.linalg.norm(cand.R - R_gt)),
            float(np.linalg.norm(cand.t - t_gt)), abs(cand.s - s_gt) / s_gt)


def _detect(mA, mO, seed):
    """The port's cross-map check on the JAX draw of PRNGKey(seed), and
    the JAX one."""
    pa, pb, pair_ids, mask = merging.cross_map_pairs(_port_map(mA), 0,
                                                     _port_map(mO), 0)
    key = jax.random.PRNGKey(seed)
    cand = merging.verify_cross_from_samples(
        pa, pb, pair_ids, mask, jax_samples(key, mask), 0, False, 20, "cpu")
    cand_j = jmerging.detect_cross_map(_jax_map(mA), 0, _jax_map(mO), 0, key,
                                       fix_scale=False, min_inliers=20)
    return cand, cand_j


@pytest.mark.parametrize("seed", [2, 3])
def test_detect_and_refine_match_jax(seed):
    mA, mO, _, _ = _build_pair(seed=seed)
    cand, cand_j = _detect(mA, mO, seed - 2)
    assert cand is not None and cand_j is not None
    np.testing.assert_allclose(cand.R, cand_j.R, atol=1e-4)
    np.testing.assert_allclose(cand.t, cand_j.t, atol=1e-4)
    assert abs(cand.s - cand_j.s) <= 1e-4
    np.testing.assert_array_equal(cand.lm_pairs, cand_j.lm_pairs)
    ref = jmerging.refine_weld_pnp(_jax_map(mA), _jax_map(mO), cand_j, FX, FY,
                                   CX, CY)
    got = merging.refine_weld_pnp(_port_map(mA), _port_map(mO), cand_j, FX,
                                  FY, CX, CY)
    np.testing.assert_allclose(got.R, ref.R, atol=1e-4)
    np.testing.assert_allclose(got.t, ref.t, atol=1e-3)
    assert abs(got.s - ref.s) <= 1e-4
    np.testing.assert_array_equal(got.lm_pairs, ref.lm_pairs)
    assert got.n_inliers == ref.n_inliers


def test_refine_weld_pnp_beats_3d3d():
    """On the JAX test's RANSAC draw (`PRNGKey(0)`): the bar compares the
    refined weld with the 3D-3D seed, whose error depends on the draw."""
    mA, mO, gt, _ = _build_pair(seed=2)
    cand, _ = _detect(mA, mO, 0)
    assert cand is not None and cand.ok and cand.lm_pairs.shape[0] >= 20
    dR0, dt0, _ = _sim3_err(cand, gt)
    refined = merging.refine_weld_pnp(_port_map(mA), _port_map(mO), cand, FX,
                                      FY, CX, CY)
    dR1, dt1, _ = _sim3_err(refined, gt)
    assert dt1 < 0.1 and dR1 < 0.05, (dt1, dR1)
    assert dt1 < 0.75 * dt0, (dt0, dt1)
    assert dR1 <= dR0 * 1.05, (dR0, dR1)


def test_detect_cross_map_own_draw():
    """The port's own draw (a `torch.Generator`) verifies the weld too."""
    mA, mO, gt, _ = _build_pair(seed=2)
    cand = merging.detect_cross_map(_port_map(mA), 0, _port_map(mO), 0,
                                    torch.Generator().manual_seed(0))
    assert cand is not None and cand.ok and cand.lm_pairs.shape[0] >= 20
    dR, dt, ds = _sim3_err(cand, gt)
    assert dR < 0.05 and dt < 0.3 and ds < 0.1, (dR, dt, ds)


def test_merge_with_alias_rewires_observations():
    mA, mO, _, cfg = _build_pair(seed=3)
    pA, pO = _port_map(mA), _port_map(mO)
    cand, _ = _detect(mA, mO, 1)
    cand = merging.refine_weld_pnp(pA, pO, cand, FX, FY, CX, CY)
    alias = np.full(cfg.max_lm, -1, np.int32)
    alias[cand.lm_pairs[:, 1]] = cand.lm_pairs[:, 0]
    merged, _, _ = merging.merge_maps(pA, pO, cand.R, cand.t, cand.s, cfg,
                                      lm_alias=alias)
    obs_new = merged.kf_obs_lm[1].numpy()
    n_cross = 0
    for la, lo in cand.lm_pairs:
        for j in np.flatnonzero(mO["kf_obs_lm"][0] == lo):
            assert obs_new[j] == la
            n_cross += 1
    assert n_cross >= 20
    n_alias = int((alias >= 0).sum())
    assert int(merged.lm_valid.sum()) == (int(mA["lm_valid"].sum())
                                          + int(mO["lm_valid"].sum())
                                          - n_alias)


@pytest.mark.slow
def test_lost_then_revisit_welds_maps(monkeypatch):
    """The port copy of `tests/test_map_merge.py`'s slow System case, with
    the initializer on the JAX System's draws (as `test_torch_reloc.py`):
    the first map must reach `MIN_KFS_KEEP_MAP` keyframes to be frozen."""
    from orb_slam3_ros2_tpu_torch.frontend import initializer as tinit
    from tests.test_torch_reloc import _jax_initialize

    monkeypatch.setattr(tinit, "initialize", _jax_initialize)
    images, _, _, ts = synthetic.render_sequence(
        n_frames=36, width=320, height=240, fx=260.0, fy=260.0, fps=10.0,
        seed=1, plane_depths=(6.0, 9.0), traj_scale=1.6)
    sys_ = System(None, SETTINGS, Sensor.MONOCULAR, device="cpu")
    for k in range(images.shape[0]):
        sys_.track_monocular(images[k], float(ts[k]))
    assert sys_.get_tracking_state() == TrackingState.OK
    rng = np.random.default_rng(0)
    t = float(ts[-1])
    for _ in range(sys_.LOST_FRAMES_NEW_MAP + 5):
        t += 0.1
        sys_.track_monocular(
            rng.uniform(0, 255, images[0].shape).astype(np.float32), t)
        if sys_.atlas.n_maps() > 1:
            break
    assert sys_.atlas.n_maps() == 2
    for k in range(images.shape[0]):
        t += 0.1
        sys_.track_monocular(images[k], t)
        if sys_.n_maps_merged > 0:
            break
    assert sys_.n_maps_merged == 1
    assert sys_.atlas.n_maps() == 1
    assert sys_.get_tracking_state() == TrackingState.OK
    assert int(sys_.map.n_kf) > 8
    assert int(sys_.bow_db.n) == int(sys_.map.n_kf)
