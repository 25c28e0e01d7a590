"""Parity of the port's `frontend/stereo.py` with the JAX package on the
CPU: the rectified scanline matcher with `obs_from_rectified`, the general
two-view matcher, and `obs_from_depth`, each on the same features through
both packages. Valid masks and matched columns must be equal (Hamming
distances are integers and both matchers take the first minimum); depths
and points agree within 1e-4 relative.

Float gates could flip a pair between the packages if it sat within float
rounding of a threshold, so each case masks out the left features of any
pair within 1e-5 of a gate threshold (row band, disparity bounds, epipolar
tolerance, parallax cosine) and asserts how many were dropped: at most 3
in the rectified cases, at most 15% in the general ones (the parallax
cosine sits near 1, where 1e-5 spans a few milliradians)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_ros2_tpu.frontend import stereo as jst
from orb_slam3_ros2_tpu.ops import orb_descriptor as jdesc
from orb_slam3_ros2_tpu_torch.frontend import stereo as tst
from orb_slam3_ros2_tpu_torch.io import synthetic
from orb_slam3_ros2_tpu_torch.runtime.system import Sensor, System
from tests.test_stereo_general import _rig

REL_TOL = 1e-4  # depth and X_cam, port vs JAX
GATE_MARGIN = 1e-5  # pairs closer than this to a float gate are left out
FX = FY = 260.0
CX, CY, W, H = 160.0, 120.0, 320, 240
BASELINE = 0.12


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


def _signs(bits):
    return np.asarray(jdesc.signs_from_bits(jnp.asarray(bits)))


def _flip(bits, rng, max_flips):
    out = bits.copy()
    for i in range(len(out)):
        for b in rng.choice(256, rng.integers(0, max_flips + 1), replace=False):
            out[i, b // 32] ^= np.uint32(1 << (b % 32))
    return out


def _assert_close_rel(got, want, valid):
    g, w = np.asarray(got)[valid], np.asarray(want)[valid]
    np.testing.assert_allclose(g, w, rtol=REL_TOL, atol=REL_TOL * 1e-3)


def _rectified_case(seed, n=300, n_extra=80):
    """Left and right features of points seen by a rectified rig (right
    shuffled, descriptors with a few flipped bits, sub-pixel row noise,
    levels off by at most one) plus unmatched distractors on both sides."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                  rng.uniform(1.5, 30.0, n)], -1)
    uv_l = np.stack([FX * X[:, 0] / X[:, 2] + CX,
                     FY * X[:, 1] / X[:, 2] + CY], -1)
    uv_r = np.stack([FX * (X[:, 0] - BASELINE) / X[:, 2] + CX,
                     uv_l[:, 1] + rng.normal(0, 0.4, n)], -1)
    lvl_l = rng.integers(0, 4, n)
    lvl_r = np.clip(lvl_l + rng.integers(-1, 2, n), 0, 3)
    bits_l = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    bits_r = _flip(bits_l, rng, 10)
    extra = lambda k: (rng.uniform([0, 0], [W, H], (k, 2)),  # noqa: E731
                       rng.integers(0, 4, k),
                       rng.integers(0, 2 ** 32, (k, 8), dtype=np.uint32))
    el, er = extra(n_extra), extra(n_extra)
    uv_l = np.concatenate([uv_l, el[0]]).astype(np.float32)
    lvl_l = np.concatenate([lvl_l, el[1]]).astype(np.int32)
    bits_l = np.concatenate([bits_l, el[2]])
    perm = rng.permutation(n + n_extra)
    uv_r = np.concatenate([uv_r, er[0]])[perm].astype(np.float32)
    lvl_r = np.concatenate([lvl_r, er[1]])[perm].astype(np.int32)
    bits_r = np.concatenate([bits_r, er[2]])[perm]
    mask_l = rng.random(n + n_extra) > 0.05
    mask_r = rng.random(n + n_extra) > 0.05
    return uv_l, bits_l, mask_l, lvl_l, uv_r, bits_r, mask_r, lvl_r


def _rectified_near_gate(uv_l, lvl_l, uv_r, mask_r, lvl_r, fx, b,
                         row_tol=2.0, min_disp=0.5, max_depth=60.0):
    """(N,) left features with a pair within GATE_MARGIN of a threshold of
    `match_stereo`'s gate, in float64."""
    u_l, u_r = uv_l.astype(np.float64), uv_r.astype(np.float64)
    row_gap = np.abs(u_l[:, None, 1] - u_r[None, :, 1])
    tol = row_tol * 1.25 ** np.maximum(lvl_l[:, None], lvl_r[None, :])
    disp = u_l[:, None, 0] - u_r[None, :, 0]
    lo, hi = max(min_disp, fx * b / max_depth), fx * b / 0.3
    near = ((np.abs(row_gap - tol) < GATE_MARGIN)
            | (np.abs(disp - lo) < GATE_MARGIN)
            | (np.abs(disp - hi) < GATE_MARGIN)
            | (np.abs(disp - min_disp) < GATE_MARGIN))
    return (near & mask_r[None, :]).any(axis=1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_stereo_and_obs_from_rectified_match_jax(seed):
    uv_l, bits_l, mask_l, lvl_l, uv_r, bits_r, mask_r, lvl_r = \
        _rectified_case(seed)
    near = _rectified_near_gate(uv_l, lvl_l, uv_r, mask_r, lvl_r, FX,
                                BASELINE)
    assert near.sum() <= 3, near.sum()
    mask_l = mask_l & ~near
    s_l, s_r = _signs(bits_l), _signs(bits_r)
    args = (uv_l, s_l, mask_l, lvl_l, uv_r, s_r, mask_r, lvl_r)
    sm_j = jst.match_stereo(*map(_j, args), FX, BASELINE)
    sm_t = tst.match_stereo(*map(_t, args), FX, BASELINE)
    valid = np.asarray(sm_j.valid)
    assert valid.sum() > 150, valid.sum()
    np.testing.assert_array_equal(sm_t.valid.numpy(), valid)
    np.testing.assert_array_equal(sm_t.right_u.numpy()[valid],
                                  np.asarray(sm_j.right_u)[valid])
    _assert_close_rel(sm_t.disparity.numpy(), sm_j.disparity, valid)
    _assert_close_rel(sm_t.depth.numpy(), sm_j.depth, valid)
    assert (sm_t.depth.numpy()[~valid] == 0).all()

    ob_j = jst.obs_from_rectified(sm_j, _j(uv_l), FX, FY, CX, CY)
    ob_t = tst.obs_from_rectified(sm_t, _t(uv_l), FX, FY, CX, CY)
    np.testing.assert_array_equal(ob_t.valid.numpy(), valid)
    _assert_close_rel(ob_t.X_cam.numpy(), ob_j.X_cam, valid)
    _assert_close_rel(ob_t.depth.numpy(), ob_j.depth, valid)


def test_rectified_obs_matches_backproject():
    """The port's copy of `tests/test_stereo_general.py`'s case: the
    rectified wrapper gives the backprojected points."""
    rng = np.random.default_rng(3)
    n = 32
    uv = rng.uniform(10, 200, (n, 2)).astype(np.float32)
    depth = rng.uniform(1.0, 10.0, n).astype(np.float32)
    sm = tst.StereoMatch(depth=_t(depth), disparity=torch.zeros(n),
                         right_u=torch.zeros(n),
                         valid=torch.ones(n, dtype=torch.bool))
    so = tst.obs_from_rectified(sm, _t(uv), FX, FY, CX, CY)
    X = tst.backproject(_t(uv), _t(depth), FX, FY, CX, CY)
    np.testing.assert_allclose(so.X_cam.numpy(), X.numpy(), atol=1e-6)
    np.testing.assert_allclose(so.depth.numpy(), depth, atol=1e-6)


def _general_case(seed):
    """`tests/test_stereo_general.py`'s `_rig` on
    `tests/data/synth_kb8_stereo.yaml`: right features shuffled, with a few
    flipped bits and random levels off by at most one, rays through each
    camera's own KB8 unprojection (the JAX one, so both packages match the
    same rays)."""
    from orb_slam3_ros2_tpu.models import cameras as jcam

    s, cam1, cam2, R12, t12, X1, uv1, uv2, vis, bits = _rig(seed=seed, n=300)
    n = X1.shape[0]
    rng = np.random.default_rng(seed + 10)
    perm = rng.permutation(n)
    lvl_l = rng.integers(0, 4, n).astype(np.int32)
    lvl_r = np.clip(lvl_l + rng.integers(-1, 2, n), 0, 3).astype(np.int32)
    rays_l = np.asarray(jcam.unproject(cam1, jnp.asarray(uv1)), np.float32)
    rays_r = np.asarray(jcam.unproject(cam2, jnp.asarray(uv2[perm])),
                        np.float32)
    bits_r = _flip(bits, rng, 10)[perm]
    return (rays_l, bits, vis.copy(), lvl_l, rays_r, bits_r, vis[perm],
            lvl_r[perm], R12.astype(np.float32), t12.astype(np.float32))


def _general_near_gate(rays_l, lvl_l, rays_r, mask_r, lvl_r, R12, t12,
                       max_depth, eps_epi=6e-3, sf=1.2):
    """(N,) left features with a pair within GATE_MARGIN of a threshold of
    `match_stereo_general`'s gate, in float64."""
    nl = rays_l / np.linalg.norm(rays_l, axis=-1, keepdims=True)
    b = rays_r.astype(np.float64) @ R12.T.astype(np.float64)
    nb = b / np.linalg.norm(b, axis=-1, keepdims=True)
    nrm = np.cross(np.broadcast_to(t12, nb.shape), nb)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    epi = np.abs(nl @ nrm.T)
    tol = eps_epi * sf ** np.maximum(lvl_l[:, None], lvl_r[None, :])
    cos_par = nl @ nb.T
    c_min = np.cos(np.linalg.norm(t12) / max_depth)
    # the parallax term decides a pair only where the epipolar and level
    # terms can pass
    can_pass = ((epi <= tol + GATE_MARGIN)
                & (np.abs(lvl_l[:, None] - lvl_r[None, :]) <= 1))
    near = ((np.abs(epi - tol) < GATE_MARGIN)
            | (can_pass & (np.abs(cos_par - c_min) < GATE_MARGIN)))
    return (near & mask_r[None, :]).any(axis=1)


@pytest.mark.parametrize("seed,max_depth", [(0, 20.0), (1, 60.0),
                                            (2, 20.0)])
def test_match_stereo_general_matches_jax(seed, max_depth):
    (rays_l, bits_l, mask_l, lvl_l, rays_r, bits_r, mask_r, lvl_r, R12,
     t12) = _general_case(seed)
    near = _general_near_gate(rays_l, lvl_l, rays_r, mask_r, lvl_r, R12,
                              t12, max_depth)
    # the parallax band |cos - cos θ_min| < 1e-5 is ±2-6 mrad wide in angle,
    # so wrong pairs on the same epipolar plane fall in it for ~10% of the
    # left features; those features are left out
    assert near.sum() <= 0.15 * len(near), near.sum()
    mask_l = mask_l & ~near
    s_l, s_r = _signs(bits_l), _signs(bits_r)
    args = (rays_l, s_l, mask_l, lvl_l, rays_r, s_r, mask_r, lvl_r, R12,
            t12)
    ob_j = jst.match_stereo_general(*map(_j, args), max_depth=max_depth)
    ob_t = tst.match_stereo_general(*map(_t, args), max_depth=max_depth)
    valid = np.asarray(ob_j.valid)
    assert valid.sum() > 0.5 * mask_l.sum(), (valid.sum(), mask_l.sum())
    np.testing.assert_array_equal(ob_t.valid.numpy(), valid)
    _assert_close_rel(ob_t.X_cam.numpy(), ob_j.X_cam, valid)
    _assert_close_rel(ob_t.depth.numpy(), ob_j.depth, valid)
    assert (ob_t.X_cam.numpy()[~valid] == 0).all()


@pytest.fixture(scope="module")
def depth_map():
    _, depths, _, _, _ = synthetic.render_sequence(
        n_frames=1, width=W, height=H, fx=FX, fy=FY, fps=10.0, seed=2,
        plane_depths=(5.0, 8.0), traj_scale=1.4, return_depth=True)
    return depths[0]


@pytest.mark.parametrize("max_depth", [40.0, 6.5])
def test_obs_from_depth_matches_jax(depth_map, max_depth):
    """Raw keypoints over the whole image and past its edges (clamped),
    a quarter on exact half-pixel positions (round half to even); the
    undistorted pixels are the raw ones moved by up to 2 px."""
    rng = np.random.default_rng(4)
    n = 600
    uv_raw = rng.uniform([-3, -3], [W + 3, H + 3], (n, 2))
    half = rng.random(n) < 0.25
    uv_raw[half] = np.floor(uv_raw[half]) + 0.5
    uv_raw = uv_raw.astype(np.float32)
    uv_u = (uv_raw + rng.uniform(-2, 2, (n, 2))).astype(np.float32)
    mask = rng.random(n) > 0.1
    d = depth_map.copy()
    d[:20, :20] = 0.0  # no surface
    d[-20:, -20:] = np.nan
    args = (uv_raw, uv_u, mask, d)
    ob_j = jst.obs_from_depth(*map(_j, args), FX, FY, CX, CY,
                              max_depth=max_depth)
    ob_t = tst.obs_from_depth(*map(_t, args), FX, FY, CX, CY,
                              max_depth=max_depth)
    valid = np.asarray(ob_j.valid)
    assert 100 < valid.sum() < mask.sum()
    np.testing.assert_array_equal(ob_t.valid.numpy(), valid)
    np.testing.assert_array_equal(ob_t.depth.numpy(), np.asarray(ob_j.depth))
    _assert_close_rel(ob_t.X_cam.numpy(), ob_j.X_cam, valid)
    assert (ob_t.X_cam.numpy()[~valid] == 0).all()


def test_system_selects_general_path():
    """The port's copy of `tests/test_stereo_general.py`'s System case."""
    paths = {name: os.path.join(os.path.dirname(__file__), "data",
                                f"{name}.yaml")
             for name in ("synth_kb8_stereo", "synth_stereo")}
    sys_ = System(None, str(paths["synth_kb8_stereo"]), Sensor.STEREO,
                  device="cpu")
    assert sys_._stereo_right_raw  # general two-view path active
    assert abs(sys_.stereo_baseline - 0.1010) < 1e-3
    sys_r = System(None, str(paths["synth_stereo"]), Sensor.STEREO,
                   device="cpu")
    assert not sys_r._stereo_right_raw  # rectified scanline path
    assert sys_r.stereo_baseline == 0.12
