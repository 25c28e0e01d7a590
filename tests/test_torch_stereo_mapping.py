"""Parity of the port's stereo keyframe insertion and one-frame stereo
initialization with the JAX System on the CPU, on the JAX-built map of
`test_torch_map_state.synthetic_map`.

The port inserts a rig keyframe as one `mapping_step` with its stereo stage
(`System._insert_keyframe_fused(..., stereo)`); the JAX System runs the
staged `_insert_keyframe(..., stereo=sm)`. From the same map, features,
associations and `StereoObs`, both must end with equal keyframe and
landmark counts and association tables, the keyframe pose within 1e-4 and
the landmarks within 1e-3."""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_ros2_tpu.atlas import map_state as jms
from orb_slam3_ros2_tpu.frontend import stereo as jst
from orb_slam3_ros2_tpu.ops import orb_descriptor as jdesc
from orb_slam3_ros2_tpu_torch.atlas import map_state as tms
from orb_slam3_ros2_tpu_torch.frontend import stereo as tst
from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as tdesc
from orb_slam3_ros2_tpu_torch.runtime import system as tsys
from tests.test_torch_map_state import (CX, CY, FX, FY, H, W,
                                        assert_maps_equal, jax_map,
                                        synthetic_map)
from tests.test_torch_mapping import jax_system  # noqa: F401  (fixture)

POSE_ATOL = 1e-4  # keyframe pose after the insertion's local BA
POINT_ATOL = 1e-3  # landmark positions after local BA
KF_TIMES = [0.0, 0.1, 0.2, 0.3]  # synthetic_map's keyframe times


@pytest.fixture(scope="module")
def port_system(tmp_path_factory):
    """A port System with the JAX fixture's settings and map size."""
    path = tmp_path_factory.mktemp("cfg") / "cam.yaml"
    path.write_text(
        "%YAML:1.0\nCamera.type: \"Rectified\"\n"
        f"Camera1.fx: {FX}\nCamera1.fy: {FY}\nCamera1.cx: {CX}\n"
        f"Camera1.cy: {CY}\nCamera.width: {W}\nCamera.height: {H}\n"
        "Camera.fps: 10\nORBextractor.nFeatures: 120\n"
        "ORBextractor.nLevels: 1\nloopClosing: 0\n")
    return tsys.System(None, str(path), tsys.Sensor.STEREO, device="cpu",
                       map_cfg=tms.MapConfig(max_kf=8, max_lm=400,
                                             n_feat=120))


def _stereo_obs(new, seed, frac=0.7):
    """A StereoObs for the new keyframe's features: `frac` of the valid
    ones carry a point 5-9 m deep along their ray."""
    rng = np.random.default_rng(seed)
    n = len(new["mask"])
    valid = new["mask"] & (rng.random(n) < frac)
    depth = np.where(valid, rng.uniform(5.0, 9.0, n), 0.0).astype(np.float32)
    uv = new["uv"]
    X = np.stack([(uv[:, 0] - CX) / FX * depth, (uv[:, 1] - CY) / FY * depth,
                  depth], -1).astype(np.float32)
    return X, depth, valid


def _features(new):
    """The new keyframe's features as each System reads them."""
    bits = np.asarray(new["bits"])
    fj = types.SimpleNamespace(
        uv=jnp.asarray(new["uv"]), level=jnp.asarray(new["level"]),
        bits=jnp.asarray(bits), mask=jnp.asarray(new["mask"]),
        signs=jdesc.signs_from_bits(jnp.asarray(bits)))
    bits_t = torch.from_numpy(bits.view(np.int32))
    ft = types.SimpleNamespace(
        uv=torch.from_numpy(new["uv"]), level=torch.from_numpy(new["level"]),
        bits=bits_t, mask=torch.from_numpy(new["mask"]),
        signs=tdesc.signs_from_bits(bits_t))
    return fj, ft


def _pose44(R, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, t
    return T


def test_stereo_insertion_matches_jax_staged(jax_system, port_system):  # noqa: F811
    f, new = synthetic_map(seed=3)
    X, depth, valid = _stereo_obs(new, seed=5)
    fj, ft = _features(new)
    T = _pose44(new["R"], new["t"])
    t_new = float(new["time"])

    js = jax_system
    js.map, js.Tcw, js.kf_times = jax_map(f), T.copy(), list(KF_TIMES)
    js._insert_keyframe(
        fj, jnp.asarray(new["obs"]), t_new, 80,
        stereo=jst.StereoObs(X_cam=jnp.asarray(X), depth=jnp.asarray(depth),
                             valid=jnp.asarray(valid)))

    ps = port_system
    ps.map, ps.Tcw, ps.kf_times = tms.from_numpy(f), T.copy(), list(KF_TIMES)
    ps._insert_keyframe_fused(
        ft, torch.from_numpy(new["obs"]), t_new, 80,
        tst.StereoObs(X_cam=torch.from_numpy(X),
                      depth=torch.from_numpy(depth),
                      valid=torch.from_numpy(valid)))

    mj, mt = js.map, ps.map
    assert int(mt.n_kf) == int(mj.n_kf) == 5
    assert int(mt.n_lm) == int(mj.n_lm)
    np.testing.assert_allclose(ps.Tcw, js.Tcw, atol=POSE_ATOL)
    for name, tol in (("kf_R", POSE_ATOL), ("kf_t", POSE_ATOL),
                      ("lm_X", POINT_ATOL)):
        np.testing.assert_allclose(getattr(mt, name).numpy(),
                                   np.asarray(getattr(mj, name)), atol=tol,
                                   err_msg=name)
    assert_maps_equal(mt, mj, skip=("kf_R", "kf_t", "lm_X"))
    assert ps.kf_times == js.kf_times
    assert bool(ps.bow_db.valid[4])  # the new keyframe's BoW row, slot 4

    # the stereo stage spawned landmarks beyond what the mono step makes
    m_mono, _ = tsys.mapping_step(
        tms.from_numpy(f), torch.from_numpy(new["R"]),
        torch.from_numpy(new["t"]), t_new, ft.uv, ft.level, ft.bits, ft.mask,
        torch.from_numpy(new["obs"]), FX, FY, CX, CY, W, H, n_window=8,
        n_fixed_ring=4)
    assert int(mt.n_lm) > int(m_mono.n_lm) + 20, (int(mt.n_lm),
                                                   int(m_mono.n_lm))


@pytest.mark.parametrize("frac,initialized", [(0.9, True), (0.5, False)])
def test_initialize_stereo_matches_jax(jax_system, port_system, frac,  # noqa: F811
                                       initialized):
    """At least 80 features with a point make keyframe 0 at the identity
    with each of them a landmark (equal maps); fewer leave the map empty."""
    _, new = synthetic_map(seed=3)
    X, depth, valid = _stereo_obs(new, seed=6, frac=frac)
    if not initialized:
        valid &= np.cumsum(valid) <= 79
    fj, ft = _features(new)
    js, ps = jax_system, port_system
    js.map = jms.empty_map(js.map_cfg)
    ps.map = tms.empty_map(ps.map_cfg)
    js.state = ps.state = tsys.TrackingState.NOT_INITIALIZED
    js._initialize_stereo(
        fj, jst.StereoObs(X_cam=jnp.asarray(X), depth=jnp.asarray(depth),
                          valid=jnp.asarray(valid)), 0.5)
    ps._initialize_stereo(
        ft, tst.StereoObs(X_cam=torch.from_numpy(X),
                          depth=torch.from_numpy(depth),
                          valid=torch.from_numpy(valid)), 0.5)
    assert int(ps.state) == int(js.state) == int(initialized)
    assert_maps_equal(ps.map, js.map)
    assert int(ps.map.n_lm) == (int(valid.sum()) if initialized else 0)
    if initialized:
        assert ps.kf_times == js.kf_times == [0.5]
        assert ps.last_kf_inliers == js.last_kf_inliers
        np.testing.assert_array_equal(ps.Tcw, np.eye(4, dtype=np.float32))
