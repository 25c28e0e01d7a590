"""The port's host output products against the JAX ones
(`orb_slam3_ros2_tpu/runtime/outputs.py`, `tests/test_outputs.py`): the
point-cloud filters through the native library and through scipy, the
occupancy grid, the PCD / PGM / YAML files (byte-identical, and each
package reads the other's), `annotate_frame`, the TUM and KITTI trajectory
exports of `SlamSession` and `System.get_pretty_frame`."""

import os
import types

import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.runtime import outputs as jout
from orb_slam3_ros2_tpu.runtime import session as jsession
from orb_slam3_ros2_tpu.runtime.system import System as JSystem
from orb_slam3_ros2_tpu_torch.runtime import outputs
from orb_slam3_ros2_tpu_torch.runtime import session as tsession
from orb_slam3_ros2_tpu_torch.runtime.system import System

SETTINGS = os.path.join(os.path.dirname(__file__), "data", "synth_cam.yaml")


def _cloud(seed=11):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(0, 0.3, (800, 3)),
                           rng.uniform(-8, 8, (60, 3))]).astype(np.float32)


@pytest.mark.parametrize("native", [True, False], ids=["native", "scipy"])
def test_filters_equal_jax(native):
    if native and outputs._native_filter() is None:
        pytest.skip("native library not loadable here")
    pts = _cloud()
    kw = dict(sor_mean_k=30, sor_stddev=0.5, radius=0.15, min_neighbors=4,
              native=native)
    got = outputs.filter_point_cloud(pts, **kw)
    want = jout.filter_point_cloud(pts, **kw)
    assert np.array_equal(got, want)
    assert 0 < len(got) < len(pts)
    # the defaults (the wrapper's PCL parameters) too
    assert np.array_equal(outputs.filter_point_cloud(pts, native=native),
                          jout.filter_point_cloud(pts, native=native))


def test_native_filter_matches_scipy():
    if outputs._native_filter() is None:
        pytest.skip("native library not loadable here")
    pts = _cloud(3)
    kw = dict(sor_mean_k=30, sor_stddev=0.5, radius=0.15, min_neighbors=4)
    assert np.array_equal(outputs.filter_point_cloud(pts, native=True, **kw),
                          outputs.filter_point_cloud(pts, native=False, **kw))


@pytest.mark.parametrize("z_band", [None, (-0.2, 0.4)])
def test_occupancy_grid_equals_jax(z_band):
    pts = np.random.default_rng(2).normal(0, 1.0, (400, 3))
    grid, origin = outputs.point_cloud_to_occupancy_grid(pts, z_band=z_band)
    jgrid, jorigin = jout.point_cloud_to_occupancy_grid(pts, z_band=z_band)
    assert np.array_equal(grid, jgrid) and origin == jorigin
    assert (grid == 100).sum() > 0


def test_pcd_pgm_yaml_byte_identical(tmp_path):
    pts = _cloud()
    outputs.save_pcd(str(tmp_path / "port" / "c.pcd"), pts)
    jout.save_pcd(str(tmp_path / "jax" / "c.pcd"), pts)
    a = (tmp_path / "port" / "c.pcd").read_bytes()
    assert a == (tmp_path / "jax" / "c.pcd").read_bytes()
    assert np.array_equal(outputs.load_pcd(str(tmp_path / "jax" / "c.pcd")),
                          jout.load_pcd(str(tmp_path / "port" / "c.pcd")))
    np.testing.assert_allclose(outputs.load_pcd(str(tmp_path / "port" /
                                                    "c.pcd")), pts,
                               atol=1e-6)
    grid, origin = outputs.point_cloud_to_occupancy_grid(pts)
    outputs.save_occupancy_grid(str(tmp_path / "port" / "map"), grid, origin)
    jout.save_occupancy_grid(str(tmp_path / "jax" / "map"), grid, origin)
    for ext in (".pgm", ".yaml"):
        assert ((tmp_path / "port" / f"map{ext}").read_bytes()
                == (tmp_path / "jax" / f"map{ext}").read_bytes())


def test_annotate_frame_equals_jax():
    img = np.random.default_rng(4).integers(0, 255, (120, 160), np.uint8)
    uv = np.array([[10.0, 20.0], [150.0, 100.0], [70.5, 60.2]])
    mask = np.array([True, False, True])
    tracked = np.array([True, False, False])
    for tr in (None, tracked):
        vis = outputs.annotate_frame(img, uv, mask, tr)
        assert vis.shape == (120, 160, 3)
        assert np.array_equal(vis, jout.annotate_frame(img, uv, mask, tr))


def _stub_system(traj):
    return types.SimpleNamespace(get_frame_trajectory=lambda: traj)


def test_trajectory_exports_byte_identical(tmp_path):
    """`save_trajectory_tum` / `_kitti` write the same bytes as the JAX
    session's for the same poses."""
    rng = np.random.default_rng(5)
    traj = []
    for k in range(6):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = q * np.sign(np.linalg.det(q))
        T[:3, 3] = rng.normal(size=3)
        traj.append((0.1 * k, T))
    files = {}
    for name, mod in (("port", tsession), ("jax", jsession)):
        s = mod.SlamSession(SETTINGS, output_name="t",
                            output_root=str(tmp_path / name),
                            system=_stub_system(traj))
        files[name] = [open(s.save_trajectory_tum(), "rb").read(),
                       open(s.save_trajectory_kitti(), "rb").read()]
    assert files["port"] == files["jax"]
    rows = np.loadtxt(os.path.join(tmp_path, "port", "t",
                                   "t_traj_kitti.txt"))
    M = rows[-1].reshape(3, 4)
    np.testing.assert_allclose(M[:, :3] @ M[:, :3].T, np.eye(3), atol=1e-5)


def test_get_pretty_frame_equals_jax():
    rng = np.random.default_rng(6)
    img = rng.integers(0, 255, (240, 320), np.uint8)
    uv = rng.uniform(0, 320, (50, 2)).astype(np.float32)
    mask = rng.random(50) < 0.7
    port = types.SimpleNamespace(last_frame_feats=types.SimpleNamespace(
        uv=torch.from_numpy(uv), mask=torch.from_numpy(mask)))
    ref = types.SimpleNamespace(last_frame_feats=types.SimpleNamespace(
        uv=uv, mask=mask))
    got = System.get_pretty_frame(port, img)
    assert np.array_equal(got, JSystem.get_pretty_frame(ref, img))
    assert System.get_pretty_frame(port, None) is None
    port.last_frame_feats = None
    assert System.get_pretty_frame(port, img) is None
