"""The port's KITTI and TUM RGB-D loaders against the JAX ones
(`orb_slam3_ros2_tpu/io/kitti.py`, `io/tum_rgbd.py`; `tests/
test_io_loaders.py`), and the port's TUM RGB-D writer, which the JAX
package does not have: what it writes, both loaders read back equal."""

import dataclasses

import numpy as np
import pytest

from orb_slam3_ros2_tpu.io import kitti as jkitti
from orb_slam3_ros2_tpu.io import tum_rgbd as jtum
from orb_slam3_ros2_tpu_torch.io import kitti, tum_rgbd
from tests.test_io_loaders import _write_kitti


def _same_sequence(a, b):
    assert [dataclasses.astuple(f) for f in a.frames] == [
        dataclasses.astuple(f) for f in b.frames]
    for name in ("imu_t", "imu_gyro", "imu_acc", "gt_t", "gt_p", "gt_q"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None and y is None) or np.array_equal(x, y), name


@pytest.mark.parametrize("stereo", [False, True])
def test_kitti_loader_equals_jax(tmp_path, stereo):
    root = _write_kitti(tmp_path, n=7)
    seq = kitti.load_sequence(str(root), "07", stereo=stereo)
    _same_sequence(seq, jkitti.load_sequence(str(root), "07", stereo=stereo))
    assert len(seq.frames) == 7 and seq.frames[3].t == 0.3
    np.testing.assert_allclose(seq.gt_p[4], [2.0, 0.0, 0.4])
    # pointed straight at the sequence directory
    seq_dir = str(root / "sequences" / "07")
    _same_sequence(kitti.load_sequence(seq_dir),
                   jkitti.load_sequence(seq_dir))


def _clip(n=5, h=24, w=32):
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (n, h, w)).astype(np.float32)
    depths = rng.uniform(0.5, 9.0, (n, h, w)).astype(np.float32)
    depths[0, 0, 0] = np.nan
    depths[1, 0, 0] = 20.0  # past 65535 / 5000 m: written as 0
    ts = 1.0 + 0.05 * np.arange(n)
    centres = rng.normal(size=(n, 3))
    return images, depths, ts, centres


def test_tum_rgbd_written_and_read_by_both(tmp_path):
    images, depths, ts, centres = _clip()
    root = tum_rgbd.write_sequence(str(tmp_path / "fr1"), images, depths,
                                   ts, centres)
    seq = tum_rgbd.load_sequence(root)
    ref = jtum.load_sequence(root)
    assert [dataclasses.astuple(f) for f in seq.frames] == [
        dataclasses.astuple(f) for f in ref.frames]
    assert np.array_equal(seq.gt_t, ref.gt_t)
    assert np.array_equal(seq.gt_p, ref.gt_p)
    assert len(seq.frames) == len(ts)
    for k, (fr, jfr) in enumerate(zip(seq.frames, ref.frames)):
        img, depth = fr.load()
        jimg, jdepth = jfr.load()
        assert np.array_equal(img, jimg) and np.array_equal(depth, jdepth)
        assert np.array_equal(img, images[k].astype(np.uint8))
        ok = np.isfinite(depths[k]) & (depths[k] * tum_rgbd.DEPTH_SCALE
                                       <= 65535)
        np.testing.assert_allclose(depth[ok], depths[k][ok],
                                   atol=0.5 / tum_rgbd.DEPTH_SCALE + 1e-6)
        assert (depth[~ok] == 0).all()
        np.testing.assert_allclose(seq.gt_at(fr.t), centres[k], atol=1e-6)


def test_tum_rgbd_association_equals_jax(tmp_path):
    """An unsynchronized depth stream: both loaders pair each rgb frame
    with the nearest depth map within max_dt and drop the rest."""
    images, depths, ts, centres = _clip(n=6)
    root = tmp_path / "fr2"
    tum_rgbd.write_sequence(str(root), images, depths, ts, centres)
    rows = (root / "depth.txt").read_text().splitlines()
    body = [r for r in rows if not r.startswith("#")]
    shifted = []
    for k, row in enumerate(body[:-1]):  # the last frame loses its depth
        t, name = row.split()
        shifted.append(f"{float(t) + 0.006 * (k % 2):.6f} {name}")
    (root / "depth.txt").write_text("\n".join(shifted) + "\n")
    for max_dt in (0.02, 0.004):
        seq = tum_rgbd.load_sequence(str(root), max_dt=max_dt)
        ref = jtum.load_sequence(str(root), max_dt=max_dt)
        assert [dataclasses.astuple(f) for f in seq.frames] == [
            dataclasses.astuple(f) for f in ref.frames]
    assert len(tum_rgbd.load_sequence(str(root)).frames) == 5
    assert len(tum_rgbd.load_sequence(str(root), max_dt=0.004).frames) == 3
