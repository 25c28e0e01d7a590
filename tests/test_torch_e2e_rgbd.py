"""End-to-end RGB-D SLAM through the port's `System.track_rgbd` from a
blank map, on the rendered 30-frame image + depth clip of
`tests/test_e2e_rgbd.py` (`tests/data/synth_cam.yaml`, loop closing on)
and held to that test's bounds: state OK at the end, more
than 15 tracked frames, the unaligned trajectory length within 10% of the
ground truth's, Sim3-aligned ATE under 0.08 m. The path draws no random
samples."""

import os

import numpy as np
import pytest

from orb_slam3_ros2_tpu_torch.io import synthetic
from orb_slam3_ros2_tpu_torch.runtime.system import (Sensor, System,
                                                     TrackingState)
from tests.test_torch_e2e_stereo import (centres, length_error,
                                         two_threads)  # noqa: F401

SETTINGS = os.path.join(os.path.dirname(__file__), "data", "synth_cam.yaml")


@pytest.fixture(scope="module")
def rendered():
    return synthetic.render_sequence(
        n_frames=30, width=320, height=240, fx=260.0, fy=260.0,
        fps=10.0, seed=2, plane_depths=(5.0, 8.0), traj_scale=1.4,
        return_depth=True)


def test_depth_maps_consistent_with_planes(rendered):
    """The port's renderer gives the depth channel of the JAX test: frame
    0's visible depths lie between the nearer plane and the farther."""
    imgs, depths, R_gt, t_gt, ts = rendered
    d = depths[0][depths[0] > 0]
    assert d.min() > 3.0 and d.max() < 10.0
    assert np.isfinite(depths).all()


def test_port_e2e_rgbd_metric_scale(rendered, tmp_path,
                                    two_threads):  # noqa: F811
    imgs, depths, R_gt, t_gt, ts = rendered
    sys_ = System(None, SETTINGS, Sensor.RGBD,
                  device="cpu")
    for k in range(imgs.shape[0]):
        T = sys_.track_rgbd(imgs[k], depths[k], float(ts[k]))
        assert T.shape == (4, 4) and np.isfinite(T).all()
    assert sys_.get_tracking_state() == TrackingState.OK
    est, gt = centres(sys_, R_gt, t_gt)
    assert len(est) > 15
    err = length_error(est, gt)
    assert err < 0.1, err
    ate = synthetic.ate_rmse(est, gt, align=True)
    assert ate < 0.08, f"rgbd ATE {ate:.4f} m"
