"""End-to-end stereo SLAM through the port's `System.track_stereo` from a
blank map, on the rendered 30-frame clip of `tests/test_e2e_stereo.py`
(`tests/data/synth_stereo.yaml`, loop closing on) and held to that
test's bounds: state OK at the end, more than 15 tracked frames, the
unaligned trajectory length within 12% of the ground truth's (stereo
observes metric scale), Sim3-aligned ATE under 0.08 m. The path draws no
random samples."""

import os

import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu_torch.io import synthetic
from orb_slam3_ros2_tpu_torch.runtime.system import (Sensor, System,
                                                     TrackingState)

SETTINGS = os.path.join(os.path.dirname(__file__), "data", "synth_stereo.yaml")
BASELINE = 0.12


@pytest.fixture
def two_threads():
    """Two intra-op threads, as `test_torch_e2e_mono.py`."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def centres(sys_, R_gt, t_gt):
    """Camera centres of get_trajectory() and the ground truth over the
    frames tracked OK."""
    est, gt = [], []
    for k, (_, T) in enumerate(sys_.get_trajectory()):
        if sys_.tracking_log[k]["state"] != int(TrackingState.OK):
            continue
        est.append(-T[:3, :3].T @ T[:3, 3])
        gt.append(-R_gt[k].T @ t_gt[k])
    return np.asarray(est), np.asarray(gt)


def length_error(est, gt) -> float:
    len_est = np.linalg.norm(np.diff(est, axis=0), axis=1).sum()
    len_gt = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert len_gt > 0.2
    return abs(len_est - len_gt) / len_gt


@pytest.fixture(scope="module")
def rendered():
    return synthetic.render_sequence(
        n_frames=30, width=320, height=240, fx=260.0, fy=260.0,
        fps=10.0, seed=2, plane_depths=(5.0, 8.0), traj_scale=1.4,
        stereo_baseline=BASELINE)


def test_port_e2e_stereo_metric_scale(rendered, tmp_path, two_threads):
    imgs_l, imgs_r, R_gt, t_gt, ts = rendered
    sys_ = System(None, SETTINGS, Sensor.STEREO,
                  device="cpu")
    assert not sys_._stereo_right_raw  # the rectified scanline path
    for k in range(imgs_l.shape[0]):
        T = sys_.track_stereo(imgs_l[k], imgs_r[k], float(ts[k]))
        assert T.shape == (4, 4) and np.isfinite(T).all()
    assert sys_.get_tracking_state() == TrackingState.OK
    assert int(sys_.map.n_kf) >= 3
    assert len(sys_.kf_times) == int(sys_.map.n_kf)
    est, gt = centres(sys_, R_gt, t_gt)
    assert len(est) > 15
    err = length_error(est, gt)
    assert err < 0.12, err
    ate = synthetic.ate_rmse(est, gt, align=True)
    assert ate < 0.08, f"stereo ATE {ate:.4f} m"
