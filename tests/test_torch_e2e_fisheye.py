"""End-to-end KannalaBrandt8 fisheye through the port's System, on the
rendered clips and bounds of `tests/test_e2e_fisheye.py`: fisheye mono
(`track_monocular`; at least n - 8 tracked frames, Sim3-aligned ATE under
0.08 m) and fisheye stereo through the general two-view rig
(`track_stereo`; at least n - 8 tracked, ATE under 0.10 m, the unaligned
trajectory length within 10%). The settings are the JAX test's. The mono run draws its initializer's samples as the JAX
System does for the same frame (`test_torch_e2e_mono.jax_draws`).

The frames come from the JAX package's renderer, so the port is held on
the JAX test's own clip. The port's copy of the renderer differs from it by
1 gray level at some pixels (its rays come from the port's `unproject`,
which rounds differently in the last bit), and on this short clip that is
enough to move the stereo length ratio by several percent in both
packages."""

import pytest

from orb_slam3_ros2_tpu.io import synthetic as jsynthetic
from orb_slam3_ros2_tpu_torch.io import synthetic
from orb_slam3_ros2_tpu_torch.runtime.system import (Sensor, System,
                                                     TrackingState)
from tests.test_e2e_fisheye import _cam, _settings_file
from tests.test_torch_e2e_mono import jax_draws  # noqa: F401  (fixture)
from tests.test_torch_e2e_stereo import (centres, length_error,
                                         two_threads)  # noqa: F401


@pytest.mark.slow
def test_port_e2e_fisheye_mono_tracks_rendered_kb8(
        tmp_path, two_threads, jax_draws):  # noqa: F811
    n = 25
    images, R_gt, t_gt, ts = jsynthetic.render_room_sequence_kb8(
        n_frames=n, cam=_cam(), fps=10.0, seed=2, traj_scale=0.8,
        noise_dn=2.0)
    sys_ = System(None, _settings_file(str(tmp_path)),
                  Sensor.MONOCULAR, device="cpu")
    for k in range(n):
        sys_.track_monocular(images[k], float(ts[k]))
    assert jax_draws  # the initializer ran on the JAX System's samples
    assert sys_.get_tracking_state() == TrackingState.OK
    est, gt = centres(sys_, R_gt, t_gt)
    assert len(est) >= n - 8
    ate = synthetic.ate_rmse(est, gt)
    assert ate < 0.08, ate


@pytest.mark.slow
def test_port_e2e_fisheye_stereo_metric_scale(tmp_path,
                                              two_threads):  # noqa: F811
    n = 22
    baseline = 0.11
    images, images_r, R_gt, t_gt, ts = jsynthetic.render_room_sequence_kb8(
        n_frames=n, cam=_cam(), fps=10.0, seed=4, traj_scale=0.8,
        noise_dn=2.0, stereo_baseline=baseline)
    sys_ = System(None, _settings_file(str(tmp_path), baseline=baseline),
                  Sensor.STEREO, device="cpu")
    assert sys_._stereo_right_raw  # the general two-view path
    for k in range(n):
        sys_.track_stereo(images[k], images_r[k], float(ts[k]))
    assert sys_.get_tracking_state() == TrackingState.OK
    est, gt = centres(sys_, R_gt, t_gt)
    assert len(est) >= n - 8
    ate = synthetic.ate_rmse(est, gt)
    assert ate < 0.10, ate
    err = length_error(est, gt)
    assert err < 0.10, err
