"""The port's synthetic evaluation cases (`runtime/bench_eval.py`) against
the JAX ones. The synthetic case runs at `tests/test_hard_render.py`'s
size on the CPU and meets that test's bars with the JAX row's keys; the
`slow` tests hold it to the JAX row on the same case, and run the
loop-closure case (at 320x240) and the fisheye stereo case (on the JAX
renderer's frames: the port's KB8 renderer is 1 gray level off at some
pixels, ROADMAP.md §3) in both packages."""

import numpy as np
import pytest

from orb_slam3_ros2_tpu.io import synthetic as jsynthetic
from orb_slam3_ros2_tpu.runtime import bench_eval as jbench
from orb_slam3_ros2_tpu_torch.io import synthetic
from orb_slam3_ros2_tpu_torch.runtime import bench_eval
from tests.test_torch_e2e_stereo import two_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_threads")

CI_HARD = dict(name="ci_hard", mode="mono", n_frames=18, hard=True, seed=0,
               width=320, height=240, fx=260.0, n_features=600, n_levels=4,
               traj_scale=0.8)
# the keys of the JAX row for a monocular case that tracked
MONO_ROW = {"sequence", "mode", "ate_rmse_m", "kf_ate_rmse_m",
            "tracked_frames", "frames", "wall_s", "fps", "fps_steady",
            "frame_ms_p95", "frame_ms_max", "frames_over_33ms", "status"}


def _hard_bars(row):
    assert row["status"] == "ok", row
    assert row["tracked_frames"] >= 12, row
    assert row["ate_rmse_m"] < 0.12, row


def test_settings_template_and_imu_constants_equal_jax(tmp_path):
    assert bench_eval._SETTINGS_TMPL == jbench._SETTINGS_TMPL
    assert bench_eval.IMU_KW == jbench.IMU_KW
    a = bench_eval._write_settings(str(tmp_path), 320, 240, 260.0, 260.0,
                                   10.0, 0.1, 600, 4)
    text = open(a).read()
    b = jbench._write_settings(str(tmp_path), 320, 240, 260.0, 260.0, 10.0,
                               0.1, 600, 4)
    assert text == open(b).read()
    ts = np.linspace(0.0, 28.0, 50)
    for x, y in zip(bench_eval._loop_trajectory(280, 10.0).pose_wb(ts),
                    jbench._loop_trajectory(280, 10.0).pose_wb(ts)):
        assert np.array_equal(x, y)


def test_synthetic_case_meets_the_hard_render_bars():
    row = bench_eval.run_synthetic_case(dict(CI_HARD, device="cpu"))
    assert set(row) == MONO_ROW
    _hard_bars(row)
    assert row["frames"] == 18 and row["sequence"] == "ci_hard"


@pytest.mark.slow
def test_synthetic_case_equals_the_jax_row():
    row = bench_eval.run_synthetic_case(dict(CI_HARD, device="cpu"))
    ref = jbench.run_synthetic_case(dict(CI_HARD))
    assert set(row) == set(ref)
    for r in (row, ref):
        _hard_bars(r)
    assert abs(row["ate_rmse_m"] - ref["ate_rmse_m"]) < 0.05


@pytest.mark.slow
def test_loop_closure_case_in_both_packages():
    case = dict(name="synth_loopy", width=320, height=240)
    row = bench_eval.run_loop_closure_case(dict(case, device="cpu"))
    ref = jbench.run_loop_closure_case(case)
    assert set(row) == set(ref)
    assert row["status"] == ref["status"] == "ok"
    assert row["frames"] == ref["frames"] == 280
    assert np.isfinite(row["ate_rmse_m"]) and np.isfinite(
        row["ate_loop_off_m"])


@pytest.mark.slow
def test_fisheye_stereo_case_on_the_jax_frames(monkeypatch):
    from orb_slam3_ros2_tpu.models import cameras as jcameras

    def jax_render(n_frames, cam, **kw):
        jcam = jcameras.make_camera(
            "KannalaBrandt8", cam.fx, cam.fy, cam.cx, cam.cy,
            dist=tuple(cam.params[4:8]), width=cam.width, height=cam.height)
        return jsynthetic.render_room_sequence_kb8(n_frames=n_frames,
                                                   cam=jcam, **kw)

    monkeypatch.setattr(synthetic, "render_room_sequence_kb8", jax_render)
    case = dict(name="synth_kb8_stereo", n_frames=22)
    row = bench_eval.run_fisheye_stereo_case(dict(case, device="cpu"))
    ref = jbench.run_fisheye_stereo_case(case)
    assert set(row) == set(ref)
    assert row["status"] == ref["status"] == "ok"
    assert row["tracked_frames"] >= 22 - 8
    assert row["ate_rmse_m"] < 0.10, row
