"""The port's aprilgrid calibration against the JAX one
(`orb_slam3_ros2_tpu/io/calibrate.py`, `tests/test_calibrate.py`): on the
same rendered views both detect the same corners (exactly) and solve the
same intrinsics: `cv2.calibrateCamera` is not bit-reproducible from call to
call, so the solve is held to 1e-7 relative. The KannalaBrandt8 solve
raises in both packages with OpenCV 5 (`cv2.fisheye` has no `CALIB_*`
constants; ROADMAP.md §3), so only the PinHole model is compared."""

import dataclasses

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from orb_slam3_ros2_tpu.io import calibrate as jcal  # noqa: E402
from orb_slam3_ros2_tpu_torch.io import calibrate as cal  # noqa: E402
from tests.test_calibrate import _board, _render_view  # noqa: E402


def _views(spec, n=8, seed=0):
    board, mpp, origin_px = _board(spec)
    K = np.array([[420.0, 0, 330.0], [0, 410.0, 230.0], [0, 0, 1.0]])
    rng = np.random.default_rng(seed)
    tilts = [(0.0, 0.0), (0.45, 0.0), (-0.45, 0.0), (0.0, 0.45),
             (0.0, -0.45), (0.35, 0.35), (-0.35, 0.35), (0.35, -0.35)][:n]
    views = []
    for ax, ay in tilts:
        rvec = np.array([ax, ay, rng.normal(0, 0.1)])
        tvec = np.array([-0.22 + rng.normal(0, 0.05),
                         -0.17 + rng.normal(0, 0.05),
                         0.75 + rng.uniform(-0.1, 0.25)])
        views.append(_render_view(board, mpp, origin_px, K, rvec, tvec,
                                  (640, 480)))
    return views


def test_spec_and_detection_equal_jax(tmp_path):
    p = tmp_path / "aprilgrid.yaml"
    p.write_text("target_type: 'aprilgrid'\ntagCols: 4\ntagRows: 3\n"
                 "tagSize: 0.08\ntagSpacing: 0.3\n")
    spec, jspec = cal.AprilGridSpec.load(str(p)), jcal.AprilGridSpec.load(
        str(p))
    assert dataclasses.astuple(spec) == dataclasses.astuple(jspec)
    for tid in range(12):
        assert np.array_equal(spec.tag_corners_world(tid),
                              jspec.tag_corners_world(tid))
    view = _views(spec, n=2)[1]
    obj, im = cal.detect_grid(view, spec)
    jobj, jim = jcal.detect_grid(view, jspec)
    assert len(obj) >= 24
    assert np.array_equal(obj, jobj) and np.array_equal(im, jim)


@pytest.mark.parametrize("fix", [False, True])
def test_calibration_equals_jax(fix):
    model = "PinHole"
    spec = cal.AprilGridSpec(cols=4, rows=3, tag_size=0.08, tag_spacing=0.3)
    jspec = jcal.AprilGridSpec(cols=4, rows=3, tag_size=0.08,
                               tag_spacing=0.3)
    views = _views(spec)
    res = cal.calibrate(views, spec, model=model, fix_distortion=fix)
    ref = jcal.calibrate(views, jspec, model=model, fix_distortion=fix)
    assert res is not None and ref is not None
    assert (res.model, res.n_views) == (ref.model, ref.n_views)
    for f in ("fx", "fy", "cx", "cy", "rms_px"):
        assert getattr(res, f) == pytest.approx(getattr(ref, f), rel=1e-7), f
    np.testing.assert_allclose(res.dist, ref.dist, rtol=1e-6, atol=1e-9)
    assert abs(res.fx - 420.0) / 420.0 < 0.02
    assert cal.calibrate(views[:2], spec) is None
