"""The port's recorders, raw-capture processing and camera source against
the JAX ones (`orb_slam3_ros2_tpu/io/recording.py`, `runtime/
cam_source.py`; `tests/test_recording.py`): the same inputs give
byte-identical directories, which both EuRoC loaders read back equal."""

import os

import numpy as np
import pytest

from orb_slam3_ros2_tpu.io import euroc as jeuroc
from orb_slam3_ros2_tpu.io import recording as jrec
from orb_slam3_ros2_tpu.runtime import cam_source as jcs
from orb_slam3_ros2_tpu_torch.io import euroc, recording
from orb_slam3_ros2_tpu_torch.runtime import cam_source

SETTINGS = os.path.join(os.path.dirname(__file__), "data", "synth_cam.yaml")
CONFIG = os.path.join(os.path.dirname(os.path.dirname(__file__)), "config")


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _record(mod, root, stereo):
    rng = np.random.default_rng(0)
    rec = mod.SequenceRecorder(root, stereo=stereo)
    for i, t in enumerate([1.0, 1.05, 1.1]):
        for k in range(4):
            ti = t - 0.05 + 0.0125 * (k + 1)
            rec.add_imu(ti, [0.1 * i, 0, k], [0, 9.81, 0.01 * k])
        img = rng.integers(0, 255, (24, 32), dtype=np.uint8)
        right = rng.integers(0, 255, (24, 32), dtype=np.uint8)
        rec.add_frame(img, t, right if i != 1 else None)
        rec.add_groundtruth(t, [i, 2 * i, 0.0])
    return rec.close()


@pytest.mark.parametrize("stereo", [False, True])
def test_sequence_recorder_byte_identical(tmp_path, stereo):
    a = _record(recording, str(tmp_path / "port"), stereo)
    b = _record(jrec, str(tmp_path / "jax"), stereo)
    assert _tree(a) == _tree(b)
    seq, ref = euroc.load_sequence(a, stereo), jeuroc.load_sequence(b, stereo)
    assert [f.t for f in seq.frames] == [f.t for f in ref.frames]
    for f, g in zip(seq.frames, ref.frames):
        assert np.array_equal(f.load(), g.load())
    for name in ("imu_t", "imu_gyro", "imu_acc", "gt_t", "gt_p", "gt_q"):
        assert np.array_equal(getattr(seq, name), getattr(ref, name))
    np.testing.assert_allclose(seq.gt_at(1.05), [1, 2, 0], atol=1e-9)


def _raw(mod, root):
    rng = np.random.default_rng(1)
    raw = mod.RawRecorder(root)
    gyro_t = np.arange(0, 0.1, 1 / 400)
    acc_t = np.arange(-0.004, 0.104, 1 / 250)
    for t in gyro_t:
        raw.add_gyro(t, [1.0, 2.0, 3.0])
    for t in acc_t:
        raw.add_acc(t, [np.sin(20 * t), np.cos(20 * t), t])
    for t in (0.0, 0.05):
        raw.add_frame(rng.integers(0, 255, (16, 16), dtype=np.uint8), t)
    return raw.close()


def test_raw_recorder_and_processing_byte_identical(tmp_path):
    a = _raw(recording, str(tmp_path / "raw_port"))
    b = _raw(jrec, str(tmp_path / "raw_jax"))
    assert _tree(a) == _tree(b)
    pa = recording.process_raw_recording(a, str(tmp_path / "proc_port"))
    pb = jrec.process_raw_recording(b, str(tmp_path / "proc_jax"))
    assert _tree(pa) == _tree(pb)
    seq = euroc.load_sequence(pa)
    assert len(seq.imu_t) == 40 and len(seq.frames) == 2


@pytest.mark.parametrize("settings", [
    SETTINGS, os.path.join(CONFIG, "Monocular", "EuRoC.yaml"),
    os.path.join(CONFIG, "Monocular", "TUM-VI.yaml")])
def test_camera_info_equals_jax(settings):
    info = cam_source.camera_info_from_settings(settings)
    ref = jcs.camera_info_from_settings(settings)
    for f in ("width", "height", "distortion_model"):
        assert getattr(info, f) == getattr(ref, f)
    for f in ("d", "k", "r", "p"):
        assert np.array_equal(getattr(info, f), getattr(ref, f))
    assert info.is_distorted == ref.is_distorted
    r, jr = cam_source.rectified_info(info), jcs.rectified_info(ref)
    assert np.array_equal(r.d, jr.d) and np.array_equal(r.p, jr.p)


def test_opencv_camera_source_equals_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    rng = np.random.default_rng(2)
    for _ in range(5):
        w.write(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
    w.release()
    info = cam_source.CameraInfo(
        width=64, height=48, distortion_model="plumb_bob",
        d=np.array([0.1, -0.05, 0.0, 0.0, 0.0]),
        k=np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]]),
        r=np.eye(3), p=np.array([[50.0, 0, 32, 0], [0, 50.0, 24, 0],
                                 [0, 0, 1, 0]]))
    for rectify in (False, True):
        src = cam_source.OpenCVCameraSource(path, info, rectify=rectify)
        ref = jcs.OpenCVCameraSource(path, info, rectify=rectify)
        got, want = list(src.frames()), list(ref.frames())
        src.release()
        ref.release()
        assert len(got) == len(want) == 5
        for (a, _), (b, _) in zip(got, want):
            assert a.shape == (48, 64) and a.dtype == np.uint8
            assert np.array_equal(a, b)
