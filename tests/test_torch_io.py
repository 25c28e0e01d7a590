"""The port's copies of the EuRoC loader and the IMU synchronization
(`io/euroc.py`, `io/imu_sync.py`) against the JAX package's, on a EuRoC
directory and IMU streams the tests write themselves."""

import numpy as np

from orb_slam3_ros2_tpu.io import euroc as jeuroc
from orb_slam3_ros2_tpu.io import imu_sync as jsync
from orb_slam3_ros2_tpu_torch.io import euroc as teuroc
from orb_slam3_ros2_tpu_torch.io import imu_sync as tsync
from orb_slam3_ros2_tpu_torch.runtime.system import ImuPoint


def _write_euroc(root, n=4):
    """mav0 with n frames at 20 Hz, a 200 Hz IMU and ground truth."""
    import cv2

    mav = root / "mav0"
    (mav / "cam0" / "data").mkdir(parents=True)
    (mav / "imu0").mkdir()
    (mav / "state_groundtruth_estimate0").mkdir()
    rng = np.random.default_rng(0)
    t0 = 1403636579758555392
    rows = []
    for k in range(n):
        stamp = t0 + k * 50_000_000
        cv2.imwrite(str(mav / "cam0" / "data" / f"{stamp}.png"),
                    rng.integers(0, 255, (24, 32), dtype=np.uint8))
        rows.append(f"{stamp},{stamp}.png")
    (mav / "cam0" / "data.csv").write_text(
        "#timestamp [ns],filename\n" + "\n".join(rows) + "\n")
    imu_t = t0 - 20_000_000 + np.arange(n * 10 + 4) * 5_000_000
    gyro = rng.normal(0, 0.1, (len(imu_t), 3))
    acc = rng.normal(0, 0.1, (len(imu_t), 3)) + [0.0, 0.0, 9.81]
    tsync.save_euroc_imu_csv(str(mav / "imu0" / "data.csv"), imu_t * 1e-9,
                             gyro, acc)
    gt = "\n".join(f"{t0 + k * 50_000_000},{k * 0.1},0,0,1,0,0,0"
                   for k in range(n))
    (mav / "state_groundtruth_estimate0" / "data.csv").write_text(
        "#t,px,py,pz,qw,qx,qy,qz\n" + gt + "\n")
    return root


def test_euroc_loader_matches_jax(tmp_path):
    root = str(_write_euroc(tmp_path))
    a, b = jeuroc.load_sequence(root), teuroc.load_sequence(root)
    assert [(f.t, f.path) for f in a.frames] == [(f.t, f.path)
                                                 for f in b.frames]
    for k in ("imu_t", "imu_gyro", "imu_acc", "gt_t", "gt_p", "gt_q"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    t0, t1 = b.frames[1].t, b.frames[2].t
    for x, y in zip(a.imu_between(t0, t1), b.imu_between(t0, t1)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(b.gt_at(t1), a.gt_at(t1))
    assert b.frames[0].load().dtype == np.float32


def test_run_slam_on_sequence_feeds_port_imu_points(tmp_path):
    """The replay hands each frame the samples in (t_prev, t] as the
    port's ImuPoint, and collects the centres of frames tracked OK."""
    seq = teuroc.load_sequence(str(_write_euroc(tmp_path)))

    class Recorder:
        def __init__(self):
            self.calls = []

        def track_monocular(self, image, t, imu):
            self.calls.append((t, imu))
            T = np.eye(4, dtype=np.float32)
            T[0, 3] = -t
            return T

        def get_tracking_state(self):
            class OK:
                value = 1
            return OK

    rec = Recorder()
    est, gt = teuroc.run_slam_on_sequence(rec, seq, use_imu=True)
    assert len(est) == len(seq.frames) and est.shape == gt.shape
    assert rec.calls[0][1] == []
    for (t_prev, _), (t, pts) in zip(rec.calls, rec.calls[1:]):
        assert pts and all(isinstance(p, ImuPoint) for p in pts)
        sel = (seq.imu_t > t_prev) & (seq.imu_t <= t)
        np.testing.assert_array_equal([p.t for p in pts], seq.imu_t[sel])
        np.testing.assert_array_equal(np.stack([p.gyro for p in pts]),
                                      seq.imu_gyro[sel])


def test_imu_sync_matches_jax(tmp_path):
    acc_t = np.arange(0.0, 1.0, 0.004)
    acc = np.stack([np.sin(acc_t), -acc_t, np.full_like(acc_t, 9.81)], -1)
    gyro_t = np.arange(-0.01, 1.01, 0.0025)
    gyro = np.stack([np.cos(gyro_t), gyro_t, gyro_t * 0.1], -1)
    for x, y in zip(jsync.interpolate_acc_at_gyro(gyro_t, gyro, acc_t, acc),
                    tsync.interpolate_acc_at_gyro(gyro_t, gyro, acc_t, acc)):
        np.testing.assert_array_equal(x, y)
    t, g, a = tsync.interpolate_acc_at_gyro(gyro_t, gyro, acc_t, acc)
    jsync.save_euroc_imu_csv(str(tmp_path / "j.csv"), t, g, a)
    tsync.save_euroc_imu_csv(str(tmp_path / "t.csv"), t, g, a)
    assert (tmp_path / "j.csv").read_text() == (tmp_path / "t.csv").read_text()
    assert tsync.EUROC_IMU_HEADER == jsync.EUROC_IMU_HEADER
