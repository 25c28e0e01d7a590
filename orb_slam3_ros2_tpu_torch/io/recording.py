"""Sequence record / replay — the rosbag + calibration-recorder parity layer.

The reference offers two ways to capture raw sensor streams for later replay:

* rosbag record/playback wired into the launch file
  (`launch/mapping.launch.py:54-71` declares
  `record_bag`/`playback_bag`/`bag_name` args; :167-213 spawns
  `ros2 bag play/record`) — replaying a recorded session through the SLAM
  node is the de-facto validation loop (`README.md:76-93`).
* raw calibration recorders writing `cam0/times.txt` plus per-frame PNGs and
  `IMU/{acc,gyro}.txt` at native (mismatched) rates
  (`config/Calibration/recorder_realsense_D435i.cc:152-155`), post-processed
  by a gyro-rate accel-interpolation script into a EuRoC-format `imu0.csv`
  (`config/Calibration/python_scripts/process_imu.py:77-109,130-144`).

Here both become plain-file recorders with a shared replay path: recordings
are written in the EuRoC mav0 layout that `io.euroc.load_sequence` already
reads, so `run_slam.py --dataset <recording>` replays any capture verbatim
(images are lossless PNG; IMU kept at full rate). `RawRecorder` +
`process_raw_recording` reproduce the calibration pipeline's raw layout and
its interpolation convention exactly.

Copied from `orb_slam3_ros2_tpu/io/recording.py` (numpy; cv2 writes the
PNGs), over the port's `io/imu_sync.py`. The replay runner is the port's
`tools/run_slam.py` (`--dataset <recording>`).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from orb_slam3_ros2_tpu_torch.io.imu_sync import (
    EUROC_IMU_HEADER,
    interpolate_acc_at_gyro,
)


def _write_png(path: str, img: np.ndarray) -> None:
    import cv2

    cv2.imwrite(path, np.asarray(img, np.uint8))


class SequenceRecorder:
    """Records an image+IMU stream into an EuRoC mav0-layout directory.

    Functional equivalent of `ros2 bag record` on the camera/IMU topics
    (`launch/mapping.launch.py:191-213`): everything needed to re-run the
    exact session offline. Groundtruth (when the source has it, e.g. a
    synthetic render) is written in the EuRoC state_groundtruth layout so
    ATE evaluation works on replay too.
    """

    def __init__(self, root: str, stereo: bool = False):
        self.root = root
        self.stereo = stereo
        self._cam_rows = []  # (ns, filename)
        self._imu_rows = []  # (ns, wx, wy, wz, ax, ay, az)
        self._gt_rows = []  # (ns, px, py, pz, qw, qx, qy, qz)
        self._dirs = [os.path.join(root, "mav0", "cam0", "data")]
        if stereo:
            self._dirs.append(os.path.join(root, "mav0", "cam1", "data"))
        for d in self._dirs:
            os.makedirs(d, exist_ok=True)

    def add_frame(self, img: np.ndarray, t: float,
                  img_right: Optional[np.ndarray] = None) -> None:
        ns = int(round(t * 1e9))
        name = f"{ns}.png"
        _write_png(os.path.join(self._dirs[0], name), img)
        has_right = self.stereo and img_right is not None
        if has_right:
            _write_png(os.path.join(self._dirs[1], name), img_right)
        self._cam_rows.append((ns, name, has_right))

    def add_imu(self, t: float, gyro, acc) -> None:
        g, a = np.asarray(gyro, np.float64), np.asarray(acc, np.float64)
        self._imu_rows.append(
            (int(round(t * 1e9)), g[0], g[1], g[2], a[0], a[1], a[2])
        )

    def add_groundtruth(self, t: float, p, q_wxyz=(1.0, 0.0, 0.0, 0.0)):
        p = np.asarray(p, np.float64)
        q = np.asarray(q_wxyz, np.float64)
        self._gt_rows.append((int(round(t * 1e9)),) + tuple(p) + tuple(q))

    def close(self) -> str:
        mav = os.path.join(self.root, "mav0")
        with open(os.path.join(mav, "cam0", "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for ns, name, _ in self._cam_rows:
                f.write(f"{ns},{name}\n")
        if self.stereo:
            # only frames whose right image was actually captured — a csv
            # row without its PNG would break replay
            with open(os.path.join(mav, "cam1", "data.csv"), "w") as f:
                f.write("#timestamp [ns],filename\n")
                for ns, name, has_right in self._cam_rows:
                    if has_right:
                        f.write(f"{ns},{name}\n")
        imu_dir = os.path.join(mav, "imu0")
        os.makedirs(imu_dir, exist_ok=True)
        with open(os.path.join(imu_dir, "data.csv"), "w") as f:
            f.write(EUROC_IMU_HEADER + "\n")
            for row in self._imu_rows:
                f.write(",".join(str(v) for v in row) + "\n")
        if self._gt_rows:
            gt_dir = os.path.join(mav, "state_groundtruth_estimate0")
            os.makedirs(gt_dir, exist_ok=True)
            with open(os.path.join(gt_dir, "data.csv"), "w") as f:
                f.write("#timestamp,px,py,pz,qw,qx,qy,qz\n")
                for row in self._gt_rows:
                    f.write(",".join(str(v) for v in row) + "\n")
        return self.root


class RawRecorder:
    """Raw calibration-capture layout: `cam0/times.txt` + PNG frames and
    `IMU/{acc,gyro}.txt` at native rates — byte-layout parity with the
    reference recorders (`config/Calibration/recorder_realsense_D435i.cc:
    152-155`: times.txt rows `<index> <t_seconds>`, IMU rows
    `<t_ns> x y z`)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "cam0", "data"), exist_ok=True)
        os.makedirs(os.path.join(root, "IMU"), exist_ok=True)
        self._times = []
        self._acc = []
        self._gyro = []

    def add_frame(self, img: np.ndarray, t: float) -> None:
        idx = len(self._times)
        _write_png(os.path.join(self.root, "cam0", "data", f"{idx}.png"), img)
        self._times.append((idx, t))

    def add_acc(self, t: float, acc) -> None:
        a = np.asarray(acc, np.float64)
        self._acc.append((int(round(t * 1e9)), a[0], a[1], a[2]))

    def add_gyro(self, t: float, gyro) -> None:
        g = np.asarray(gyro, np.float64)
        self._gyro.append((int(round(t * 1e9)), g[0], g[1], g[2]))

    def close(self) -> str:
        with open(os.path.join(self.root, "cam0", "times.txt"), "w") as f:
            for idx, t in self._times:
                f.write(f"{idx} {t:.9f}\n")
        for name, rows in (("acc", self._acc), ("gyro", self._gyro)):
            with open(os.path.join(self.root, "IMU", f"{name}.txt"), "w") as f:
                for row in rows:
                    f.write(" ".join(str(v) for v in row) + "\n")
        return self.root


def process_raw_recording(raw_root: str, out_root: str) -> str:
    """Raw capture → EuRoC sequence (`process_imu.py` parity: accel linearly
    interpolated at gyro timestamps, EuRoC imu0.csv columns; cam frames
    re-indexed by nanosecond timestamp)."""
    import shutil

    acc = np.loadtxt(os.path.join(raw_root, "IMU", "acc.txt"), ndmin=2)
    gyro = np.loadtxt(os.path.join(raw_root, "IMU", "gyro.txt"), ndmin=2)
    t, g, a = interpolate_acc_at_gyro(
        gyro[:, 0] * 1e-9, gyro[:, 1:4], acc[:, 0] * 1e-9, acc[:, 1:4]
    )

    rec = SequenceRecorder(out_root)
    for ti, gi, ai in zip(t, g, a):
        rec.add_imu(ti, gi, ai)
    times = np.loadtxt(os.path.join(raw_root, "cam0", "times.txt"), ndmin=2)
    cam_dir = os.path.join(out_root, "mav0", "cam0", "data")
    for idx, ti in times:
        ns = int(round(ti * 1e9))
        src = os.path.join(raw_root, "cam0", "data", f"{int(idx)}.png")
        shutil.copyfile(src, os.path.join(cam_dir, f"{ns}.png"))
        rec._cam_rows.append((ns, f"{ns}.png", False))
    return rec.close()
