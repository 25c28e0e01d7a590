"""EuRoC MAV dataset loader (ASL format; TUM-VI has the same layout) and
the replay entry point that EuRoC mono-inertial users run.

Copied from `orb_slam3_ros2_tpu/io/euroc.py` (numpy only); the one change
is that `run_slam_on_sequence` builds the port's `ImuPoint`. Frames are
read with cv2 when they are loaded.

Layout handled (mav0 convention):
    <root>/mav0/cam0/data.csv            timestamp [ns], filename
    <root>/mav0/cam0/data/<stamp>.png
    <root>/mav0/cam1/...                 (stereo right)
    <root>/mav0/imu0/data.csv            t[ns], wx, wy, wz, ax, ay, az
    <root>/mav0/state_groundtruth_estimate0/data.csv  (position cols 1-3)
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Frame:
    t: float
    path: str
    path_right: Optional[str] = None

    def load(self) -> np.ndarray:
        import cv2

        img = cv2.imread(self.path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(self.path)
        return img.astype(np.float32)


@dataclasses.dataclass
class EurocSequence:
    frames: List[Frame]
    imu_t: np.ndarray  # (M,) seconds
    imu_gyro: np.ndarray  # (M, 3)
    imu_acc: np.ndarray  # (M, 3)
    gt_t: Optional[np.ndarray]  # (G,) seconds
    gt_p: Optional[np.ndarray]  # (G, 3) positions
    gt_q: Optional[np.ndarray]  # (G, 4) quaternions (w, x, y, z)

    def imu_between(self, t0: float, t1: float):
        """All samples with t0 < t <= t1 (the TrackMonocular contract)."""
        sel = (self.imu_t > t0) & (self.imu_t <= t1)
        return self.imu_t[sel], self.imu_gyro[sel], self.imu_acc[sel]

    def gt_at(self, t: float) -> Optional[np.ndarray]:
        if self.gt_t is None or len(self.gt_t) == 0:
            return None
        i = int(np.searchsorted(self.gt_t, t).clip(0, len(self.gt_t) - 1))
        return self.gt_p[i]


def _read_csv(path: str) -> List[List[str]]:
    rows = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            rows.append(row)
    return rows


def load_sequence(root: str, stereo: bool = False) -> EurocSequence:
    mav = os.path.join(root, "mav0")
    if not os.path.isdir(mav):
        mav = root  # allow pointing directly at mav0

    cam0 = os.path.join(mav, "cam0")
    rows = _read_csv(os.path.join(cam0, "data.csv"))
    frames = []
    for r in rows:
        t = float(r[0]) * 1e-9
        p = os.path.join(cam0, "data", r[1].strip())
        pr = None
        if stereo:
            pr = os.path.join(mav, "cam1", "data", r[1].strip())
        frames.append(Frame(t=t, path=p, path_right=pr))

    imu_path = os.path.join(mav, "imu0", "data.csv")
    if os.path.isfile(imu_path) and (rows := _read_csv(imu_path)):
        arr = np.asarray(rows, dtype=np.float64)
        imu_t = arr[:, 0] * 1e-9
        imu_gyro = arr[:, 1:4]
        imu_acc = arr[:, 4:7]
    else:
        imu_t = np.zeros((0,))
        imu_gyro = np.zeros((0, 3))
        imu_acc = np.zeros((0, 3))

    gt_t = gt_p = gt_q = None
    gt_path = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
    if os.path.isfile(gt_path):
        arr = np.asarray(_read_csv(gt_path), dtype=np.float64)
        gt_t = arr[:, 0] * 1e-9
        gt_p = arr[:, 1:4]
        gt_q = arr[:, 4:8] if arr.shape[1] >= 8 else None

    return EurocSequence(
        frames=frames, imu_t=imu_t, imu_gyro=imu_gyro, imu_acc=imu_acc,
        gt_t=gt_t, gt_p=gt_p, gt_q=gt_q,
    )


def run_slam_on_sequence(
    system,
    seq: EurocSequence,
    max_frames: Optional[int] = None,
    use_imu: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Replay a sequence through a System; returns (est_centers, gt_positions)
    for frames where groundtruth exists (ATE evaluation protocol)."""
    from orb_slam3_ros2_tpu_torch.runtime.system import ImuPoint

    est, gt = [], []
    t_prev = None
    frames = seq.frames[: max_frames or len(seq.frames)]
    for fr in frames:
        imu_points = []
        if use_imu and t_prev is not None:
            ts, gs, accs = seq.imu_between(t_prev, fr.t)
            imu_points = [
                ImuPoint(a, g, t) for t, g, a in zip(ts, gs, accs)
            ]
        T = system.track_monocular(fr.load(), fr.t, imu_points)
        t_prev = fr.t
        g = seq.gt_at(fr.t)
        if g is not None and system.get_tracking_state().value == 1:
            R, t = T[:3, :3], T[:3, 3]
            est.append(-R.T @ t)
            gt.append(g)
    return np.asarray(est), np.asarray(gt)
