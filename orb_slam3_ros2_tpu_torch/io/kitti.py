"""KITTI odometry dataset loader.

The reference ships monocular KITTI settings for every sequence group
(`config/Monocular/KITTI00-02.yaml`, `KITTI03.yaml`,
`KITTI04-12.yaml` — 2000 ORB features, 10 FPS) and stereo variants under
`config/Stereo/`; upstream ORB-SLAM3 validates on the KITTI odometry
benchmark with this layout [upstream].

Layout handled (odometry gray/color):
    <root>/sequences/<seq>/times.txt          per-frame timestamp [s]
    <root>/sequences/<seq>/image_0/<k>.png    left gray
    <root>/sequences/<seq>/image_1/<k>.png    right gray
    <root>/poses/<seq>.txt                    GT: 12 vals/row, T_w_cam flat 3x4
(also accepts pointing `root` directly at a sequence directory).

Copied from `orb_slam3_ros2_tpu/io/kitti.py` (numpy only), over the port's
`io/euroc.py` types.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from orb_slam3_ros2_tpu_torch.io.euroc import EurocSequence, Frame


def load_sequence(
    root: str, sequence: Optional[str] = None, stereo: bool = False
) -> EurocSequence:
    """Load a KITTI odometry sequence into the common replay container.

    KITTI has no IMU in the odometry benchmark, so the IMU arrays are empty;
    groundtruth (when the poses file exists) is converted to positions.
    """
    if sequence is not None:
        seq_dir = os.path.join(root, "sequences", sequence)
        poses_path = os.path.join(root, "poses", f"{sequence}.txt")
    else:
        seq_dir = root
        name = os.path.basename(os.path.normpath(root))
        poses_path = os.path.join(root, "..", "..", "poses", f"{name}.txt")

    times = np.loadtxt(os.path.join(seq_dir, "times.txt"), dtype=np.float64)
    times = np.atleast_1d(times)

    img_dir = os.path.join(seq_dir, "image_0")
    right_dir = os.path.join(seq_dir, "image_1")
    frames = []
    for k, t in enumerate(times):
        p = os.path.join(img_dir, f"{k:06d}.png")
        pr = os.path.join(right_dir, f"{k:06d}.png") if stereo else None
        frames.append(Frame(t=float(t), path=p, path_right=pr))

    gt_t = gt_p = None
    if os.path.isfile(poses_path):
        P = np.loadtxt(poses_path, dtype=np.float64).reshape(-1, 3, 4)
        n = min(len(P), len(times))
        gt_t = times[:n]
        gt_p = P[:n, :, 3]  # camera position in world (T_w_cam translation)

    return EurocSequence(
        frames=frames,
        imu_t=np.zeros((0,)),
        imu_gyro=np.zeros((0, 3)),
        imu_acc=np.zeros((0, 3)),
        gt_t=gt_t, gt_p=gt_p, gt_q=None,
    )
