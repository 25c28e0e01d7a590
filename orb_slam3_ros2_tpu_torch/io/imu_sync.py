"""IMU accel/gyro synchronization: resample the accelerometer at the
gyroscope's timestamps by linear interpolation and write a EuRoC-format
`imu0.csv`, so recordings from rate-mismatched IMUs (e.g. D435i: accel
250 Hz, gyro 400 Hz) feed the engine directly.

Copied verbatim from `orb_slam3_ros2_tpu/io/imu_sync.py` (numpy only).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

EUROC_IMU_HEADER = (
    "#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
    "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],"
    "a_RS_S_z [m s^-2]"
)


def interpolate_acc_at_gyro(
    gyro_t: np.ndarray,  # (G,) seconds
    gyro: np.ndarray,  # (G, 3)
    acc_t: np.ndarray,  # (A,) seconds
    acc: np.ndarray,  # (A, 3)
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Resample accelerometer at gyro timestamps (gyro-rate convention).

    Only gyro samples inside [acc_t[0], acc_t[-1]] are kept — matching the
    reference, which skips leading gyro samples older than the first accel
    sample and stops at the last bracketing interval. Returns
    (t, gyro, acc_interp), all at gyro rate.
    """
    gyro_t = np.asarray(gyro_t, np.float64)
    acc_t = np.asarray(acc_t, np.float64)
    keep = (gyro_t >= acc_t[0]) & (gyro_t <= acc_t[-1])
    t = gyro_t[keep]
    g = np.asarray(gyro, np.float64)[keep]
    a = np.stack(
        [np.interp(t, acc_t, np.asarray(acc, np.float64)[:, i])
         for i in range(3)],
        axis=-1,
    )
    return t, g, a


def save_euroc_imu_csv(
    path: str, t: np.ndarray, gyro: np.ndarray, acc: np.ndarray
) -> None:
    """Write a EuRoC-format imu0.csv (ns timestamps, gyro then accel)."""
    with open(path, "w") as f:
        f.write(EUROC_IMU_HEADER + "\n")
        for ti, gi, ai in zip(t, gyro, acc):
            f.write(
                f"{int(round(ti * 1e9))},{gi[0]},{gi[1]},{gi[2]},"
                f"{ai[0]},{ai[1]},{ai[2]}\n"
            )
