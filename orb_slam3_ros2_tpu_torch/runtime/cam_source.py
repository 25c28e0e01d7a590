"""Live camera sources + CameraInfo — host-ingest parity layer.

Covers two reference components:

* `cam_node.py` (`cam_node.py`): an RTSP camera publisher at
  30 FPS with fixed intrinsics/distortion that *prepares* undistort-rectify
  maps (:37) but then publishes the raw frame anyway (:67). Here
  `OpenCVCameraSource` is the equivalent source abstraction (RTSP URL /
  device index / video file via `cv2.VideoCapture`) and — fixing that bug —
  actually applies the rectification maps when distortion is present,
  emitting frames that match its advertised rectified CameraInfo.
* `orb_camera_info_node` (`src/orb_camera_info.cpp:21-39`):
  builds a `sensor_msgs/CameraInfo` from the SLAM settings YAML's
  `Camera1.{fx,fy,cx,cy,k1,k2,p1,p2[,k3]}` keys so downstream consumers
  (rtabmap in the reference) see calibrated intrinsics.
  `camera_info_from_settings` is that node's pure function; the ROS shim in
  `runtime.ros_bridge` publishes it on a timer where rclpy exists.

No ROS types are used — CameraInfo is a plain dataclass with the same field
names/semantics as `sensor_msgs/CameraInfo` so a bridge can copy it across
one-to-one.

Copied from `orb_slam3_ros2_tpu/runtime/cam_source.py` (numpy; cv2 for
the source), with the port's `io/settings.py` and `models/cameras.py`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class CameraInfo:
    """sensor_msgs/CameraInfo equivalent (plumb_bob / equidistant)."""

    width: int
    height: int
    distortion_model: str  # "plumb_bob" | "equidistant" | ""
    d: np.ndarray  # (N,) distortion coefficients
    k: np.ndarray  # (3, 3) intrinsics
    r: np.ndarray  # (3, 3) rectification
    p: np.ndarray  # (3, 4) projection

    @property
    def is_distorted(self) -> bool:
        return bool(np.any(np.abs(self.d) > 0))


def camera_info_from_settings(settings_path: str) -> CameraInfo:
    """Settings YAML → CameraInfo (orb_camera_info_node equivalent).

    Reads the same key families the reference node does
    (`src/orb_camera_info.cpp:21-39`): Camera1 intrinsics + radtan
    distortion for PinHole, k1..k4 equidistant for KannalaBrandt8, zeros
    for Rectified.
    """
    from orb_slam3_ros2_tpu_torch.io.settings import load_settings
    from orb_slam3_ros2_tpu_torch.models.cameras import CameraModel

    s = load_settings(settings_path)
    cam = s.camera
    fx, fy, cx, cy = (float(v) for v in cam.params[:4])
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    if cam.model == CameraModel.KANNALA_BRANDT8:
        model = "equidistant"
        d = np.asarray(cam.params[4:8], np.float64)
    elif cam.model == CameraModel.PINHOLE:
        model = "plumb_bob"
        d = np.asarray(cam.params[4:9], np.float64)  # k1 k2 p1 p2 k3
    else:  # Rectified
        model = "plumb_bob"
        d = np.zeros(5)
    P = np.hstack([K, np.zeros((3, 1))])
    return CameraInfo(width=cam.width, height=cam.height,
                      distortion_model=model, d=d, k=K,
                      r=np.eye(3), p=P)


def rectified_info(info: CameraInfo) -> CameraInfo:
    """CameraInfo for the rectified stream (distortion folded away)."""
    return CameraInfo(width=info.width, height=info.height,
                      distortion_model="plumb_bob", d=np.zeros(5),
                      k=info.k.copy(), r=np.eye(3), p=info.p.copy())


class OpenCVCameraSource:
    """cv2.VideoCapture-backed frame source (RTSP / device / file).

    `cam_node.py` equivalent: yields (mono8 frame, timestamp) at the
    source's native rate; when `info` carries distortion, frames are
    undistort-rectified with precomputed maps (cv2.initUndistortRectifyMap,
    as `cam_node.py:37` prepares — and, unlike the reference's :67 bypass,
    actually applied) so the emitted stream matches `rectified_info`.
    """

    def __init__(self, source, info: Optional[CameraInfo] = None,
                 rectify: bool = True):
        import cv2

        self._cv2 = cv2
        self.cap = cv2.VideoCapture(source)
        if not self.cap.isOpened():
            raise RuntimeError(f"cannot open camera source: {source!r}")
        self.info = info
        self._maps = None
        if info is not None and rectify and info.is_distorted:
            if info.distortion_model == "equidistant":
                self._maps = cv2.fisheye.initUndistortRectifyMap(
                    info.k, info.d[:4], info.r, info.p[:, :3],
                    (info.width, info.height), cv2.CV_16SC2,
                )
            else:
                self._maps = cv2.initUndistortRectifyMap(
                    info.k, info.d, info.r, info.p[:, :3],
                    (info.width, info.height), cv2.CV_16SC2,
                )

    def read(self) -> Optional[Tuple[np.ndarray, float]]:
        ok, frame = self.cap.read()
        if not ok:
            return None
        t = time.time()
        if frame.ndim == 3:
            frame = self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2GRAY)
        if self._maps is not None:
            frame = self._cv2.remap(frame, self._maps[0], self._maps[1],
                                    self._cv2.INTER_LINEAR)
        return frame, t

    def frames(self) -> Iterator[Tuple[np.ndarray, float]]:
        while True:
            out = self.read()
            if out is None:
                return
            yield out

    def release(self) -> None:
        self.cap.release()
