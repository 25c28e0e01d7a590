"""Camera intrinsics calibration from aprilgrid captures.

Completes the calibration workflow whose capture side the reference ships
(raw recorders + aprilgrid target, `config/Calibration/`)
but whose solve it delegates to external Kalibr: detect AprilTag 36h11
corners against the grid spec, then solve intrinsics with OpenCV —
`calibrateCamera` (radtan / PinHole) or `fisheye.calibrate`
(equidistant / KannalaBrandt8) — and emit the `Camera1.*` settings keys
our parser (and the reference engine) consumes.

Copied from `orb_slam3_ros2_tpu/io/calibrate.py` (numpy and cv2).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class AprilGridSpec:
    cols: int
    rows: int
    tag_size: float  # meters
    tag_spacing: float  # fraction of tag size

    @classmethod
    def load(cls, path: str) -> "AprilGridSpec":
        vals = {}
        with open(path) as f:
            for line in f:
                line = line.split("#")[0].strip()
                if ":" in line:
                    k, v = line.split(":", 1)
                    vals[k.strip()] = v.strip().strip("'\"")
        assert vals.get("target_type") == "aprilgrid", vals
        return cls(cols=int(vals["tagCols"]), rows=int(vals["tagRows"]),
                   tag_size=float(vals["tagSize"]),
                   tag_spacing=float(vals["tagSpacing"]))

    def tag_corners_world(self, tag_id: int) -> np.ndarray:
        """(4, 3) corner positions of a tag on the z=0 target plane, in the
        detector's corner order (top-left, top-right, bottom-right,
        bottom-left of the upright tag)."""
        r, c = divmod(tag_id, self.cols)
        pitch = self.tag_size * (1.0 + self.tag_spacing)
        x0, y0 = c * pitch, r * pitch
        s = self.tag_size
        return np.array([
            [x0, y0, 0.0], [x0 + s, y0, 0.0],
            [x0 + s, y0 + s, 0.0], [x0, y0 + s, 0.0],
        ], np.float32)


def detect_grid(img: np.ndarray, spec: AprilGridSpec
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Detect grid tags in one image → (object_pts (M,3), image_pts (M,2))."""
    import cv2

    dic = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_APRILTAG_36h11)
    corners, ids, _ = cv2.aruco.ArucoDetector(dic).detectMarkers(img)
    obj, im = [], []
    if ids is not None:
        for tag_corners, tid in zip(corners, ids.ravel()):
            if tid >= spec.cols * spec.rows:
                continue
            obj.append(spec.tag_corners_world(int(tid)))
            im.append(tag_corners.reshape(4, 2))
    if not obj:
        return np.zeros((0, 3), np.float32), np.zeros((0, 2), np.float32)
    return (np.concatenate(obj).astype(np.float32),
            np.concatenate(im).astype(np.float32))


@dataclasses.dataclass
class CalibrationResult:
    model: str  # "PinHole" | "KannalaBrandt8"
    fx: float
    fy: float
    cx: float
    cy: float
    dist: np.ndarray
    rms_px: float
    n_views: int

    def settings_keys(self) -> str:
        """The Camera1.* block for a settings YAML."""
        L = [f'Camera.type: "{self.model}"',
             f"Camera1.fx: {self.fx:.6f}", f"Camera1.fy: {self.fy:.6f}",
             f"Camera1.cx: {self.cx:.6f}", f"Camera1.cy: {self.cy:.6f}"]
        if self.model == "PinHole":
            names = ["k1", "k2", "p1", "p2", "k3"]
        else:
            names = ["k1", "k2", "k3", "k4"]
        for n, v in zip(names, self.dist.ravel()):
            L.append(f"Camera1.{n}: {float(v):.8f}")
        return "\n".join(L)


def calibrate(images: List[np.ndarray], spec: AprilGridSpec,
              model: str = "PinHole",
              min_corners: int = 12,
              fix_distortion: bool = False) -> Optional[CalibrationResult]:
    """Solve intrinsics from aprilgrid views; None if < 3 usable views.

    fix_distortion pins all distortion coefficients at zero — for streams
    that are already rectified (planar-target calibration with limited
    tilt diversity otherwise trades focal length against distortion)."""
    import cv2

    obj_all, im_all = [], []
    size = None
    for img in images:
        img = np.asarray(img, np.uint8)
        size = (img.shape[1], img.shape[0])
        obj, im = detect_grid(img, spec)
        if len(obj) >= min_corners:
            obj_all.append(obj)
            im_all.append(im)
    if len(obj_all) < 3:
        return None

    if model == "KannalaBrandt8":
        obj_f = [o.reshape(-1, 1, 3).astype(np.float64) for o in obj_all]
        im_f = [i.reshape(-1, 1, 2).astype(np.float64) for i in im_all]
        K = np.eye(3)
        D = np.zeros((4, 1))
        flags = (cv2.fisheye.CALIB_RECOMPUTE_EXTRINSIC
                 | cv2.fisheye.CALIB_FIX_SKEW)
        rms, K, D, _, _ = cv2.fisheye.calibrate(
            obj_f, im_f, size, K, D, flags=flags,
            criteria=(cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER,
                      100, 1e-8),
        )
        dist = D.ravel()
    else:
        flags = 0
        if fix_distortion:
            flags = (cv2.CALIB_ZERO_TANGENT_DIST | cv2.CALIB_FIX_K1
                     | cv2.CALIB_FIX_K2 | cv2.CALIB_FIX_K3)
        rms, K, D, _, _ = cv2.calibrateCamera(obj_all, im_all, size,
                                              None, None, flags=flags)
        dist = np.zeros(5)
        dist[: min(5, D.size)] = D.ravel()[:5]
    return CalibrationResult(
        model=model, fx=float(K[0, 0]), fy=float(K[1, 1]),
        cx=float(K[0, 2]), cy=float(K[1, 2]), dist=dist,
        rms_px=float(rms), n_views=len(obj_all),
    )
