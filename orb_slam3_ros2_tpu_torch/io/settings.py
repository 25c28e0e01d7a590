"""Settings parser: reads the reference's OpenCV-FileStorage YAML dialect
verbatim (`%YAML:1.0` directive, `!!opencv-matrix` maps, dotted flat keys
such as `Camera1.fx` or `Camera.fx`, and plain keys like `loopClosing`).

Copied from `orb_slam3_ros2_tpu/io/settings.py` (numpy and yaml only), with
one change: cameras come from the port's `models/cameras.py`. Unknown keys
are kept in `raw`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import yaml

from orb_slam3_ros2_tpu_torch.models.cameras import Camera, make_camera


def load_opencv_yaml(path: str) -> Dict:
    """Parse an OpenCV-FileStorage YAML file into a flat dict."""
    with open(path, "r") as f:
        text = f.read()
    # strip the %YAML directive (illegal for pyyaml) and opencv-matrix tags
    lines = text.splitlines()
    if lines and lines[0].startswith("%YAML"):
        lines = lines[1:]
    text = "\n".join(lines)
    text = text.replace("!!opencv-matrix", "")
    # OpenCV accepts bare scientific floats like 1.7e-4 — pyyaml does too.
    data = yaml.safe_load(text) or {}
    out = {}
    for k, v in data.items():
        if isinstance(v, dict) and "data" in v and "rows" in v:
            arr = np.asarray(v["data"], dtype=np.float64).reshape(
                int(v["rows"]), int(v["cols"])
            )
            out[k] = arr
        else:
            out[k] = v
    return out


@dataclasses.dataclass
class Settings:
    camera: Camera
    camera2: Optional[Camera]  # right camera for stereo, else None
    sensor_type: str  # inferred default; overridden by System ctor arg
    fps: float
    rgb: bool
    # stereo
    T_c1_c2: Optional[np.ndarray]  # (4, 4)
    stereo_b: float
    stereo_th_depth: float
    # ORB extractor
    n_features: int
    scale_factor: float
    n_levels: int
    ini_th_fast: int
    min_th_fast: int
    # IMU
    T_b_c1: Optional[np.ndarray]  # (4, 4)
    noise_gyro: float
    noise_acc: float
    gyro_walk: float
    acc_walk: float
    imu_frequency: float
    insert_kfs_when_lost: bool
    # system
    loop_closing: bool
    save_atlas_to_file: Optional[str]
    load_atlas_from_file: Optional[str]
    th_far_points: float
    raw: Dict


def _cam_from(d: Dict, prefix: str, cam_type: str, width: int, height: int,
              fps: float, baseline: float) -> Optional[Camera]:
    fx = d.get(f"{prefix}.fx", d.get("Camera.fx"))
    if fx is None:
        return None
    fy = d.get(f"{prefix}.fy", d.get("Camera.fy"))
    cx = d.get(f"{prefix}.cx", d.get("Camera.cx"))
    cy = d.get(f"{prefix}.cy", d.get("Camera.cy"))
    if cam_type == "KannalaBrandt8":
        dist = [d.get(f"{prefix}.k{i}", 0.0) for i in (1, 2, 3, 4)]
    elif cam_type == "PinHole":
        dist = [
            d.get(f"{prefix}.k1", 0.0), d.get(f"{prefix}.k2", 0.0),
            d.get(f"{prefix}.p1", 0.0), d.get(f"{prefix}.p2", 0.0),
            d.get(f"{prefix}.k3", 0.0),
        ]
    else:  # Rectified
        dist = []
    return make_camera(
        cam_type if cam_type != "Rectified" else "Rectified",
        fx, fy, cx, cy, dist, width, height, fps, baseline,
    )


def load_settings(path: str) -> Settings:
    d = load_opencv_yaml(path)
    cam_type = d.get("Camera.type", "PinHole")
    width = int(d.get("Camera.newWidth", d.get("Camera.width", 640)))
    height = int(d.get("Camera.newHeight", d.get("Camera.height", 480)))
    orig_w = int(d.get("Camera.width", width))
    orig_h = int(d.get("Camera.height", height))
    fps = float(d.get("Camera.fps", 30.0))
    baseline = float(d.get("Stereo.b", 0.0))

    cam1 = _cam_from(d, "Camera1", cam_type, orig_w, orig_h, fps, baseline)
    cam2 = _cam_from(d, "Camera2", cam_type, orig_w, orig_h, fps, baseline)
    if cam1 is None:
        raise ValueError(f"no camera intrinsics found in {path}")
    # image resize (Camera.newWidth/newHeight — reference rescales intrinsics)
    if (width, height) != (orig_w, orig_h):
        sx = width / orig_w
        sy = height / orig_h

        def rescale(c: Camera) -> Camera:
            return make_camera(
                {0: "PinHole", 1: "Rectified", 2: "KannalaBrandt8"}[int(c.model)],
                c.fx * sx, c.fy * sy, c.cx * sx, c.cy * sy,
                c.params[4:], width, height, fps, baseline,
            )

        cam1 = rescale(cam1)
        cam2 = rescale(cam2) if cam2 is not None else None

    has_imu = "IMU.NoiseGyro" in d
    sensor = "STEREO" if cam2 is not None or baseline > 0 else "MONOCULAR"
    if has_imu:
        sensor = "IMU_" + sensor

    return Settings(
        camera=cam1,
        camera2=cam2,
        sensor_type=sensor,
        fps=fps,
        rgb=bool(d.get("Camera.RGB", 1)),
        T_c1_c2=d.get("Stereo.T_c1_c2"),
        stereo_b=baseline,
        stereo_th_depth=float(d.get("Stereo.ThDepth", 60.0)),
        n_features=int(d.get("ORBextractor.nFeatures", 1000)),
        scale_factor=float(d.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(d.get("ORBextractor.nLevels", 8)),
        ini_th_fast=int(d.get("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(d.get("ORBextractor.minThFAST", 7)),
        T_b_c1=d.get("IMU.T_b_c1"),
        noise_gyro=float(d.get("IMU.NoiseGyro", 1.7e-4)),
        noise_acc=float(d.get("IMU.NoiseAcc", 2.0e-3)),
        gyro_walk=float(d.get("IMU.GyroWalk", 1.9e-5)),
        acc_walk=float(d.get("IMU.AccWalk", 3.0e-3)),
        imu_frequency=float(d.get("IMU.Frequency", 200.0)),
        insert_kfs_when_lost=bool(d.get("IMU.InsertKFsWhenLost", 0)),
        loop_closing=bool(d.get("loopClosing", 1)),
        save_atlas_to_file=d.get("System.SaveAtlasToFile"),
        load_atlas_from_file=d.get("System.LoadAtlasFromFile"),
        th_far_points=float(d.get("System.thFarPoints", 0.0)),
        raw=d,
    )
