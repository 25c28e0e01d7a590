"""Host-side output products (E14/E15): point-cloud filtering, occupancy
grid, PCD/PGM artifacts, annotated video.

Replicates the wrapper's post-processing with identical parameters:

* statistical outlier removal meanK=100 σ=0.1 then radius filter r=0.1 m
  minNeighbors=5 — `src/imu_mono_realsense.cpp:189-213`
* point-cloud → occupancy grid at 0.05 m/cell, occupied=100
  — :215-269; grid YAML thresholds occupied 0.65 / free 0.196
  — :163-169 and `occupancy_grids/2024-11-03_01-41-25.yaml:1-7`
* artifacts saved on shutdown: `<out>/cloud/<name>.pcd`,
  `<out>/grid/<name>.{pgm,yaml}` — :158-170
* annotated tracking video, mp4v 30 FPS — :174-185 (fed by
  `getPrettyFrame`, :340-341)

Copied from `orb_slam3_ros2_tpu/runtime/outputs.py` (numpy, scipy and cv2;
no JAX), with the same native library, `native/libtpuslam_native.so`,
loaded by the same path relative to this file. The reference paths above
are those of the ROS 2 wrapper the JAX package was built from.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def _native_filter():
    """ctypes handle for native/pcl_filters.cpp (None if lib unavailable)."""
    global _NATIVE_FILTER
    if "_NATIVE_FILTER" not in globals():
        import ctypes

        _NATIVE_FILTER = None
        for p in (os.path.join(os.path.dirname(__file__), "..", "..",
                               "native", "libtpuslam_native.so"),
                  "libtpuslam_native.so"):
            try:
                lib = ctypes.CDLL(os.path.abspath(p))
            except OSError:
                continue
            lib.pcl_filter.restype = ctypes.c_int
            lib.pcl_filter.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            _NATIVE_FILTER = lib
            break
    return _NATIVE_FILTER


def filter_point_cloud(
    pts: np.ndarray,
    sor_mean_k: int = 100,
    sor_stddev: float = 0.1,
    radius: float = 0.1,
    min_neighbors: int = 5,
    native: bool = True,
) -> np.ndarray:
    """SOR + radius outlier removal (PCL-parameter parity).

    Runs the native KD-tree implementation (native/pcl_filters.cpp — the
    C++ counterpart of the wrapper's PCL chain) when the library is built;
    scipy fallback otherwise, identical semantics either way."""
    if len(pts) == 0:
        return pts
    lib = _native_filter() if native else None
    if lib is not None:
        import ctypes

        p = np.ascontiguousarray(pts, np.float32)
        keep = np.zeros(len(p), np.uint8)
        n_kept = lib.pcl_filter(
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(p),
            int(sor_mean_k), float(sor_stddev), float(radius),
            int(min_neighbors),
            keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if n_kept >= 0:
            return p[keep.astype(bool)]
    from scipy.spatial import cKDTree

    tree = cKDTree(pts)
    k = min(sor_mean_k + 1, len(pts))
    d, _ = tree.query(pts, k=k)
    mean_d = d[:, 1:].mean(axis=1) if k > 1 else np.zeros(len(pts))
    mu, sigma = mean_d.mean(), mean_d.std()
    keep = mean_d <= mu + sor_stddev * sigma
    pts = pts[keep]
    if len(pts) == 0:
        return pts
    tree = cKDTree(pts)
    counts = tree.query_ball_point(pts, r=radius, return_length=True)
    return pts[np.asarray(counts) >= min_neighbors + 1]  # ball includes self


def point_cloud_to_occupancy_grid(
    pts: np.ndarray,
    resolution: float = 0.05,
    z_band: Optional[Tuple[float, float]] = None,
) -> Tuple[np.ndarray, Tuple[float, float]]:
    """Rasterize (x, y) of points into an occupancy grid.

    Returns (grid int8 with -1 unknown / 0 free / 100 occupied, origin).
    Mirrors the wrapper's rasterizer (occupied=100, data offset by min corner,
    `src/imu_mono_realsense.cpp:215-269`)."""
    if len(pts) == 0:
        return np.full((1, 1), -1, np.int8), (0.0, 0.0)
    if z_band is not None:
        pts = pts[(pts[:, 2] >= z_band[0]) & (pts[:, 2] <= z_band[1])]
        if len(pts) == 0:
            return np.full((1, 1), -1, np.int8), (0.0, 0.0)
    mn = pts[:, :2].min(axis=0)
    mx = pts[:, :2].max(axis=0)
    w = max(int(np.ceil((mx[0] - mn[0]) / resolution)) + 1, 1)
    h = max(int(np.ceil((mx[1] - mn[1]) / resolution)) + 1, 1)
    grid = np.zeros((h, w), np.int8)
    ix = ((pts[:, 0] - mn[0]) / resolution).astype(int).clip(0, w - 1)
    iy = ((pts[:, 1] - mn[1]) / resolution).astype(int).clip(0, h - 1)
    grid[iy, ix] = 100
    return grid, (float(mn[0]), float(mn[1]))


def save_pcd(path: str, pts: np.ndarray) -> None:
    """ASCII PCD v0.7 (PCL-compatible, like the wrapper's saved clouds)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(
            "# .PCD v0.7 - Point Cloud Data file format\n"
            "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
            "COUNT 1 1 1\n"
            f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {len(pts)}\nDATA ascii\n"
        )
        for p in pts:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def load_pcd(path: str) -> np.ndarray:
    pts = []
    with open(path) as f:
        data = False
        for line in f:
            if data:
                vals = line.split()
                if len(vals) >= 3:
                    pts.append([float(v) for v in vals[:3]])
            elif line.startswith("DATA"):
                data = True
    return np.asarray(pts, np.float32).reshape(-1, 3)


def save_occupancy_grid(
    path_base: str,
    grid: np.ndarray,
    origin: Tuple[float, float],
    resolution: float = 0.05,
    occupied_thresh: float = 0.65,
    free_thresh: float = 0.196,
) -> None:
    """PGM + YAML pair, byte-layout compatible with nav2 map_saver output
    (thresholds from `occupancy_grids/2024-11-03_01-41-25.yaml:1-7`)."""
    os.makedirs(os.path.dirname(path_base) or ".", exist_ok=True)
    pgm = path_base + ".pgm"
    yml = path_base + ".yaml"
    h, w = grid.shape
    img = np.where(grid == 100, 0, np.where(grid == 0, 254, 205)).astype(
        np.uint8
    )
    with open(pgm, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(img[::-1].tobytes())  # row 0 at bottom (map convention)
    with open(yml, "w") as f:
        f.write(
            f"image: {os.path.basename(pgm)}\n"
            f"mode: trinary\n"
            f"resolution: {resolution}\n"
            f"origin: [{origin[0]}, {origin[1]}, 0]\n"
            f"negate: 0\n"
            f"occupied_thresh: {occupied_thresh}\n"
            f"free_thresh: {free_thresh}\n"
        )


def annotate_frame(img: np.ndarray, uv: np.ndarray, mask: np.ndarray,
                   tracked: Optional[np.ndarray] = None) -> np.ndarray:
    """Keypoint overlay — `getPrettyFrame` parity
    (`src/imu_mono_realsense.cpp:340`)."""
    import cv2

    vis = np.asarray(img, np.uint8)
    if vis.ndim == 2:
        vis = cv2.cvtColor(vis, cv2.COLOR_GRAY2BGR)
    for i in range(len(uv)):
        if not mask[i]:
            continue
        color = (0, 255, 0) if (tracked is not None and tracked[i]) else (
            255, 180, 0)
        cv2.circle(vis, (int(uv[i, 0]), int(uv[i, 1])), 2, color, 1)
    return vis


class VideoRecorder:
    """mp4 annotated-tracking recorder (`src/imu_mono_realsense.cpp:174-185`:
    mp4v, 30 FPS)."""

    def __init__(self, path: str, fps: float = 30.0, size=(640, 500)):
        import cv2

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._size = size
        self._writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size
        )

    def write(self, frame: np.ndarray) -> None:
        import cv2

        if frame.ndim == 2:
            frame = cv2.cvtColor(frame.astype(np.uint8), cv2.COLOR_GRAY2BGR)
        frame = cv2.resize(frame, self._size)
        self._writer.write(frame)

    def close(self) -> None:
        self._writer.release()
