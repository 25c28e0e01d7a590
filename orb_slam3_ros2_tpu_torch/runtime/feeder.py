"""ctypes bindings for the native host feeder (native/feeder.cpp).

The native library replicates the reference wrapper's ingest layer (bounded
queues with per-topic QoS drop policies + frame/IMU assembly,
`src/imu_mono_realsense.cpp:116-128,322-328,348-368`) in
C++, preprocessing images off the Python thread. A pure-Python fallback with
identical semantics keeps tests/environments without the built .so working.

Copied from `orb_slam3_ros2_tpu/runtime/feeder.py` (numpy and ctypes) over
the same library, `native/libtpuslam_native.so`, found by the same path
relative to this file; the one change is that the library is loaded on
first use (`_lib()`), not when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native",
                 "libtpuslam_native.so"),
    "libtpuslam_native.so",
]


@functools.lru_cache(maxsize=None)
def _lib():
    """The native library with its signatures declared, or None."""
    for p in _LIB_PATHS:
        try:
            lib = ctypes.CDLL(os.path.abspath(p))
            break
        except OSError:
            continue
    else:
        return None
    lib.feeder_create.restype = ctypes.c_void_p
    lib.feeder_create.argtypes = [ctypes.c_int] * 4
    lib.feeder_destroy.argtypes = [ctypes.c_void_p]
    lib.feeder_push_frame.restype = ctypes.c_int
    lib.feeder_push_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_double,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.feeder_push_imu.restype = ctypes.c_int
    lib.feeder_push_imu.argtypes = [
        ctypes.c_void_p, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.feeder_next.restype = ctypes.c_int
    lib.feeder_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_int,
    ]
    lib.feeder_pending_frames.restype = ctypes.c_int
    lib.feeder_pending_frames.argtypes = [ctypes.c_void_p]
    lib.feeder_dropped_imu.restype = ctypes.c_uint64
    lib.feeder_dropped_imu.argtypes = [ctypes.c_void_p]
    lib.feeder_dropped_frames.restype = ctypes.c_uint64
    lib.feeder_dropped_frames.argtypes = [ctypes.c_void_p]
    return lib


class NativeFeeder:
    """Timestamp-ordered frame+IMU assembly, native when available."""

    def __init__(self, width: int, height: int, frame_cap: int = 10,
                 imu_cap: int = 2000, max_imu_per_frame: int = 256,
                 force_python: bool = False):
        self.width = width
        self.height = height
        self.max_imu = max_imu_per_frame
        self._native = _lib() is not None and not force_python
        if self._native:
            self._h = _lib().feeder_create(width, height, frame_cap, imu_cap)
        else:
            self._frames: deque = deque()
            self._imu: deque = deque()
            self._frame_cap = frame_cap
            self._imu_cap = imu_cap
            self._last_t = -np.inf
            self._dropped_imu = 0
            self._dropped_frames = 0
            self._mu = threading.Lock()

    @property
    def is_native(self) -> bool:
        return self._native

    def push_frame(self, t: float, img: np.ndarray) -> bool:
        """img: HxW or HxWx3 uint8; resized/gray-converted to target size."""
        img = np.ascontiguousarray(img, np.uint8)
        ch = 1 if img.ndim == 2 else img.shape[2]
        if self._native:
            ok = _lib().feeder_push_frame(
                self._h, float(t),
                img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                img.shape[1], img.shape[0], ch,
            )
            return bool(ok)
        with self._mu:
            if len(self._frames) >= self._frame_cap:
                self._dropped_frames += 1
                return False
            f = img.mean(axis=2) if ch > 1 else img.astype(np.float32)
            if f.shape != (self.height, self.width):
                import cv2

                f = cv2.resize(f.astype(np.float32),
                               (self.width, self.height))
            self._frames.append((float(t), f.astype(np.float32)))
            return True

    def push_imu(self, t: float, gyro, acc) -> bool:
        gyro = np.asarray(gyro, np.float64)
        acc = np.asarray(acc, np.float64)
        if self._native:
            ok = _lib().feeder_push_imu(
                self._h, float(t),
                gyro.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                acc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
            return bool(ok)
        if np.isnan(gyro).any() or np.isnan(acc).any():
            return False
        with self._mu:
            if len(self._imu) >= self._imu_cap:
                self._imu.popleft()
                self._dropped_imu += 1
            self._imu.append((float(t), gyro.copy(), acc.copy()))
            return True

    def next(self, wait_ms: int = 0
             ) -> Optional[Tuple[float, np.ndarray, np.ndarray]]:
        """Pop (t, image float32 (H, W), imu (M, 7) rows [t, g, a]) or None."""
        if self._native:
            t_out = ctypes.c_double()
            img = np.empty((self.height, self.width), np.float32)
            imu = np.empty((self.max_imu, 7), np.float64)
            n = _lib().feeder_next(
                self._h, ctypes.byref(t_out),
                img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                imu.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                self.max_imu, int(wait_ms),
            )
            if n < 0:
                return None
            return t_out.value, img, imu[:n].copy()
        with self._mu:
            if not self._frames:
                return None
            t, img = self._frames.popleft()
            rows: List = []
            while self._imu and self._imu[0][0] <= t:
                ti, g, a = self._imu.popleft()
                if ti > self._last_t:
                    rows.append([ti, *g, *a])
            self._last_t = t
            return t, img, np.asarray(rows, np.float64).reshape(-1, 7)

    def pending_frames(self) -> int:
        if self._native:
            return int(_lib().feeder_pending_frames(self._h))
        with self._mu:
            return len(self._frames)

    def stats(self):
        if self._native:
            return {
                "dropped_imu": int(_lib().feeder_dropped_imu(self._h)),
                "dropped_frames": int(_lib().feeder_dropped_frames(self._h)),
            }
        return {"dropped_imu": self._dropped_imu,
                "dropped_frames": self._dropped_frames}

    def __del__(self):
        if getattr(self, "_native", False):
            _lib().feeder_destroy(self._h)
