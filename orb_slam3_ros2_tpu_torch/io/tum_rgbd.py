"""TUM RGB-D dataset loader (freiburg1/2/3 sequences).

The reference ships TUM1/2/3 settings (`config/Monocular/
TUM{1,2,3}.yaml`); upstream ORB-SLAM3's RGB-D mode consumes the TUM RGB-D
layout [upstream rgbd_tum example]:

    <root>/rgb.txt           "# comments", then rows "t rgb/<t>.png"
    <root>/depth.txt         rows "t depth/<t>.png"
    <root>/groundtruth.txt   rows "t tx ty tz qx qy qz qw"

Depth PNGs are 16-bit with 5000 units per meter (the dataset convention).
RGB and depth streams are unsynchronized; frames are associated by nearest
timestamp within `max_dt` (the dataset's associate.py convention).

Copied from `orb_slam3_ros2_tpu/io/tum_rgbd.py` (numpy; cv2 when a frame is
loaded).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

DEPTH_SCALE = 5000.0  # 16-bit depth units per meter (TUM convention)


def _read_list(path: str) -> List[tuple]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            rows.append((float(parts[0]), *parts[1:]))
    return rows


@dataclasses.dataclass
class RgbdFrame:
    t: float
    rgb_path: str
    depth_path: str

    def load(self):
        import cv2

        img = cv2.imread(self.rgb_path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(self.rgb_path)
        d = cv2.imread(self.depth_path, cv2.IMREAD_UNCHANGED)
        if d is None:
            raise FileNotFoundError(self.depth_path)
        depth = d.astype(np.float32) / DEPTH_SCALE
        return img.astype(np.float32), depth


@dataclasses.dataclass
class TumRgbdSequence:
    frames: List[RgbdFrame]
    gt_t: Optional[np.ndarray]
    gt_p: Optional[np.ndarray]

    def gt_at(self, t: float) -> Optional[np.ndarray]:
        if self.gt_t is None or len(self.gt_t) == 0:
            return None
        i = int(np.searchsorted(self.gt_t, t).clip(0, len(self.gt_t) - 1))
        return self.gt_p[i]


def load_sequence(root: str, max_dt: float = 0.02) -> TumRgbdSequence:
    rgb = _read_list(os.path.join(root, "rgb.txt"))
    depth = _read_list(os.path.join(root, "depth.txt"))
    dts = np.asarray([r[0] for r in depth])
    frames = []
    used = set()
    for t, name in rgb:
        i = int(np.searchsorted(dts, t).clip(0, len(dts) - 1))
        # nearest of the two bracketing depth stamps
        if i > 0 and abs(dts[i - 1] - t) < abs(dts[i] - t):
            i -= 1
        if abs(dts[i] - t) > max_dt or i in used:
            continue
        used.add(i)
        frames.append(RgbdFrame(
            t=t, rgb_path=os.path.join(root, name),
            depth_path=os.path.join(root, depth[i][1]),
        ))

    gt_t = gt_p = None
    gt_path = os.path.join(root, "groundtruth.txt")
    if os.path.isfile(gt_path):
        rows = _read_list(gt_path)
        arr = np.asarray([[float(v) for v in r] for r in rows])
        gt_t, gt_p = arr[:, 0], arr[:, 1:4]
    return TumRgbdSequence(frames=frames, gt_t=gt_t, gt_p=gt_p)


def write_sequence(root: str, images: np.ndarray, depths_m: np.ndarray,
                   timestamps: np.ndarray, centres: np.ndarray) -> str:
    """Write frames in the layout `load_sequence` reads (an addition of the
    port; the JAX module only reads): `rgb/<t>.png` (8-bit gray),
    `depth/<t>.png` (16-bit, DEPTH_SCALE units a metre, rounded; 0 where
    the depth is not finite or lies past the 16-bit range), `rgb.txt`,
    `depth.txt` and `groundtruth.txt` (camera centres, with identity
    rotations: the loader reads positions only). Timestamps are written
    with 6 decimals, as in the dataset. Returns `root`."""
    import cv2

    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rgb_rows, depth_rows, gt_rows = [], [], []
    for img, d, t, c in zip(images, depths_m, timestamps, centres):
        stamp = f"{float(t):.6f}"
        rgb_name = f"rgb/{stamp}.png"
        depth_name = f"depth/{stamp}.png"
        cv2.imwrite(os.path.join(root, rgb_name),
                    np.clip(np.asarray(img), 0, 255).astype(np.uint8))
        units = np.asarray(d, np.float64) * DEPTH_SCALE
        units = np.where(np.isfinite(units) & (units >= 0)
                         & (units <= 65535), np.round(units), 0)
        cv2.imwrite(os.path.join(root, depth_name), units.astype(np.uint16))
        rgb_rows.append(f"{stamp} {rgb_name}")
        depth_rows.append(f"{stamp} {depth_name}")
        gt_rows.append(" ".join([stamp] + [f"{float(v):.6f}" for v in c])
                       + " 0 0 0 1")
    for name, rows, head in (
            ("rgb.txt", rgb_rows, "# color images\n# timestamp filename\n"),
            ("depth.txt", depth_rows,
             "# depth maps\n# timestamp filename\n"),
            ("groundtruth.txt", gt_rows,
             "# ground truth trajectory\n# timestamp tx ty tz qx qy qz qw\n")):
        with open(os.path.join(root, name), "w") as f:
            f.write(head + "".join(r + "\n" for r in rows))
    return root
