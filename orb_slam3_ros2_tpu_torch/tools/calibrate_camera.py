"""Calibrate camera intrinsics from aprilgrid captures and print the
`Camera1.*` settings keys (the solve the reference leaves to Kalibr).

    python -m orb_slam3_ros2_tpu_torch.tools.calibrate_camera \
        --images 'captures/*.png' --target calib_target/aprilgrid.yaml \
        [--model KannalaBrandt8]

Port of `scripts/calibrate_camera.py`: a glob of images or a recording
directory (its cam0 frames), `io/calibrate.calibrate`, the same printed
lines, and exit code 1 without readable images or 3 usable views. It
does no device work; OpenCV is imported when it runs. With OpenCV 5,
`cv2.fisheye.calibrate` raises for `KannalaBrandt8` in both packages; the
error propagates here as it does from the script.
"""

from __future__ import annotations

import argparse
import glob as globmod
import os
import sys
from typing import Optional


def image_paths(pattern: str) -> list:
    """The glob's files; a single directory stands for its cam0 frames
    (`mav0/cam0/data/*` or `cam0/data/*`)."""
    paths = sorted(globmod.glob(pattern))
    if len(paths) == 1 and os.path.isdir(paths[0]):
        paths = sorted(
            globmod.glob(os.path.join(paths[0], "mav0", "cam0", "data", "*"))
            or globmod.glob(os.path.join(paths[0], "cam0", "data", "*"))
        )
    return paths


def main(argv=None) -> Optional[str]:
    """Calibrates; prints the view count and RMS line and the settings
    keys, and returns the keys (None on failure: exit code 1)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", required=True,
                    help="glob of capture images or a recording dir")
    ap.add_argument("--target", required=True, help="aprilgrid.yaml spec")
    ap.add_argument("--model", default="PinHole",
                    choices=["PinHole", "KannalaBrandt8"])
    args = ap.parse_args(argv)

    import cv2

    from orb_slam3_ros2_tpu_torch.io.calibrate import AprilGridSpec, calibrate

    images = [cv2.imread(p, cv2.IMREAD_GRAYSCALE)
              for p in image_paths(args.images)]
    images = [i for i in images if i is not None]
    if not images:
        print("no readable images", file=sys.stderr)
        return None

    spec = AprilGridSpec.load(args.target)
    res = calibrate(images, spec, model=args.model)
    if res is None:
        print("not enough grid views (need >= 3 with detections)",
              file=sys.stderr)
        return None
    keys = res.settings_keys()
    print(f"# {res.n_views} views, reprojection RMS {res.rms_px:.3f} px")
    print(keys)
    return keys


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
