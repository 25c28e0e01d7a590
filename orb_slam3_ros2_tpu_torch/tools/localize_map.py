"""Map-to-map localization: the reference's libpointmatcher workflow
(build a new map, then ICP-align it to a saved one to localize in it).
Takes two saved session clouds (PCD paths or `output/<name>` session
directories) and prints the SE(3) transform that places the source map in
the target map's frame.

    python -m orb_slam3_ros2_tpu_torch.tools.localize_map \
        --src output/run2 --dst output/run1 [--device cuda|cpu]

Port of `scripts/localize_map.py`: the same flags and JSON
(`T_dst_src`, the point counts and `align_maps`' statistics), with the ICP
(`atlas/icp_align.align_maps`) on `--device`, the card by default (it
stops without one).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from orb_slam3_ros2_tpu_torch.tools.cli import add_device, device_of


def load_cloud(path: str) -> np.ndarray:
    """A PCD file's points, or those of a session directory's
    `cloud/<name>.pcd`."""
    from orb_slam3_ros2_tpu_torch.runtime.outputs import load_pcd

    if os.path.isdir(path):
        name = os.path.basename(os.path.normpath(path))
        path = os.path.join(path, "cloud", f"{name}.pcd")
    return load_pcd(path)


def main(argv=None) -> dict:
    """Aligns the clouds; prints and returns the JSON as a dict."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="PCD file or session dir")
    ap.add_argument("--dst", required=True, help="PCD file or session dir")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--trim", type=float, default=0.75)
    ap.add_argument("--match-radius", type=float, default=0.5)
    add_device(ap)
    args = ap.parse_args(argv)
    dev = device_of(ap, args)

    from orb_slam3_ros2_tpu_torch.atlas.icp_align import align_maps

    src, dst = load_cloud(args.src), load_cloud(args.dst)
    T, stats = align_maps(src, dst, iters=args.iters, trim=args.trim,
                          match_radius=args.match_radius, device=dev)
    blob = {
        "T_dst_src": [[round(float(v), 6) for v in row] for row in T],
        "src_points": int(len(src)),
        "dst_points": int(len(dst)),
        **{k: round(v, 5) for k, v in stats.items()},
    }
    print(json.dumps(blob, indent=2))
    return blob


if __name__ == "__main__":
    main()
