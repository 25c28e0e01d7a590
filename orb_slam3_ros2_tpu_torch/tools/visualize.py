"""Offline map and trajectory views: the reference's `visualize_node` +
RViz layer (it loads a saved `output/<name>/cloud/<name>.pcd` and
republishes it) made headless: a session's saved artifacts rendered as
three orthographic views of the map points and the trajectory, to PNG.

    python -m orb_slam3_ros2_tpu_torch.tools.visualize --name <run>
        [--output-root output] [--out map.png]

Port of `scripts/visualize.py`: the same flags, views and PNG path
(`<output-root>/<name>/<name>_map.png` by default). It reads
`cloud/<name>.pcd` and `<name>_traj.txt` (TUM) under
`<output-root>/<name>/` and exits with code 1 when neither is there. It
does no device work; matplotlib is imported only to draw.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np


def render(pts: np.ndarray, traj: np.ndarray, out: str) -> None:
    """Top (x-z), front (x-y) and side (z-y) views of the points (coloured
    by y) and the trajectory (start and end marked), written to `out`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(15, 5.2))
    views = [("top (x-z)", 0, 2), ("front (x-y)", 0, 1), ("side (z-y)", 2, 1)]
    for ax, (name, i, j) in zip(axes, views):
        if len(pts):
            ax.scatter(pts[:, i], pts[:, j], s=0.6, c=pts[:, 1],
                       cmap="viridis", alpha=0.55, linewidths=0)
        if len(traj):
            ax.plot(traj[:, i], traj[:, j], "r-", lw=1.4, label="trajectory")
            ax.plot(traj[0, i], traj[0, j], "g^", ms=8, label="start")
            ax.plot(traj[-1, i], traj[-1, j], "rs", ms=7, label="end")
        ax.set_title(name)
        ax.set_aspect("equal")
        ax.grid(True, lw=0.3, alpha=0.5)
    if len(traj):
        axes[0].legend(loc="upper right", fontsize=8)
    fig.suptitle(f"{len(pts)} map points, {len(traj)} poses")
    fig.tight_layout()
    fig.savefig(out, dpi=130)
    plt.close(fig)
    print(f"wrote {out}")


def load_artifacts(root: str, name: str):
    """(points (P, 3), trajectory positions (T, 3)) of the session under
    `root`; empty where a file is missing."""
    from orb_slam3_ros2_tpu_torch.runtime import outputs as out_mod

    pcd = os.path.join(root, "cloud", f"{name}.pcd")
    pts = out_mod.load_pcd(pcd) if os.path.isfile(pcd) else np.zeros((0, 3))
    traj_path = os.path.join(root, f"{name}_traj.txt")
    traj = np.zeros((0, 3))
    if os.path.isfile(traj_path):
        with open(traj_path) as f:
            rows = [ln.split() for ln in f if ln.strip()]
        traj = np.asarray([[float(r[1]), float(r[2]), float(r[3])]
                           for r in rows])
    return pts, traj


def main(argv=None) -> Optional[str]:
    """Renders the session's views; returns the PNG path, or None when no
    artifacts were found (the command then exits with code 1)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--name", required=True,
                    help="session output name (directory under output/)")
    ap.add_argument("--output-root", default="output")
    ap.add_argument("--out", default=None, help="PNG path")
    args = ap.parse_args(argv)

    root = os.path.join(args.output_root, args.name)
    pts, traj = load_artifacts(root, args.name)
    if not len(pts) and not len(traj):
        print(f"no artifacts found under {root}", file=sys.stderr)
        return None
    out = args.out or os.path.join(root, f"{args.name}_map.png")
    render(pts, traj, out)
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
