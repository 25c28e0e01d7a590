"""Train a BoW vocabulary from sequence imagery: the offline step that
makes the reference's `ORBvoc.txt` (DBoW2 k-medians training), here a flat
k-majority codebook saved as npz (or, with `--hierarchical`, a k-ary tree)
that the System's `vocab_path` loads.

    python -m orb_slam3_ros2_tpu_torch.tools.train_vocab --synthetic \
        --out build/vocab/myvocab.npz [--device cuda|cpu]
    python -m orb_slam3_ros2_tpu_torch.tools.train_vocab \
        --dataset /data/MH_01_easy --settings config/Monocular/EuRoC.yaml \
        --out build/vocab/euroc_vocab.npz

Port of `scripts/train_vocab.py`: the same flags, frames, seeds and
training, with the ORB features extracted on `--device` (the card by
default; it stops without one). The synthetic branch renders
`--max-frames` frames of `render_sequence` at the settings' camera (seed 3,
and `--scenes` scenes of seeds 3 + 17 s for `--hierarchical`); the EuRoC
branch reads the first `--max-frames` cam0 frames of `--dataset`
(`io/euroc.load_sequence`). It prints the path it wrote.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.tools.cli import REPO, add_device, device_of



def frames_of(args, s) -> list:
    """The training frames: rendered (`--synthetic`) or read from the
    EuRoC directory."""
    if args.synthetic:
        from orb_slam3_ros2_tpu_torch.io import synthetic

        frames = []
        n_scenes = max(args.scenes, 1) if args.hierarchical else 1
        for sc in range(n_scenes):
            images, _, _, _ = synthetic.render_sequence(
                n_frames=args.max_frames, width=s.camera.width,
                height=s.camera.height, fx=s.camera.fx, fy=s.camera.fy,
                fps=s.fps, seed=3 + 17 * sc, traj_scale=1.6,
            )
            frames.extend(list(images))
        return frames
    from orb_slam3_ros2_tpu_torch.io import euroc

    seq = euroc.load_sequence(args.dataset)
    return [f.load() for f in seq.frames[: args.max_frames]]


def descriptors(extract, frames, device) -> np.ndarray:
    """(M, 256) ±1 descriptors of every frame's valid features, in frame
    order."""
    out = []
    for img in frames:
        f = extract(torch.from_numpy(np.asarray(img, np.float32)).to(device))
        out.append(f.signs[f.mask].cpu().numpy())
    return np.concatenate(out)


def main(argv=None) -> str:
    """Trains and saves the vocabulary; prints and returns its path."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", help="EuRoC-layout sequence root")
    ap.add_argument("--settings", default=os.path.join(
        REPO, "tests", "data", "synth_cam.yaml"))
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--max-frames", type=int, default=60)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--out", required=True)
    ap.add_argument("--hierarchical", action="store_true",
                    help="train a k-ary tree (DBoW2-style) instead of a "
                         "flat codebook")
    ap.add_argument("--branching", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--scenes", type=int, default=8,
                    help="synthetic mode: distinct rendered scenes to pool "
                         "descriptors from (hierarchical training wants "
                         ">> k^depth descriptors)")
    ap.add_argument("--export-dbow2-txt", default=None,
                    help="also write the trained tree in DBoW2 text format")
    add_device(ap)
    args = ap.parse_args(argv)
    dev = device_of(ap, args)
    if not args.synthetic and not args.dataset:
        ap.error("--dataset or --synthetic required")

    from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
    from orb_slam3_ros2_tpu_torch.io.settings import load_settings
    from orb_slam3_ros2_tpu_torch.loop import vocab as vocab_mod

    s = load_settings(args.settings)
    extract = ex.make_extractor(ex.ExtractorConfig(
        n_features=s.n_features, n_levels=s.n_levels,
        scale_factor=s.scale_factor, ini_th_fast=s.ini_th_fast,
        min_th_fast=s.min_th_fast, height=s.camera.height,
        width=s.camera.width,
    ))
    frames = frames_of(args, s)
    signs = descriptors(extract, frames, dev)
    print(f"training on {signs.shape[0]} descriptors "
          f"from {len(frames)} frames", file=sys.stderr)
    if args.hierarchical:
        from orb_slam3_ros2_tpu_torch.loop import hvocab as hv

        tree = hv.train_hierarchical(signs, k=args.branching,
                                     depth=args.depth, iters=args.iters)
        path = hv.save_hvocab(args.out, tree)
        if args.export_dbow2_txt:
            hv.export_dbow2_text(tree, args.export_dbow2_txt)
            print(args.export_dbow2_txt, file=sys.stderr)
    else:
        A = vocab_mod.train_vocabulary(signs, iters=args.iters)
        path = vocab_mod.save_vocabulary(args.out, A)
    print(path)
    return path


if __name__ == "__main__":
    main()
