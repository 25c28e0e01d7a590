"""Where the card's run of phase 10b's stereo-inertial clip departs from
the CPU's.

    python -m orb_slam3_ros2_tpu_torch.tools.vi_rig_diff
        [--variants own cpu_extract cpu_obs] [--extract-frames 60]
        [--save-features PATH] [--features PATH]

Runs the clip of `system_run.VI_RIGS["synth_stereo_inertial"]` (that of
tests/test_e2e_stereo_inertial.py) through the System on the CPU, then on
the card once for each variant:

  own          the card's own extraction and stereo observations
  cpu_extract  every image's features extracted on the CPU and moved to the
               card (`system_run.extract_on_cpu`); all else on the card
  cpu_obs      also the stereo observations formed on the CPU from those
               features

For each run, prints its `system_run.vi_rig_metrics` and the frames whose
step along `get_frame_trajectory()` is longest against the true step (where
the length ratio's excess sits); for each card run, against the CPU run:
the first frame whose keyframe count differs, the first frame whose online
camera centre differs by more than 1e-4 m, and the largest centre
difference. Then the card's `extract()` against the CPU's on the clip's
images, stage by stage (`extract_diff.stage_diffs`; both images of each
pair), with the extremes over the frames.

Without a card only the CPU run is made.

--save-features PATH  writes every feature set that the card's `own` run
              extracted (raw pixels; `save_features`) to an .npz.
--features PATH  runs the clip on the CPU only, fed those feature sets in
              order instead of extracting (`replay_features`);
              `scripts/jax_reference_runs.py --config vi_rigs --features
              PATH` feeds them to the JAX System.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as desc_ops
from orb_slam3_ros2_tpu_torch.runtime import system as sysm
from orb_slam3_ros2_tpu_torch.tools import extract_diff
from orb_slam3_ros2_tpu_torch.tools import system_run as sr

RIG = "synth_stereo_inertial"
CENTRE_M = 1e-4  # an online centre this far from the CPU run's departs
TOP_STEPS = 5  # frames listed with the longest step against the truth
# what a feature set holds besides `signs` (which follow from `bits`)
FEATURE_FIELDS = ("uv", "level", "angle", "score", "bits", "mask")


def record_features(slam: sysm.System, calls: list) -> None:
    """Append to `calls`, as numpy, every feature set that `slam._extract`
    returns."""
    own = slam._extract

    def recorded(img):
        f = own(img)
        calls.append({k: getattr(f, k).cpu().numpy() for k in FEATURE_FIELDS})
        return f

    slam._extract = recorded


def save_features(calls: list, path: str) -> None:
    np.savez_compressed(path, **{k: np.stack([c[k] for c in calls])
                                 for k in FEATURE_FIELDS})


def replay_features(slam: sysm.System, path: str) -> None:
    """Feed `slam` the feature sets of a `save_features` file, in order,
    instead of extracting."""
    d = dict(np.load(path))
    calls = iter(range(len(d["mask"])))

    def replay(img):
        i = next(calls)
        f = {k: torch.from_numpy(d[k][i]).to(slam.device)
             for k in FEATURE_FIELDS}
        return ex.Features(signs=desc_ops.signs_from_bits(f["bits"]), **f)

    slam._extract = replay


def obs_on_cpu(slam: sysm.System) -> None:
    """Form `slam`'s stereo observations on the CPU from its features and
    move them to its device (the clip's rectified path: its inputs besides
    the features are Python floats)."""
    own = slam._stereo_obs
    host = torch.device("cpu")

    def on_cpu(f_l, f_r):
        obs = own(sr.features_to(f_l, host), sr.features_to(f_r, host))
        return type(obs)(*(t.to(slam.device) for t in obs))

    slam._stereo_obs = on_cpu


def run_clip(rig: sr.ViRig, frames, device, variant: str,
             features: list = None) -> dict:
    """The clip through the System on `device`, with `variant`'s stages
    on the CPU (`replayed`: the feature sets of the file `features`).
    Returns its metrics with the per-frame keyframe counts and online
    camera centres; with a list `features`, records the extracted feature
    sets into it."""
    slam = sr.make_vi_rig_system(rig, device)
    if variant in ("cpu_extract", "cpu_obs"):
        sr.extract_on_cpu(slam)
    if variant == "cpu_obs":
        obs_on_cpu(slam)
    if variant == "replayed":
        replay_features(slam, features)
    elif features is not None:
        record_features(slam, features)
    n_kf, centres = [], []
    for k in range(rig.n_frames):
        T = sr.track_vi_rig(slam, rig, frames, k)
        n_kf.append(int(slam.map.n_kf))
        centres.append((-T[:3, :3].T @ T[:3, 3]).tolist())
    R_gt, t_gt = frames[2], frames[3]
    r = sr.vi_rig_metrics(slam, rig, R_gt, t_gt)
    traj = slam.get_frame_trajectory()
    ok = sr.tracked_frames(slam)
    est = np.array([-traj[k][1][:3, :3].T @ traj[k][1][:3, 3] for k in ok])
    gt = np.array([-R_gt[k].T @ t_gt[k] for k in ok])
    excess = (np.linalg.norm(np.diff(est, axis=0), axis=1)
              - np.linalg.norm(np.diff(gt, axis=0), axis=1))
    r["longest_steps"] = [(ok[i + 1], float(excess[i]))
                          for i in np.argsort(-excess)[:TOP_STEPS]]
    r.update(device=str(device), variant=variant, n_kf_per_frame=n_kf,
             centres=centres)
    return r


def departure(ref: dict, run: dict) -> dict:
    """Where `run` first departs from `ref` (both from `run_clip`)."""
    kf = [k for k, (a, b) in enumerate(zip(ref["n_kf_per_frame"],
                                           run["n_kf_per_frame"])) if a != b]
    d = np.linalg.norm(np.array(ref["centres"]) - np.array(run["centres"]),
                       axis=1)
    far = np.nonzero(d > CENTRE_M)[0]
    return dict(first_keyframe_count_diff=kf[0] if kf else None,
                first_centre_diff=int(far[0]) if len(far) else None,
                max_centre_diff_m=float(d.max()),
                max_centre_diff_frame=int(d.argmax()))


def extraction_diffs(rig: sr.ViRig, frames, n_frames: int, dev) -> dict:
    """`extract_diff.stage_diffs` on the clip's images (both of each pair),
    with the extremes over them."""
    cfg = sysm.System(None, str(sr.REPO / rig.settings), rig.sensor,
                      device="cpu").ex_cfg
    images = [frames[0][:n_frames], frames[1][:n_frames]]
    rows = [extract_diff.stage_diffs(np.asarray(im, np.float32), cfg, dev)
            for seq in images for im in seq]
    out = {key: (max(r[key] for r in rows) if key != "pyramid_max_abs"
                 else [max(v) for v in zip(*(r[key] for r in rows))])
           for key in rows[0]}
    out.update(images=len(rows),
               bit_flips_mean=float(np.mean([r["bit_flips_mean"]
                                             for r in rows])))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="*",
                    default=["own", "cpu_extract", "cpu_obs"],
                    choices=["own", "cpu_extract", "cpu_obs"])
    ap.add_argument("--extract-frames", type=int, default=60)
    ap.add_argument("--save-features")
    ap.add_argument("--features")
    args = ap.parse_args(argv)
    rig = sr.VI_RIGS[RIG]
    frames = sr.render_vi_rig(rig)

    def show(r):
        print(json.dumps({k: v for k, v in r.items()
                          if k not in ("centres", "n_kf_per_frame")}),
              flush=True)

    if args.features:
        show(run_clip(rig, frames, torch.device("cpu"), "replayed",
                      args.features))
        return
    ref = run_clip(rig, frames, torch.device("cpu"), "own")
    show(ref)
    if not torch.cuda.is_available():
        return
    dev = torch.device("cuda", 0)
    for variant in args.variants:
        calls = [] if variant == "own" and args.save_features else None
        r = run_clip(rig, frames, dev, variant, calls)
        r["against_cpu"] = departure(ref, r)
        show(r)
        if calls:
            save_features(calls, args.save_features)
    if args.extract_frames:
        print(json.dumps(dict(extraction=extraction_diffs(
            rig, frames, args.extract_frames, dev))), flush=True)


if __name__ == "__main__":
    main()
