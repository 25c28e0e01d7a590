"""Where the card's `extract()` departs from the CPU's: phase 4's frames
through each stage on both devices, with the differences per stage.

    python -m orb_slam3_ros2_tpu_torch.tools.extract_diff [--frames 40]

For each frame of `system_run.render()` (the euroc_mono clip of
`chip_smoke.py` phase 4: 752x480, 1000 features, 8 levels), on the card
and on the CPU:

  pyramid    max |card - CPU| of each level (`ops/pyramid.py`
             `build_pyramid`, the resize matmuls)
  frontend   on each level's interior (4 px inside): max |score
             difference| and keep flips, with each device's own pyramid;
             and the card's kernel on the CPU's pyramid against the CPU's
             plain frontend (the frontend alone)
  keypoints  valid features of one device with no feature of the other at
             the same level within 0.25 px (in that level's pixels)
  angles     max |angle difference| over the keypoints both selected
  bits       descriptor bits that differ on those keypoints: total, mean
             and max per keypoint
  level 0    the angles and bits on level 0 alone, whose image, score,
             blur and keypoints are the same on both devices: what the
             orientation and descriptor ops themselves add

Prints one JSON line per frame and one with the extremes over the clip.
Needs a card; the CPU side runs in the same process.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
from orb_slam3_ros2_tpu_torch.ops import frontend_packed as fp
from orb_slam3_ros2_tpu_torch.ops import pyramid as pyr
from orb_slam3_ros2_tpu_torch.tools import system_run as sr

INTERIOR = 4  # px inside each level where the frontend is defined exactly
SAME_KP_PX = 0.25  # one keypoint on both devices: same level, this close


def stage_diffs(img: np.ndarray, cfg: ex.ExtractorConfig, dev) -> dict:
    """The per-stage differences of one frame (see the module docstring)."""
    host = torch.device("cpu")
    lv = {d: pyr.build_pyramid(torch.from_numpy(img).to(d), cfg.n_levels,
                               cfg.scale_factor) for d in (dev, host)}
    out = dict(pyramid_max_abs=[
        (a.cpu() - b).abs().max().item() for a, b in zip(lv[dev], lv[host])])
    ref = fp.frontend_pass_packed(lv[host])
    for key, levels in (("own_pyramid", lv[dev]),
                        ("cpu_pyramid", [l.to(dev) for l in lv[host]])):
        got = fp.frontend_pass_packed(levels)
        score_d, flips = [], 0
        for r0, h, w in ref[4]:
            sl = (slice(r0 + INTERIOR, r0 + h - INTERIOR),
                  slice(INTERIOR, w - INTERIOR))
            score_d.append((got[0].cpu()[sl] - ref[0][sl]).abs().max().item())
            flips += int((got[1].cpu()[sl] != ref[1][sl]).sum())
        out[f"score_max_abs_{key}"] = max(score_d)
        out[f"keep_flips_{key}"] = flips

    extract = ex.make_extractor(cfg)
    f = {d: extract(torch.from_numpy(img).to(d)) for d in (dev, host)}
    scales = pyr.scale_factors(cfg.n_levels, cfg.scale_factor)
    only_card = only_cpu = 0
    angle_d, bit_flips = [], []  # per level
    for lvl in range(cfg.n_levels):
        sel = {d: (f[d].mask & (f[d].level == lvl)).cpu() for d in f}
        uv = {d: f[d].uv.cpu()[sel[d]] / float(scales[lvl]) for d in f}
        if len(uv[dev]) == 0 or len(uv[host]) == 0:
            only_card += len(uv[dev])
            only_cpu += len(uv[host])
            angle_d.append(torch.zeros(0))
            bit_flips.append(torch.zeros(0, dtype=torch.int64))
            continue
        dist = torch.cdist(uv[dev].double(), uv[host].double())
        j = dist.argmin(dim=1)
        same = dist[torch.arange(len(j)), j] <= SAME_KP_PX
        only_card += int((~same).sum())
        only_cpu += len(uv[host]) - int(same.sum())
        ia = torch.nonzero(sel[dev]).reshape(-1)[same]
        ib = torch.nonzero(sel[host]).reshape(-1)[j[same]]
        angle_d.append((f[dev].angle.cpu()[ia] - f[host].angle[ib]).abs())
        xor = f[dev].bits.cpu()[ia] ^ f[host].bits[ib]
        bit_flips.append(torch.tensor(
            [sum(bin(int(w) & 0xFFFFFFFF).count("1") for w in row)
             for row in xor.tolist()], dtype=torch.int64))
    ang, bits = torch.cat(angle_d), torch.cat(bit_flips)
    ang0, bits0 = angle_d[0], bit_flips[0]
    out.update(
        n_valid_card=int(f[dev].mask.sum()), n_valid_cpu=int(f[host].mask.sum()),
        keypoints_only_card=only_card, keypoints_only_cpu=only_cpu,
        common_keypoints=len(ang),
        angle_max_abs=ang.max().item() if len(ang) else 0.0,
        bit_flips_total=int(bits.sum()),
        bit_flips_mean=float(bits.double().mean()) if len(bits) else 0.0,
        bit_flips_max=int(bits.max()) if len(bits) else 0,
        common_keypoints_level0=len(ang0),
        angle_max_abs_level0=ang0.max().item() if len(ang0) else 0.0,
        bit_flips_total_level0=int(bits0.sum()),
        bit_flips_max_level0=int(bits0.max()) if len(bits0) else 0)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=sr.N_FRAMES)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("compares the card with the CPU: no CUDA device is available")
    dev = torch.device("cuda", 0)
    imgs = sr.render()[0][:args.frames]
    cfg = ex.ExtractorConfig(n_features=1000, n_levels=8, scale_factor=1.2,
                             height=sr.HEIGHT, width=sr.WIDTH)
    rows = []
    for k, img in enumerate(imgs):
        rows.append(stage_diffs(np.asarray(img, np.float32), cfg, dev))
        print(json.dumps(dict(frame=k, **rows[-1])))
    summary = {key: (max(r[key] for r in rows) if key != "pyramid_max_abs"
                     else [max(v) for v in zip(*(r[key] for r in rows))])
               for key in rows[0]}
    summary["bit_flips_mean"] = float(np.mean([r["bit_flips_mean"]
                                               for r in rows]))
    summary["frames"] = len(rows)
    print(json.dumps(dict(clip_extremes=summary)))


if __name__ == "__main__":
    main()
