"""Sharded-BA scaling: BA iterations/s against the number of landmark
shards.

    python -m orb_slam3_ros2_tpu_torch.tools.bench_scaling [--poses 64]
        [--landmarks 32768] [--iters 20] [--reps 3]
        [--shards-per-device 8] [--device cuda|cpu]

Port of `scripts/bench_scaling.py`: the landmark-sharded Schur-complement
BA (`parallel/sharded_ba.py`) on `make_scene(64 frames, seed 1)` tiled to
32,768 landmarks with `default_rng(0)` noise, 20 iterations a run, the
best of 3 runs after a warm-up, at 1, 2, 4, 8, ... shards up to the shards
there are. It prints one JSON line per shard count (the script's keys:
`devices` holds the shard count; plus `best_s`, the best run unrounded)
and a summary line.

XLA makes N virtual CPU devices with `--xla_force_host_platform_device_count`
and the script spreads the mesh over them. A torch mesh takes a device per
shard, and one device may hold several: `--shards-per-device S` gives each
card (or the CPU, with `--device cpu`) S shards, dealt over the cards in
turn, so the mesh sizes run up to S times the cards. That flag and
`--device` are the only ones the script does not have. Shards that share
a device run one after another there, so the time of such a mesh is not a
scaling measurement: its line's `efficiency` is null, and so is the
summary's `efficiency_at_max`. The summary adds `shards_per_device`, and
`card` (the card's `name` and `power.limit`, as `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` gives them).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.tools.cli import (add_device, check_device,
                                                device_of, sync)
from orb_slam3_ros2_tpu_torch.tools.roofline import card

FX = FY = 350.0
CX, CY = 320.0, 240.0
SIZES = (1, 2, 4, 8, 16, 32)


def problem(K: int, L: int, device):
    """The script's BA problem: `make_scene(K frames, min(L, 512) points,
    noise 0.5 px, seed 1)` tiled to L landmarks with N(0, 0.05) added to
    the points, then N(0, 0.02) to the translations (`default_rng(0)`, in
    that order); keyframe 0 fixed."""
    from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod
    from orb_slam3_ros2_tpu_torch.io import synthetic

    rng = np.random.default_rng(0)
    sc = synthetic.make_scene(n_frames=K, n_points=min(L, 512),
                              noise_px=0.5, seed=1)
    reps = L // sc.X.shape[0] + 1
    X = np.tile(sc.X, (reps, 1))[:L] + rng.normal(0, 0.05, (L, 3))
    t = sc.t_cw + rng.normal(0, 0.02, sc.t_cw.shape)
    uv = np.tile(sc.uv, (1, reps, 1))[:, :L]
    w = np.tile(sc.vis, (1, reps))[:, :L]
    fixed = np.zeros(K, bool)
    fixed[0] = True

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return ba_mod.BAProblem(
        R=f32(sc.R_cw), t=f32(t), X=f32(X), uv=f32(uv), w=f32(w),
        fixed=torch.as_tensor(fixed, device=device),
        point_valid=torch.ones(L, dtype=torch.bool, device=device))


def run(K: int = 64, L: int = 32768, iters: int = 20, reps: int = 3,
        shards_per_device: int = 8, device="cuda") -> list:
    """The lines and the summary, as dicts (the summary last)."""
    from orb_slam3_ros2_tpu_torch.parallel import mesh as mesh_mod
    from orb_slam3_ros2_tpu_torch.parallel import sharded_ba

    dev = check_device(device)
    cards = ([torch.device("cuda", i)
              for i in range(torch.cuda.device_count())]
             if dev.type == "cuda" else [dev])
    p_full = problem(K, L, dev)
    slots = len(cards) * shards_per_device
    sizes = [n for n in SIZES if n <= slots]
    results = []
    t1 = None
    for n in sizes:
        devs = [cards[i % len(cards)] for i in range(n)]
        mesh = mesh_mod.make_mesh(n, devices=devs)
        ba = sharded_ba.make_sharded_ba(mesh, FX, FY, CX, CY, n_iters=iters)
        p = sharded_ba.shard_problem(p_full, mesh)
        out = ba(p)  # warm-up
        sync(*devs)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = ba(p)
            sync(*devs)
            best = min(best, time.perf_counter() - t0)
        iters_s = iters / best
        if t1 is None:
            t1 = best
        shared = n > len(cards)
        eff = None if shared else round(t1 / (n * best), 3)
        results.append({"devices": n, "ba_iters_per_s": round(iters_s, 2),
                        "efficiency": eff,
                        "final_cost": round(float(out.cost), 2),
                        "best_s": best})
        print(json.dumps(results[-1]), flush=True)

    summary = {
        "metric": "ba_scaling",
        "poses": K, "landmarks": L,
        "platform": dev.type,
        "host_cores": os.cpu_count(),
        "max_devices": sizes[-1] if sizes else 0,
        "iters_per_s_at_max": results[-1]["ba_iters_per_s"] if results else 0,
        "efficiency_at_max": results[-1]["efficiency"] if results else 0,
        "shards_per_device": shards_per_device,
        "card": card(dev),
    }
    print(json.dumps(summary), flush=True)
    return results + [summary]


def main(argv=None) -> list:
    """Runs the bench; returns the printed lines as dicts (the summary
    last)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--poses", type=int, default=64)
    ap.add_argument("--landmarks", type=int, default=32768)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--shards-per-device", type=int, default=8,
                    help="landmark shards each device holds at most")
    add_device(ap)
    args = ap.parse_args(argv)
    dev = device_of(ap, args)
    return run(args.poses, args.landmarks, args.iters, args.reps,
               args.shards_per_device, dev)


if __name__ == "__main__":
    main()
