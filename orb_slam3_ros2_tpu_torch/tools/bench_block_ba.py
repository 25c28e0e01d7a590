"""Block-parallel BA against the global solve, on the card.

    python -m orb_slam3_ros2_tpu_torch.tools.bench_block_ba
        [--out BLOCKBA_TORCH.json] [--kf 64] [--blocks 4] [--iters 15]
        [--device cuda|cpu]

Port of `scripts/bench_block_ba.py`. The city-scale solver
(`parallel/block_ba.py`) solves covisibility blocks with their boundary
keyframes held fixed and no communication between blocks; this bench
measures what that costs. One corridor problem (keyframes marching along
+x, landmarks on the walls, banded visibility) is solved as

- `global`: one robust-LM Schur solve over every keyframe;
- `block_fixed_boundary`: one Gauss-Seidel sweep over B blocks, each
  solving its own keyframes and the landmarks it owns with the out-of-block
  observers of those landmarks (the boundary ring) held fixed;
- `block_round_2` .. `_4`: further sweeps, each block taking its
  neighbours' latest values;

and each row reports the Sim3-aligned pose RMSE against ground truth, the
full problem's robust cost and the wall time (blocks in series). The
corridor, the owner and ring rules, the `results` keys and the `note` and
`analysis` strings are the script's; its per-keyframe `so3_exp` loop is
one batched `geom/lie.so3_exp` call here, and each block keeps its own
keyframe count (padding the blocks to one shape would change what `fixed`
covers). The JSON adds `card` (the card's `name` and `power.limit`, as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
them) and `ms_per_iter` to each timed row (its wall over the solver
iterations it ran). It is written to `--out`, `BLOCKBA_TORCH.json` by
default (never the JAX package's `BLOCKBA.json`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.tools.cli import (add_device, check_device,
                                                device_of, sync)
from orb_slam3_ros2_tpu_torch.tools.roofline import card

FX = FY = 400.0
CX, CY = 320.0, 240.0
W, H = 640, 480

NOTE = ("{B} blocks of {KB} kf, boundary ring fixed at the incoming "
        "estimates; blocks independent (wall time is the SEQUENTIAL sum — "
        "on a (kf, lm) mesh the blocks run concurrently). Later rounds = "
        "block-Jacobi iterations (boundary re-fixed at neighbors' last "
        "results)")
ANALYSIS = (
    "the Gauss-Seidel block sweep reduces the reprojection cost to within "
    "2x of the global optimum but corrects "
    "LOW-FREQUENCY drift modes only ~one block per round — global "
    "trajectory-scale consistency must come from the pose graph (as "
    "the engine's loop closing does) before block refinement; blocks "
    "are the cheap high-frequency polish, not a substitute for the "
    "global solve")


def build_corridor(K=64, lm_per_kf=60, seed=0, noise_px=0.6,
                   pose_noise=0.01, point_noise=0.05):
    """Keyframes marching along +x; landmarks on the corridor walls.
    Visibility banded by the frustum and a depth window. The draws of the
    script, in its order; the initial rotations are exp(dθ_k) R_k with one
    batched f32 `so3_exp`, returned as f32 as the script's are."""
    from orb_slam3_ros2_tpu_torch.geom import lie

    rng = np.random.default_rng(seed)
    spacing = 0.5
    centers = np.stack([np.arange(K) * spacing,
                        0.05 * np.sin(np.arange(K) * 0.4),
                        np.zeros(K)], axis=-1)
    yaw = 0.06 * np.sin(np.arange(K) * 0.23)
    c, s = np.cos(yaw), np.sin(yaw)
    zero, one = np.zeros(K), np.ones(K)
    Rz = np.stack([np.stack([c, -s, zero], -1), np.stack([s, c, zero], -1),
                   np.stack([zero, zero, one], -1)], 1)
    # camera looks down +z = corridor +x; world x -> cam z
    R_wc = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], float) @ Rz
    R_cw = np.transpose(R_wc, (0, 2, 1))
    t_cw = -np.einsum("kij,kj->ki", R_cw, centers)

    L = K * lm_per_kf // 2
    X = np.stack([
        rng.uniform(-2.0, (K + 8) * spacing, L),
        rng.uniform(-2.5, 2.5, L),
        rng.uniform(-2.5, 2.5, L),
    ], axis=-1)

    xc = np.einsum("kij,lj->kli", R_cw, X) + t_cw[:, None]
    z = xc[..., 2]
    u = FX * xc[..., 0] / np.maximum(z, 1e-6) + CX
    v = FY * xc[..., 1] / np.maximum(z, 1e-6) + CY
    vis = ((z > 1.0) & (z < 9.0) & (u > 10) & (u < W - 10)
           & (v > 10) & (v < H - 10))
    uv = np.stack([u, v], axis=-1) + rng.normal(0, noise_px, (K, L, 2))

    # noisy initial state: odometry-like pose drift + point noise
    drift = np.cumsum(rng.normal(0, pose_noise, (K, 3)), axis=0)
    drift -= drift[0]
    t0 = t_cw + drift
    dth = np.cumsum(rng.normal(0, pose_noise * 0.15, (K, 3)), axis=0)
    dth -= dth[0]
    dR = lie.so3_exp(torch.from_numpy(dth.astype(np.float32))).numpy()
    R0 = (dR @ R_cw).astype(np.float32)
    X0 = X + rng.normal(0, point_noise, X.shape)
    return dict(R_gt=R_cw, t_gt=t_cw, X_gt=X, uv=uv, vis=vis,
                R0=R0, t0=t0, X0=X0, centers=centers)


def pose_rmse(R, t, R_gt, t_gt):
    from orb_slam3_ros2_tpu_torch.io import synthetic

    est = -np.einsum("kji,kj->ki", np.asarray(R), np.asarray(t))
    gt = -np.einsum("kji,kj->ki", R_gt, t_gt)
    return float(synthetic.ate_rmse(est, gt))


def run(K: int = 64, B: int = 4, iters: int = 15, device="cuda") -> dict:
    """The bench's JSON blob (`problem`, `results`) for K keyframes in B
    blocks, `iters` LM iterations per solve, on `device`."""
    from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod
    from orb_slam3_ros2_tpu_torch.backend import schur

    dev = check_device(device)
    KB = K // B
    sc = build_corridor(K=K)
    L = sc["X_gt"].shape[0]
    w_full = sc["vis"].astype(np.float32)
    print(f"corridor: {K} kf, {L} lm, "
          f"{int(w_full.sum())} obs, mean track len "
          f"{w_full.sum(0).mean():.1f}", file=sys.stderr)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    uv_d, w_d = f32(sc["uv"]), f32(w_full)

    def full_problem(R, t, X):
        return ba_mod.BAProblem(
            R=f32(R), t=f32(t), X=f32(X), uv=uv_d, w=w_d,
            fixed=torch.as_tensor(np.arange(K) == 0, device=dev),
            point_valid=torch.ones(L, dtype=torch.bool, device=dev))

    def full_cost(R, t, X):
        return float(schur.robust_cost(f32(R), f32(t), f32(X), uv_d, w_d,
                                       FX, FY, CX, CY))

    results = {}
    results["initial"] = dict(
        pose_rmse_m=round(pose_rmse(sc["R0"], sc["t0"],
                                    sc["R_gt"], sc["t_gt"]), 4),
        full_cost=round(full_cost(sc["R0"], sc["t0"], sc["X0"]), 1))

    # ---- global ----
    p_full = full_problem(sc["R0"], sc["t0"], sc["X0"])
    # one untimed solve first, so the timed one (and the blocks after it)
    # run warm
    ba_mod.bundle_adjust(p_full, FX, FY, CX, CY, n_iters=iters)
    sync(dev)
    t0 = time.perf_counter()
    g = ba_mod.bundle_adjust(p_full, FX, FY, CX, CY, n_iters=iters)
    sync(dev)
    wall_g = time.perf_counter() - t0
    gR, gt_, gX = (a.cpu().numpy() for a in (g.R, g.t, g.X))
    results["global"] = dict(
        pose_rmse_m=round(pose_rmse(gR, gt_, sc["R_gt"], sc["t_gt"]), 4),
        full_cost=round(full_cost(gR, gt_, gX), 1),
        wall_s=round(wall_g, 2), ms_per_iter=wall_g * 1e3 / iters)

    # ---- block rounds ----
    lm_owner = np.argmax(
        np.add.reduceat(w_full, np.arange(0, K, KB), axis=0), axis=0)

    def block_round(R_cur, t_cur, X_cur):
        """One Gauss-Seidel sweep: each block solves its own keyframes +
        owned landmarks with the out-of-block observers of those
        landmarks held fixed (the boundary ring), taking its neighbours'
        latest values (plain Jacobi oscillates on the corridor's strongly
        coupled chain)."""
        R_new, t_new = R_cur.copy(), t_cur.copy()
        X_new = X_cur.copy()
        R_cur, t_cur, X_cur = R_new, t_new, X_new
        for b in range(B):
            own_kf = np.arange(b * KB, (b + 1) * KB)
            own_lm = np.where(lm_owner == b)[0]
            w_b = np.zeros_like(w_full)
            w_b[:, own_lm] = w_full[:, own_lm]
            ring = np.where((w_b.sum(1) > 0)
                            & ~np.isin(np.arange(K), own_kf))[0]
            sel_kf = np.concatenate([own_kf, ring])
            fixed = np.zeros(len(sel_kf), bool)
            fixed[len(own_kf):] = True
            fixed[sel_kf == 0] = True
            # the block's own keyframes keep their observations of foreign
            # landmarks (held fixed through point_valid): without those
            # cross terms each block overfits its own landmarks and the
            # sweep oscillates
            w_b[own_kf] = w_full[own_kf]
            pv = np.zeros(L, bool)
            pv[own_lm] = True
            p = ba_mod.BAProblem(
                R=f32(R_cur[sel_kf]), t=f32(t_cur[sel_kf]), X=f32(X_cur),
                uv=f32(sc["uv"][sel_kf]), w=f32(w_b[sel_kf]),
                fixed=torch.as_tensor(fixed, device=dev),
                point_valid=torch.as_tensor(pv, device=dev))
            r = ba_mod.bundle_adjust(p, FX, FY, CX, CY, n_iters=iters)
            R_new[own_kf] = r.R[:KB].cpu().numpy()
            t_new[own_kf] = r.t[:KB].cpu().numpy()
            X_new[own_lm] = r.X.cpu().numpy()[own_lm]
        return R_new, t_new, X_new

    Rk, tk, Xk = sc["R0"], sc["t0"], sc["X0"]
    wall_acc = 0.0
    for rnd in range(1, 5):
        t0 = time.perf_counter()
        Rk, tk, Xk = block_round(Rk, tk, Xk)
        wall_acc += time.perf_counter() - t0
        key = ("block_fixed_boundary" if rnd == 1
               else f"block_round_{rnd}")
        results[key] = dict(
            pose_rmse_m=round(pose_rmse(Rk, tk, sc["R_gt"], sc["t_gt"]), 4),
            full_cost=round(full_cost(Rk, tk, Xk), 1),
            wall_s=round(wall_acc, 2),
            ms_per_iter=wall_acc * 1e3 / (rnd * B * iters))
    results["block_fixed_boundary"]["note"] = NOTE.format(B=B, KB=KB)
    results["analysis"] = ANALYSIS
    return dict(
        problem=dict(K=K, L=int(L), blocks=B, iters_per_solve=iters,
                     obs=int(w_full.sum())),
        results=results, card=card(dev))


def main(argv=None) -> dict:
    """Runs the bench, prints its JSON, writes it to `--out` and returns
    it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="BLOCKBA_TORCH.json")
    ap.add_argument("--kf", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--iters", type=int, default=15)
    add_device(ap)
    args = ap.parse_args(argv)
    dev = device_of(ap, args)
    blob = run(args.kf, args.blocks, args.iters, dev)
    print(json.dumps(blob, indent=1))
    with open(args.out, "w") as f:
        json.dump(blob, f, indent=1)
    return blob


if __name__ == "__main__":
    main()
