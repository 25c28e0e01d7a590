"""Covisibility-aware keyframe partitioning for distributed BA.

numpy only: copied verbatim from `orb_slam3_ros2_tpu/parallel/partition.py`
(lines 23-156: `partition_keyframes`, `cut_fraction`, `shard_indices`,
`boundary_keyframes`), so that the port partitions a keyframe
covisibility graph (`atlas/map_state.covisibility_matrix`) into the same
balanced shards without importing the JAX package. A greedy seeded
region-growing pass plus Kernighan-Lin-style refinement on the host; each
shard becomes a map block of `parallel/block_ba.py`, with the boundary
keyframes held fixed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def partition_keyframes(covis: np.ndarray, n_shards: int,
                        refine_passes: int = 4) -> np.ndarray:
    """Partition K keyframes into `n_shards` balanced shards minimizing the
    covisibility weight cut. Returns (K,) int shard assignment.

    covis: (K, K) symmetric non-negative weights (shared-landmark counts),
    diagonal ignored.
    """
    W = np.asarray(covis, np.float64).copy()
    K = W.shape[0]
    np.fill_diagonal(W, 0.0)
    if n_shards <= 1 or K <= n_shards:
        return (np.arange(K) % max(n_shards, 1)).astype(np.int32)
    cap = int(np.ceil(K / n_shards))

    # --- seeds: strongest-degree first, then farthest-point (weakest max
    # coupling to existing seeds) so seeds land in different map regions
    deg = W.sum(1)
    seeds = [int(np.argmax(deg))]
    while len(seeds) < n_shards:
        coupling = W[:, seeds].max(1)
        coupling[seeds] = np.inf
        # among weakly-coupled candidates prefer high degree (real regions,
        # not isolated keyframes)
        cand = np.where(coupling <= np.quantile(coupling[np.isfinite(
            coupling)], 0.25))[0]
        cand = cand[~np.isin(cand, seeds)]
        if len(cand) == 0:
            cand = np.setdiff1d(np.arange(K), seeds)
        seeds.append(int(cand[np.argmax(deg[cand])]))

    assign = np.full(K, -1, np.int32)
    size = np.zeros(n_shards, np.int64)
    for s, kf in enumerate(seeds):
        assign[kf] = s
        size[s] = 1

    # --- greedy growth: repeatedly take the (kf, shard) pair with the
    # largest attachment weight among shards under capacity
    gain = W[:, seeds].copy()  # (K, S) attachment of each kf to each shard
    gain[assign >= 0] = -np.inf
    while (assign < 0).any():
        g = gain.copy()
        g[:, size >= cap] = -np.inf
        kf, s = np.unravel_index(np.argmax(g), g.shape)
        if not np.isfinite(g[kf, s]):
            # disconnected leftovers: fill smallest shards
            for kf in np.where(assign < 0)[0]:
                s = int(np.argmin(size))
                assign[kf] = s
                size[s] += 1
            break
        assign[kf] = s
        size[s] += 1
        gain[kf] = -np.inf
        free = assign < 0
        gain[free, s] += W[free, kf]

    # --- refinement: move keyframes toward their dominant shard when the
    # cut improves and balance (±1 of cap) allows
    for _ in range(refine_passes):
        moved = False
        # attachment of every kf to every shard
        att = np.zeros((K, n_shards))
        for s in range(n_shards):
            att[:, s] = W[:, assign == s].sum(1)
        order = np.argsort(-deg)
        for kf in order:
            cur = assign[kf]
            best = int(np.argmax(att[kf]))
            if best == cur:
                continue
            if size[best] + 1 > cap or size[cur] - 1 < 1:
                continue
            if att[kf, best] <= att[kf, cur]:
                continue
            assign[kf] = best
            size[cur] -= 1
            size[best] += 1
            att[:, cur] -= W[:, kf]
            att[:, best] += W[:, kf]
            moved = True
        if not moved:
            break
    return assign


def cut_fraction(covis: np.ndarray, assign: np.ndarray) -> float:
    """Fraction of total covisibility weight crossing shard boundaries
    (lower is better; this is the weight that would need cross-device
    anchoring/communication in block BA)."""
    W = np.asarray(covis, np.float64).copy()
    np.fill_diagonal(W, 0.0)
    total = W.sum()
    if total <= 0:
        return 0.0
    cross = W[assign[:, None] != assign[None, :]].sum()
    return float(cross / total)


def shard_indices(assign: np.ndarray, n_shards: int,
                  pad_to: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Turn an assignment into fixed-shape (S, cap) index + validity arrays
    (static shapes for the device program; padding repeats the first
    member so gathers stay in-bounds)."""
    sizes = [int((assign == s).sum()) for s in range(n_shards)]
    cap = max(max(sizes), pad_to, 1)
    idx = np.zeros((n_shards, cap), np.int32)
    valid = np.zeros((n_shards, cap), bool)
    for s in range(n_shards):
        members = np.where(assign == s)[0]
        if len(members) == 0:
            continue
        idx[s, : len(members)] = members
        idx[s, len(members):] = members[0]
        valid[s, : len(members)] = True
    return idx, valid


def boundary_keyframes(covis: np.ndarray, assign: np.ndarray) -> np.ndarray:
    """(K,) bool: keyframes with covisibility into another shard. These are
    the fixed separator anchors each block holds constant (the submap
    treatment that keeps blocks independent during concurrent solves)."""
    W = np.asarray(covis, np.float64).copy()
    np.fill_diagonal(W, 0.0)
    cross = (assign[:, None] != assign[None, :]) & (W > 0)
    return cross.any(1)
