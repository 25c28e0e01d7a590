"""Hamming descriptor matching, plain torch.

Port of `orb_slam3_ros2_tpu/ops/matcher.py:35-135`. Descriptors in their ±1
form make the Hamming distance `(256 - a @ b.T) / 2`, a matmul that is exact
in f32. Masking, the ratio test, the mutual check and the rotation histogram
are elementwise passes and reductions around it. Argmins take the first
minimum, as `jnp.argmin` does, so a fully masked row or column resolves to
index 0 in both packages.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import math

import torch

INF = 1e9
N_BITS = 256
ROT_BINS = 30  # rotation-consistency histogram bins


class MatchResult(NamedTuple):
    idx: torch.Tensor  # (N,) int32 — best match in B for each A, -1 if none
    dist: torch.Tensor  # (N,) float32 — Hamming distance of that match
    valid: torch.Tensor  # (N,) bool


def hamming_matrix(signs_a: torch.Tensor, signs_b: torch.Tensor) -> torch.Tensor:
    """(N, 256) ±1 × (M, 256) ±1 -> (N, M) Hamming distances (exact f32)."""
    return (N_BITS - signs_a @ signs_b.T) * 0.5


def first_argmin(d: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first minimum along `dim` (jnp.argmin's tie rule)."""
    mn = d.amin(dim=dim, keepdim=True)
    n = d.shape[dim]
    shape = [1] * d.dim()
    shape[dim] = n
    ids = torch.arange(n, device=d.device).reshape(shape)
    return torch.where(d == mn, ids, n).amin(dim=dim)


def match(
    signs_a: torch.Tensor,
    mask_a: torch.Tensor,
    signs_b: torch.Tensor,
    mask_b: torch.Tensor,
    max_dist: float = 50.0,
    ratio: Optional[float] = 0.9,
    gate: Optional[torch.Tensor] = None,
    angles_a: Optional[torch.Tensor] = None,
    angles_b: Optional[torch.Tensor] = None,
    mutual: bool = True,
    rotation_check: bool = False,
) -> MatchResult:
    """Best-match search A→B with the reference matcher's acceptance rules.

    gate: optional (N, M) bool, True where the pair is allowed. ratio:
    best/second-best acceptance ratio; None disables the test."""
    d = hamming_matrix(signs_a, signs_b)
    allowed = mask_a[:, None] & mask_b[None, :]
    if gate is not None:
        allowed = allowed & gate
    d = torch.where(allowed, d, INF)

    best_idx = first_argmin(d, 1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    ok = (best <= max_dist) & mask_a
    if ratio is not None:
        cols = torch.arange(d.shape[1], device=d.device)[None, :]
        second = torch.where(cols == best_idx[:, None], INF, d).amin(dim=1)
        ok = ok & (best < ratio * second)

    if mutual:
        best_b = first_argmin(d, 0)
        ok = ok & (best_b[best_idx] == torch.arange(d.shape[0], device=d.device))

    if rotation_check and angles_a is not None and angles_b is not None:
        two_pi = 2.0 * math.pi
        rot = torch.remainder(angles_a - angles_b[best_idx], two_pi)
        bins = torch.floor(rot / (two_pi / ROT_BINS)).long() % ROT_BINS
        hist = torch.zeros((ROT_BINS,), dtype=torch.float32, device=d.device)
        hist.index_add_(0, bins, ok.to(torch.float32))
        # keep the 3 dominant bins; ties keep the lower bin, as lax.top_k
        top3 = torch.sort(hist, descending=True, stable=True).indices[:3]
        ok = ok & (bins[:, None] == top3[None, :]).any(dim=1)

    idx = torch.where(ok, best_idx.to(torch.int32), -1)
    return MatchResult(idx=idx, dist=best, valid=ok)


def window_gate(uv_a: torch.Tensor, uv_b: torch.Tensor, radius: float):
    """(N, M) True where |uv_a - uv_b| lies within a square search window."""
    dx = (uv_a[:, None, 0] - uv_b[None, :, 0]).abs()
    dy = (uv_a[:, None, 1] - uv_b[None, :, 1]).abs()
    return (dx <= radius) & (dy <= radius)
