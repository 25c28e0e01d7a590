"""Sim(3) solver for loop closing and map merging.

Port of `orb_slam3_ros2_tpu/loop/sim3.py`: RANSAC over 3-point Horn
(Umeyama) alignments between matched 3-D landmarks, all hypotheses as one
batched (NH, 3, 3) SVD and a broadcast inlier count, then a refinement on
the best hypothesis' inliers.

The draw is split from the scoring: `solve_sim3_from_samples` scores given
(NH, 3) sample indices (the tests feed it the JAX draw,
`jax.random.categorical` over the masked points), and `solve_sim3` draws
them from a `torch.Generator`, uniformly over the masked points with
replacement, as the JAX draw does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

N_HYPO = 128


class Sim3Result(NamedTuple):
    ok: torch.Tensor  # () bool
    R: torch.Tensor  # (3, 3): x1 ≈ s R x2 + t
    t: torch.Tensor  # (3,)
    s: torch.Tensor  # ()
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int32


def _reflection_fix(U, Vt):
    """diag(1, 1, sign det(U Vt)), batched."""
    det = torch.linalg.det(U @ Vt)
    S = torch.eye(3, dtype=U.dtype, device=U.device).expand(
        U.shape).clone()
    S[..., 2, 2] = torch.sign(det)
    return S


def _umeyama(x2: torch.Tensor, x1: torch.Tensor, fix_scale: bool):
    """Batched Horn alignment x1 ≈ s R x2 + t over x* (B, M, 3)."""
    mu1 = x1.mean(dim=1, keepdim=True)
    mu2 = x2.mean(dim=1, keepdim=True)
    c1 = x1 - mu1
    c2 = x2 - mu2
    cov = torch.einsum("bmi,bmj->bij", c1, c2) / x1.shape[1]
    U, D, Vt = torch.linalg.svd(cov)
    S = _reflection_fix(U, Vt)
    R = U @ S @ Vt
    var2 = torch.einsum("bmi,bmi->b", c2, c2) / x2.shape[1]
    if fix_scale:
        s = torch.ones_like(var2)
    else:
        s = torch.einsum("bii->b", D[:, :, None] * S) / var2.clamp(min=1e-12)
    t = mu1[:, 0] - s[:, None] * torch.einsum("bij,bj->bi", R, mu2[:, 0])
    return R, t, s


def sample_triples(gen: torch.Generator, mask: torch.Tensor,
                   n_hypo: int = N_HYPO) -> torch.Tensor:
    """(n_hypo, 3) indices drawn uniformly over the masked points, with
    replacement, on the generator's device (any index when none is
    masked; the result then fails its inlier bar)."""
    w = mask.to(device=gen.device, dtype=torch.float32)
    w = torch.where(w.sum() > 0, w, torch.ones_like(w))
    return torch.multinomial(w.expand(n_hypo, -1).contiguous(), 3,
                             replacement=True, generator=gen).to(mask.device)


def solve_sim3_from_samples(idx: torch.Tensor, X1: torch.Tensor,
                            X2: torch.Tensor, mask: torch.Tensor,
                            fix_scale: bool = False, inlier_th: float = 0.05,
                            min_inliers: int = 12) -> Sim3Result:
    """Score the hypotheses of the (NH, 3) samples `idx` (x1 ≈ s R x2 + t;
    inliers within `inlier_th` times the median landmark distance of X1),
    then refine on the best one's inliers."""
    idx = idx.long()
    R, t, s = _umeyama(X2[idx], X1[idx], fix_scale)
    pred = s[:, None, None] * torch.einsum("bij,nj->bni", R, X2) + t[:, None]
    err = torch.linalg.norm(pred - X1[None], dim=-1)
    # torch.quantile(0.5) averages the two middle values, as jnp.median
    scale_ref = torch.quantile(
        torch.where(mask, torch.linalg.norm(X1, dim=-1), 1.0), 0.5)
    th = torch.clamp(inlier_th * scale_ref, min=1e-3)
    inl = (err < th) & mask[None]
    scores = inl.sum(-1)
    # the first maximum, as jnp.argmax
    hyp = torch.arange(scores.shape[0], device=scores.device)
    best = torch.where(scores == scores.max(), hyp, scores.shape[0]).min()

    w = inl[best].to(torch.float32)
    wsum = w.sum().clamp(min=1.0)
    mu1 = (X1 * w[:, None]).sum(0) / wsum
    mu2 = (X2 * w[:, None]).sum(0) / wsum
    c1 = (X1 - mu1) * w[:, None]
    c2 = (X2 - mu2) * w[:, None]
    cov = c1.T @ c2 / wsum
    U, D, Vt = torch.linalg.svd(cov)
    S = _reflection_fix(U, Vt)
    R_f = U @ S @ Vt
    var2 = torch.sum(c2 * c2) / wsum
    s_f = (torch.ones_like(var2) if fix_scale
           else torch.trace(torch.diag(D) @ S) / var2.clamp(min=1e-12))
    t_f = mu1 - s_f * R_f @ mu2
    pred_f = s_f * (R_f @ X2.T).T + t_f
    inl_f = (torch.linalg.norm(pred_f - X1, dim=-1) < th) & mask
    n_inl = inl_f.sum()
    return Sim3Result(ok=n_inl >= min_inliers, R=R_f, t=t_f, s=s_f,
                      inliers=inl_f, n_inliers=n_inl.to(torch.int32))


def solve_sim3(gen: torch.Generator, X1: torch.Tensor, X2: torch.Tensor,
               mask: torch.Tensor, fix_scale: bool = False,
               inlier_th: float = 0.05, min_inliers: int = 12) -> Sim3Result:
    """RANSAC Horn alignment x1 ≈ s R x2 + t over 3-point samples drawn
    from `gen`, then the all-inlier refinement."""
    return solve_sim3_from_samples(
        sample_triples(gen, mask), X1, X2, mask, fix_scale=fix_scale,
        inlier_th=inlier_th, min_inliers=min_inliers)
