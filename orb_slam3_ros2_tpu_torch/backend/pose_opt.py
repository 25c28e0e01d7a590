"""Pose-only robust LM — the plain version of the fused pose kernel.

Port of `orb_slam3_ros2_tpu/backend/pose_opt.py`: 3 rounds × 5 LM
iterations with Huber weights on the σ-weighted squared residual, a
cheirality drop at depth 0.05, outliers re-classified by chi² at each round
boundary (and re-admitted when they fall back under the threshold), one
residual/Jacobian evaluation per iteration with the accepted system carried
along. The accept/reject selects are `torch.where` on 0-d tensors, so the
loop never waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.backend import residuals as res
from orb_slam3_ros2_tpu_torch.geom import lie
from orb_slam3_ros2_tpu_torch.ops.chol_small import cholesky_solve_small

# δ ≈ 2.447, the reference's mono Huber, rounded to f32 as the JAX package's
# `jnp.sqrt(res.CHI2_MONO)` is
HUBER_MONO = float(np.sqrt(np.float32(res.CHI2_MONO)))


class PoseOptResult(NamedTuple):
    R: torch.Tensor  # (3, 3) optimized T_cw rotation
    t: torch.Tensor  # (3,)
    inliers: torch.Tensor  # (N,) bool — survived chi² gating
    n_inliers: torch.Tensor  # () int32
    cost: torch.Tensor  # () final robust cost


def _huber_rho(chi2: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber loss on the squared residual (matches res.huber_weight)."""
    return torch.where(
        chi2 <= delta * delta, chi2,
        2.0 * delta * torch.sqrt(torch.clamp(chi2, min=1e-12)) - delta * delta)


def _eval_system(R, t, X, uv, inv_sigma2, w_active, fx, fy, cx, cy):
    """One residual/Jacobian pass -> (H, b, cost, chi2, pos)."""
    delta = HUBER_MONO
    proj = res.reproj_residual(R, t, X, uv, fx, fy, cx, cy)
    chi2 = torch.sum(proj.r * proj.r, dim=-1) * inv_sigma2
    pos = proj.depth > 0.05
    hw = res.huber_weight(chi2, delta)
    ww = w_active * hw * pos
    Ja = torch.cat([proj.J_pose, proj.r[..., None]], dim=-1)  # (N, 2, 7)
    G = torch.einsum("nai,n,naj->ij", Ja, ww, Ja)
    cost = torch.sum(_huber_rho(chi2, delta) * (w_active > 0))
    return G[:6, :6], G[:6, 6], cost, chi2, pos


def optimize_pose(R0, t0, X, uv, inv_sigma2, mask, fx, fy, cx, cy,
                  n_rounds: int = 3, iters_per_round: int = 5,
                  chi2_th: float = res.CHI2_MONO) -> PoseOptResult:
    """Robust LM pose refinement with per-round outlier re-classification.

    X (N, 3) world points, uv (N, 2) undistorted pixels, inv_sigma2 (N,),
    mask (N,) bool."""
    dev = X.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    lam = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    w_base = inv_sigma2 * mask.to(torch.float32)
    R, t = R0, t0
    chi2v = torch.zeros_like(inv_sigma2)
    posv = torch.ones_like(inv_sigma2, dtype=torch.bool)
    for rnd in range(n_rounds):
        if rnd == 0:
            w_active = w_base
        else:
            w_active = w_base * ((chi2v <= chi2_th) & posv & mask)
        H, b, cost, chi2v, posv = _eval_system(
            R, t, X, uv, inv_sigma2, w_active, fx, fy, cx, cy)
        for _ in range(iters_per_round):
            Hd = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye6
            dx = -cholesky_solve_small(Hd, b)
            R_c, t_c = lie.se3_retract(R, t, dx)
            R_c = lie.se3_normalize(R_c)
            H_c, b_c, cost_c, chi2_c, pos_c = _eval_system(
                R_c, t_c, X, uv, inv_sigma2, w_active, fx, fy, cx, cy)
            better = cost_c < cost
            R = torch.where(better, R_c, R)
            t = torch.where(better, t_c, t)
            H = torch.where(better, H_c, H)
            b = torch.where(better, b_c, b)
            cost = torch.where(better, cost_c, cost)
            chi2v = torch.where(better, chi2_c, chi2v)
            posv = torch.where(better, pos_c, posv)
            lam = torch.where(better, lam * 0.5, lam * 4.0).clamp(1e-7, 1e2)

    inliers = (chi2v <= chi2_th) & posv & mask
    rho = _huber_rho(chi2v, HUBER_MONO)
    return PoseOptResult(
        R=R, t=t, inliers=inliers,
        n_inliers=torch.sum(inliers).to(torch.int32),
        cost=torch.sum(rho * inliers))
