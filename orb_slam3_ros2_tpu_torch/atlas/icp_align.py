"""Map-to-map ICP localization (the reference's libpointmatcher side-car).

Port of `orb_slam3_ros2_tpu/atlas/icp_align.py`: a fixed-iteration
point-to-plane ICP that localizes one map's point cloud in another's.

* surface normals by k-NN PCA, the k-nearest-neighbour search a dense
  pairwise-distance matmul + top-k (no KD-tree: at 10^3..10^4 points one
  distance matrix is cheap on a GPU);
* correspondences as a masked argmin over the same distance matmul;
* trimmed robust weighting (a distance quantile);
* a 6-DoF Gauss-Newton step from the 6x6 normal equations
  (`ops/chol_small.cholesky_solve_small`), over a fixed iteration budget.

Clouds are subsampled to fixed capacities with numpy's `default_rng`
(`_fixed_subsample`, copied from the JAX module's lines 139-150), so both
packages align the same points.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.geom import lie
from orb_slam3_ros2_tpu_torch.ops.chol_small import cholesky_solve_small

BIG = 1e9


class IcpResult(NamedTuple):
    R: torch.Tensor  # (3, 3) dst-from-src rotation
    t: torch.Tensor  # (3,) dst-from-src translation
    rms: torch.Tensor  # () trimmed point-to-plane RMS at the last iteration
    inlier_frac: torch.Tensor  # () fraction of src points within match_radius


def _pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 3) x (M, 3) -> (N, M) squared distances via the matmul identity."""
    aa = torch.sum(a * a, dim=-1, keepdim=True)
    bb = torch.sum(b * b, dim=-1, keepdim=True).T
    return (aa + bb - 2.0 * (a @ b.T)).clamp(min=0.0)


def estimate_normals(pts: torch.Tensor, mask: torch.Tensor,
                     knn: int = 5) -> torch.Tensor:
    """Per-point unit normals from k-NN PCA (SurfaceNormalDataPointsFilter
    knn=5), oriented away from the masked centroid (the sign does not
    enter the point-to-plane objective)."""
    n_pts = pts.shape[0]
    d2 = _pairwise_sq_dists(pts, pts)
    d2 = torch.where(mask[None, :], d2, torch.full_like(d2, BIG))
    # exclude self-match by pushing the diagonal out
    d2 = d2 + torch.eye(n_pts, dtype=d2.dtype, device=d2.device) * BIG
    idx = torch.topk(-d2, knn, dim=1).indices  # (N, knn)
    nb = pts[idx]  # (N, knn, 3)
    X = nb - nb.mean(dim=1, keepdim=True)
    C = torch.einsum("nki,nkj->nij", X, X)
    # smallest eigenvector of each 3x3 covariance
    n = torch.linalg.eigh(C).eigenvectors[..., 0]
    mf = mask.to(pts.dtype)
    centroid = (pts * mf[:, None]).sum(0) / mf.sum().clamp(min=1.0)
    sign = torch.sign(torch.sum(n * (pts - centroid), dim=-1))
    return n * torch.where(sign == 0, torch.ones_like(sign), sign)[:, None]


def icp_point_to_plane(
    src: torch.Tensor,  # (N, 3)
    src_mask: torch.Tensor,  # (N,) bool
    dst: torch.Tensor,  # (M, 3)
    dst_normals: torch.Tensor,  # (M, 3)
    dst_mask: torch.Tensor,  # (M,) bool
    R0: torch.Tensor,
    t0: torch.Tensor,
    iters: int = 30,
    trim: float = 0.75,
    match_radius: float = 0.5,
) -> IcpResult:
    """Trimmed point-to-plane ICP; returns T such that dst ≈ R @ src + t.
    The iteration `lax.scan` is a Python loop with no host sync."""
    src = src.to(torch.float32)
    dst = dst.to(torch.float32)
    dev = src.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    n_src = src_mask.to(torch.float32).sum().clamp(min=1.0)
    R, t = R0.to(torch.float32), t0.to(torch.float32)
    rms = inl = None
    for _ in range(iters):
        p = src @ R.T + t  # (N, 3) transformed src
        d2 = torch.where(dst_mask[None, :], _pairwise_sq_dists(p, dst), big)
        d2_min, j = torch.min(d2, dim=1)  # first minimum, as jnp.argmin
        q, n = dst[j], dst_normals[j]
        dist = torch.sqrt(d2_min)
        r = torch.sum(n * (p - q), dim=-1)  # point-to-plane residual
        # trimmed weights: keep the best `trim` fraction of valid matches
        dist_v = torch.where(src_mask, dist, big)
        thr = torch.nanquantile(
            torch.where(src_mask, dist, torch.full_like(dist, float("nan"))),
            trim)
        w = (src_mask & (dist_v <= thr.clamp(max=match_radius))).to(
            torch.float32)
        # left-perturbation Jacobian rows: [n, p x n] for xi = [rho, phi]
        J = torch.cat([n, torch.linalg.cross(p, n)], dim=-1)  # (N, 6)
        Jw = J * w[:, None]
        H = Jw.T @ J + 1e-6 * eye6
        g = Jw.T @ r
        xi = -cholesky_solve_small(H, g)
        R, t = lie.se3_retract(R, t, xi)
        R = lie.se3_normalize(R)
        n_w = w.sum()
        # no correspondences inside match_radius -> +inf, not a
        # perfect-looking 0.0 (registration failed / init too far off)
        rms = torch.where(
            n_w > 0, torch.sqrt(torch.sum(w * r * r) / n_w.clamp(min=1.0)),
            torch.tensor(float("inf"), device=dev))
        inl = (dist_v < match_radius).to(torch.float32).sum() / n_src
    return IcpResult(R=R, t=t, rms=rms, inlier_frac=inl)


def _fixed_subsample(pts: np.ndarray, n: int, seed: int = 0):
    """Random subsample/pad to exactly n points + validity mask (the
    sampling data-filter stage, with a static output shape)."""
    rng = np.random.default_rng(seed)
    m = pts.shape[0]
    if m == 0:
        return np.zeros((n, 3), np.float32), np.zeros(n, bool)
    idx = rng.permutation(m)[:n] if m >= n else rng.integers(0, m, n)
    mask = np.ones(n, bool)
    if m < n:
        mask[:] = True  # repeated points are still valid constraints
    return pts[idx].astype(np.float32), mask


def align_maps(
    src_pts: np.ndarray,
    dst_pts: np.ndarray,
    init_T: Optional[np.ndarray] = None,
    n_src: int = 2048,
    n_dst: int = 4096,
    iters: int = 30,
    trim: float = 0.75,
    match_radius: float = 0.5,
    knn: int = 5,
    device=None,
) -> Tuple[np.ndarray, dict]:
    """Localize one map's point cloud in another's: build a new map, then
    ICP it against the saved one. Returns (T, stats) with T (4, 4) mapping
    src-map coordinates into dst-map coordinates. Runs on the card
    (`device`, default "cuda"); pass device="cpu" for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"align_maps(device={device!r}): no CUDA device is available; "
            "pass device=\"cpu\" to run on the CPU")
    src, src_mask = _fixed_subsample(np.asarray(src_pts, np.float32), n_src, 0)
    dst, dst_mask = _fixed_subsample(np.asarray(dst_pts, np.float32), n_dst, 1)
    if init_T is None:
        init_T = np.eye(4)
        # centroid initialization: aligns translation when no prior is given
        if src_mask.any() and dst_mask.any():
            init_T[:3, 3] = dst[dst_mask].mean(0) - src[src_mask].mean(0)

    def T(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    dst_t, dst_m = T(dst), T(dst_mask, torch.bool)
    normals = estimate_normals(dst_t, dst_m, knn=knn)
    res = icp_point_to_plane(T(src), T(src_mask, torch.bool), dst_t, normals,
                             dst_m, T(init_T[:3, :3]), T(init_T[:3, 3]),
                             iters=iters, trim=trim,
                             match_radius=match_radius)
    out = np.eye(4)
    out[:3, :3] = res.R.cpu().numpy()
    out[:3, 3] = res.t.cpu().numpy()
    stats = {"rms": float(res.rms), "inlier_frac": float(res.inlier_frac)}
    return out, stats
