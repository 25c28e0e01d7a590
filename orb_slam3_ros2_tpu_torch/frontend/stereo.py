"""Stereo and RGB-D observations: metric 3-D points for left features.

Port of `orb_slam3_ros2_tpu/frontend/stereo.py`. Three builders give one
`StereoObs` (left-camera-frame point, depth, validity per left feature):

* `match_stereo` + `obs_from_rectified`: rectified scanline search, a
  row-band gate on the dense (N, M) Hamming matrix, depth z = fx·b/d;
* `match_stereo_general`: a non-rectified two-view rig under
  `Stereo.T_c1_c2` (the KannalaBrandt8 fisheye path), an epipolar-plane
  gate on unit rays and midpoint triangulation;
* `obs_from_depth`: a registered depth map sampled at each raw keypoint.

The gates and distance matrices are plain torch, as the JAX package
computes them outside any kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_ros2_tpu_torch.ops import matcher


class StereoMatch(NamedTuple):
    depth: torch.Tensor  # (N,) metric depth for left features (0 = invalid)
    disparity: torch.Tensor  # (N,)
    right_u: torch.Tensor  # (N,) matched right-image column
    valid: torch.Tensor  # (N,)


class StereoObs(NamedTuple):
    """Per-left-feature 3-D point in the left camera frame, from either
    stereo path or a depth map; consumed by landmark spawning."""

    X_cam: torch.Tensor  # (N, 3) left-camera-frame points (0 where invalid)
    depth: torch.Tensor  # (N,) z in the left camera
    valid: torch.Tensor  # (N,)


def match_stereo(uv_l, signs_l, mask_l, lvl_l, uv_r, signs_r, mask_r, lvl_r,
                 fx: float, baseline: float, max_dist: float = 60.0,
                 row_tol: float = 2.0, min_disp: float = 0.5,
                 max_depth: float = 60.0) -> StereoMatch:
    """Row-banded descriptor matching; metric depth per left feature."""
    # same scanline (tolerance 1.25^level), disparity within
    # [fx·b/max_depth, fx·b/0.3], pyramid levels at most one apart
    row_gap = (uv_l[:, None, 1] - uv_r[None, :, 1]).abs()
    lvl_max = torch.maximum(lvl_l[:, None], lvl_r[None, :])
    tol = row_tol * torch.pow(1.25, lvl_max.to(torch.float32))
    disp = uv_l[:, None, 0] - uv_r[None, :, 0]
    min_d = fx * baseline / max_depth
    gate = ((row_gap <= tol)
            & (disp >= max(min_disp, min_d))
            & (disp <= fx * baseline / 0.3)
            & ((lvl_l[:, None] - lvl_r[None, :]).abs() <= 1))
    res = matcher.match(signs_l, mask_l, signs_r, mask_r, max_dist=max_dist,
                        ratio=0.9, gate=gate, mutual=True)
    idx = torch.where(res.valid, res.idx, 0).long()
    ur = uv_r[idx, 0]
    d = uv_l[:, 0] - ur
    valid = res.valid & (d > min_disp)
    zero = torch.zeros_like(d)
    depth = torch.where(valid, fx * baseline / d.clamp_min(1e-6), zero)
    return StereoMatch(depth=depth, disparity=torch.where(valid, d, zero),
                       right_u=ur, valid=valid)


def backproject(uv, depth, fx, fy, cx, cy) -> torch.Tensor:
    """Left-camera-frame 3-D points from rectified pixels + depth."""
    x = (uv[:, 0] - cx) / fx * depth
    y = (uv[:, 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def obs_from_rectified(sm: StereoMatch, uv_l, fx, fy, cx, cy) -> StereoObs:
    X = backproject(uv_l, sm.depth, fx, fy, cx, cy)
    return StereoObs(X_cam=X, depth=sm.depth, valid=sm.valid)


def obs_from_depth(uv_raw, uv_undist, mask, depth_img, fx, fy, cx, cy,
                   min_depth: float = 0.05,
                   max_depth: float = 40.0) -> StereoObs:
    """RGB-D observations: depth sampled at the nearest pixel of the raw
    keypoint (round half to even, as `jnp.round`), backprojected through
    the undistorted pixel."""
    H, W = depth_img.shape
    u = torch.round(uv_raw[:, 0]).to(torch.int64).clamp(0, W - 1)
    v = torch.round(uv_raw[:, 1]).to(torch.int64).clamp(0, H - 1)
    d = depth_img[v, u]
    valid = mask & torch.isfinite(d) & (d > min_depth) & (d < max_depth)
    d = torch.where(valid, d, torch.zeros_like(d))
    X = backproject(uv_undist, d, fx, fy, cx, cy)
    return StereoObs(X_cam=torch.where(valid[:, None], X, torch.zeros_like(X)),
                     depth=d, valid=valid)


def match_stereo_general(rays_l, signs_l, mask_l, lvl_l, rays_r, signs_r,
                         mask_r, lvl_r, R12, t12, max_dist: float = 60.0,
                         eps_epi: float = 6e-3, min_depth: float = 0.3,
                         max_depth: float = 60.0,
                         scale_factor: float = 1.2) -> StereoObs:
    """Non-rectified stereo: epipolar-gated descriptor matching on unit-z
    rays and midpoint triangulation under x_c1 = R12 x_c2 + t12
    (`Stereo.T_c1_c2`)."""
    nl = rays_l / torch.linalg.norm(rays_l, dim=-1, keepdim=True)
    b = rays_r @ R12.T
    nb = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    # epipolar plane of each right ray: normal t12 x b (both in c1)
    n = torch.linalg.cross(t12.expand_as(nb), nb, dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
    # angular distance of the left ray from that plane, coarser at higher
    # pyramid levels
    epi = (nl @ n.T).abs()
    lvl_max = torch.maximum(lvl_l[:, None], lvl_r[None, :])
    tol = eps_epi * torch.pow(scale_factor, lvl_max.to(torch.float32))
    # parallax: the rays must part by more than the baseline subtends at
    # max_depth
    cos_par = nl @ nb.T
    theta_min = torch.linalg.norm(t12) / max_depth
    gate = ((epi <= tol) & (cos_par <= torch.cos(theta_min))
            & ((lvl_l[:, None] - lvl_r[None, :]).abs() <= 1))
    res = matcher.match(signs_l, mask_l, signs_r, mask_r, max_dist=max_dist,
                        ratio=0.9, gate=gate, mutual=True)
    idx = torch.where(res.valid, res.idx, 0).long()
    bm = nb[idx]  # (N, 3) matched right ray in c1
    # x = d1·nl on the left ray, x = t12 + d2·bm on the right ray:
    # least-squares d1, d2 from the closed-form 2x2 normal equations
    c = (nl * bm).sum(dim=-1)
    r1t = nl @ t12
    bt = bm @ t12
    den = (1.0 - c * c).clamp_min(1e-12)
    d2 = (c * r1t - bt) / den
    d1 = r1t + c * d2
    X = d1[:, None] * nl
    depth = X[:, 2]
    valid = (res.valid & (d1 > 0) & (d2 > 0) & (depth > min_depth)
             & (depth < max_depth))
    return StereoObs(X_cam=torch.where(valid[:, None], X, torch.zeros_like(X)),
                     depth=torch.where(valid, depth, torch.zeros_like(depth)),
                     valid=valid)
