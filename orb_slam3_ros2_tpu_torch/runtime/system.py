"""The per-frame tracking program of the System: extract → undistort →
constant-velocity prediction → track_frame → counter bumps.

Port of `undistort` and `frame_step` from `System._build_jitted`
(`orb_slam3_ros2_tpu/runtime/system.py:205-210, 422-450`). The `System`
class itself (initialization, keyframe mapping, relocalization, loop
closing) is not ported yet; `frame_step` takes the camera, the extractor
and the map as arguments instead of reading them from a System.
"""

from __future__ import annotations

import dataclasses

import torch

from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
from orb_slam3_ros2_tpu_torch.frontend import tracking as trk
from orb_slam3_ros2_tpu_torch.geom import lie
from orb_slam3_ros2_tpu_torch.models import cameras as cam_mod

MIN_TRACK_INLIERS = 15  # System.MIN_TRACK_INLIERS
MATCH_CAP_VISIBLE = 4096  # System.MATCH_CAP_VISIBLE


def undistort(cam: cam_mod.Camera, uv: torch.Tensor) -> torch.Tensor:
    """Raw pixels -> undistorted pinhole pixels of the same intrinsics."""
    rays = cam_mod.unproject(cam, uv)
    return torch.stack([cam.fx * rays[..., 0] + cam.cx,
                        cam.fy * rays[..., 1] + cam.cy], dim=-1)


def frame_step(m: ms.MapState, R_cur, t_cur, R_prev, t_prev,
               img: torch.Tensor, cam: cam_mod.Camera,
               ex_cfg: ex.ExtractorConfig):
    """Track one image against the map under a constant-velocity prediction
    from the last two poses (all T_cw).

    Returns (m2, f_u, obs_clean, R, t, summary): the map with its
    visible/found counters bumped, the features with undistorted uv, the
    inlier associations, the tracked pose and the (16,) summary of
    `trk.track_frame`."""
    f = ex.make_extractor(ex_cfg)(img)
    uv_u = undistort(cam, f.uv)
    # T_pred = (T_cur ∘ T_prev⁻¹) ∘ T_cur
    R_v, t_v = lie.se3_compose(R_cur, t_cur, *lie.se3_inverse(R_prev, t_prev))
    R_pred, t_pred = lie.se3_compose(R_v, t_v, R_cur, t_cur)
    L = m.lm_valid.shape[0]
    cap_vis = MATCH_CAP_VISIBLE if L > MATCH_CAP_VISIBLE else None
    tm, res, obs_clean, summary = trk.track_frame(
        m, uv_u, f.bits, f.mask, f.level, R_pred, t_pred,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
        scale_factor=ex_cfg.scale_factor, min_matches=MIN_TRACK_INLIERS,
        cap_visible=cap_vis)
    m2 = m._replace(lm_visible=m.lm_visible + tm.lm_visible_inc,
                    lm_found=m.lm_found + tm.lm_found_inc)
    return (m2, dataclasses.replace(f, uv=uv_u), obs_clean, res.R, res.t,
            summary)
