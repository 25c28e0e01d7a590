"""The System: the reference's host API over the port's device functions.

Port of `orb_slam3_ros2_tpu/runtime/system.py`. `System.track_monocular`
initializes a map from two views; `System.track_stereo` (rectified
scanline or general two-view rig) and `System.track_rgbd` initialize from
one frame's metric depth. Each frame is then tracked against the map, and
keyframes go through `mapping_step` (insert → triangulate against two
partners → stereo landmarks, for the rig sensors → fuse → local BA → cull)
with one device-to-host fetch per keyframe (the packed summary). Also here: `undistort`, `frame_step` and
`frame_step_vi`, the per-frame programs of the JAX `System._build_jitted`
(:205-210, :422-452, :485-551).

The pipelined mode (`System(pipelined=True)`, the JAX `_track_pipelined`,
:1233-1471): while MONOCULAR tracks, or IMU_MONOCULAR once its IMU is
initialized, each `track_monocular` call dispatches this frame's
`frame_step` (constant velocity from the device pose chain) or
`frame_step_vi` (the pose propagated on the device through the frame's IMU
batch), starts its summary's copy to a pinned host buffer, and consumes
the previous frame's summary (`runtime/staging.py`). Poses, records and
the LOST decision lag one frame; a lost frame drops the frame in flight,
and both are recorded at the last good pose. A MONOCULAR keyframe is
dispatched at consume time and finalized at the next consume (its BoW row
written then); IMU_MONOCULAR keyframes take the staged inertial insertion.
A compaction, loop correction, merge or rescale drops the device chain.
The readers (`get_trajectory`, `get_frame_trajectory`,
`get_keyframe_trajectory`, `get_map_pcl`, `save_atlas`) and every frame of
the staged path first drain the frame in flight (`_flush_pipeline`). The
rig sensors keep the synchronous path, as in JAX. The dispatch half waits
for nothing on the device: the widened retry of `track_frame` is selected
there, and the frame's uploads go through pinned buffers.

Place recognition and the Atlas: the System owns a `loop.vocab.Vocabulary`
(the default codebook, or `vocab_path`: a DBoW2 `.txt`, a codebook or tree
`.npz`) and an `atlas.Atlas` of maps with one BoW database each. After
each keyframe insertion the keyframe's BoW row is written, and with
`loopClosing: 1` (the default when the key is absent) loop closing runs
(cross-map merging, then BoW candidates → temporal consistency → Sim3 →
essential graph → seam fusion → global BA). A lost frame relocalizes in the
active map, then in every other map, and after `LOST_FRAMES_NEW_MAP`
failures a new map is spawned. Keyframe k's BoW row is slot k (the JAX
System gives the initializer's keyframes no row, so its slots trail the
keyframe ids; ROADMAP.md §3).

The inertial sensors (IMU_MONOCULAR, IMU_STEREO, IMU_RGBD) buffer the IMU
samples each frame brings, predict the pose by integrating them once the
IMU is initialized, and insert keyframes on the staged path of the JAX
System (`_insert_keyframe`, :1580-1696): `insert_and_fuse` runs the
visual insertion through the SearchAndFuse, the interval since the last
keyframe is preintegrated, then either a visual-inertial window BA or the
visual window BA (`window_ba`) runs, then the culling, and then the inertial schedule: the VI initialization, a full
inertial BA at FULL_VIBA_AT intervals and the scale refinement. Loop
closing runs the full inertial BA instead of the visual global BA once the
IMU is initialized, and its Sim3 keeps the scale.

With a shard mesh (`System(mesh=parallel.mesh.make_mesh(...))`) the
global BA after a loop closure runs landmark-sharded over the mesh
(`parallel/distributed_map.distributed_map_ba`); `n_mesh_solves` counts
those solves. `kf_remap_listeners` are called as `cb(remap, old_n_kf)`
after a keyframe compaction (`parallel/live_session.py` keeps per-keyframe
records by slot).

`System.tracer` (`utils/tracing.StageTracer`) times the JAX System's stages
under the same names: `extract`, `stereo_match`, `predict`, `track_frame`,
`insert_kf`, `mapping_fused`, `local_ba` and `loop_closing`, and the
pipelined mode's `frame_step`, `summary_fetch`, `mapping_dispatch`,
`mapping_fused` and the `insert_kf` of `_consume_pend`. A stage reads the
host clock and adds no device synchronization: the stages that end in a
summary read (`track_frame`, `mapping_fused`, `summary_fetch`) wait for
their device work, the others time its enqueueing. Below the stages, while
a profiler runs, the bundle adjustment opens its own spans through
`tracing.span`, not through the tracer: `ba.global`, `ba.local`,
`ba.obs_table`, `ba.iteration` (holding `ba.refresh_weights`, `ba.reduce`,
`ba.solve_cameras`, `ba.back_substitute`, `ba.cost`) and `ba.write_back`;
the insertion's local BA lands inside `local_ba` or `mapping_fused`, the
global BA after a loop closure inside `loop_closing`.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import time as _time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.atlas import atlas as atlas_mod
from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
from orb_slam3_ros2_tpu_torch.atlas import merging as merging_mod
from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod
from orb_slam3_ros2_tpu_torch.backend import vi_ba as vi_ba_mod
from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
from orb_slam3_ros2_tpu_torch.frontend import initializer as init_mod
from orb_slam3_ros2_tpu_torch.frontend import stereo as stereo_mod
from orb_slam3_ros2_tpu_torch.frontend import tracking as trk
from orb_slam3_ros2_tpu_torch.geom import lie
from orb_slam3_ros2_tpu_torch.imu import preintegration as pre_mod
from orb_slam3_ros2_tpu_torch.imu import vi_init as vii
from orb_slam3_ros2_tpu_torch.io import settings as settings_mod
from orb_slam3_ros2_tpu_torch.loop import closing as closing_mod
from orb_slam3_ros2_tpu_torch.loop import dbow2 as dbow2_mod
from orb_slam3_ros2_tpu_torch.loop import vocab as vocab_mod
from orb_slam3_ros2_tpu_torch.models import cameras as cam_mod
from orb_slam3_ros2_tpu_torch.ops import matcher
from orb_slam3_ros2_tpu_torch.parallel import distributed_map
from orb_slam3_ros2_tpu_torch.runtime import staging as staging_mod
from orb_slam3_ros2_tpu_torch.utils import tracing

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
    # T_pred = (T_cur ∘ T_prev⁻¹) ∘ T_cur
    R_v, t_v = lie.se3_compose(R_cur, t_cur, *lie.se3_inverse(R_prev, t_prev))
    R_pred, t_pred = lie.se3_compose(R_v, t_v, R_cur, t_cur)
    m2, f_u, obs_clean, res, summary = _track_image(m, img, R_pred, t_pred,
                                                    cam, ex_cfg)
    return m2, f_u, obs_clean, res.R, res.t, summary


def _track_image(m: ms.MapState, img: torch.Tensor, R_pred, t_pred,
                 cam: cam_mod.Camera, ex_cfg: ex.ExtractorConfig):
    """Extract and undistort `img`, track it from the predicted pose, and
    bump the map's visible/found counters. Returns (m2, f_u, obs_clean,
    the pose LM's result, the (16,) summary)."""
    f = ex.make_extractor(ex_cfg)(img)
    uv_u = undistort(cam, f.uv)
    L = m.lm_valid.shape[0]
    cap_vis = MATCH_CAP_VISIBLE if L > MATCH_CAP_VISIBLE else None
    tm, res, obs_clean, summary = trk.track_frame(
        m, uv_u, f.bits, f.mask, f.level, R_pred, t_pred,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
        scale_factor=ex_cfg.scale_factor, min_matches=MIN_TRACK_INLIERS,
        cap_visible=cap_vis)
    m2 = m._replace(lm_visible=m.lm_visible + tm.lm_visible_inc,
                    lm_found=m.lm_found + tm.lm_found_inc)
    return m2, dataclasses.replace(f, uv=uv_u), obs_clean, res, summary


def frame_step_vi(m: ms.MapState, R_cur, t_cur, v_cur, img: torch.Tensor,
                  gyro, acc, dts, mask, bg, ba, dt_frame, R_bc, t_bc,
                  cam: cam_mod.Camera, ex_cfg: ex.ExtractorConfig):
    """`frame_step` for IMU_MONOCULAR (the JAX `frame_step_vi`,
    `runtime/system.py:485-551`): the pose prediction integrates this
    frame's IMU batch (gyro, acc (P, 3), dts (P,), mask (P,); a masked
    sample is a no-op) from the last tracked pose T_cw = (R_cur, t_cur) and
    body velocity v_cur (world), with the biases bg, ba, through the
    body-from-camera extrinsic (R_bc, t_bc).

    Returns (m2, f_u, obs_clean, R, t, v_new, summary): as `frame_step`,
    plus the body velocity from the difference of the body centres over
    `dt_frame` (a 0-dim tensor), and the (19,) summary, `track_frame`'s
    (16,) with v_new appended."""
    # camera pose -> body pose
    R_bw = R_bc @ R_cur
    t_bw = R_bc @ t_cur + t_bc
    R_wb = R_bw.T
    p_wb = -R_wb @ t_bw
    g = torch.nn.functional.pad(
        torch.full((1,), -9.81, dtype=t_cur.dtype, device=t_cur.device),
        (2, 0))
    # the JAX scan's body, sample by sample; the terms that do not depend
    # on the carry (dt, the bias-corrected samples, each sample's rotation
    # increment) are taken for all samples at once, which saves ~3/4 of
    # the loop's launches and leaves each sample's arithmetic as it was
    dt_all = dts * mask.to(torch.float32)
    a_all = acc - ba
    dR_all = lie.so3_exp((gyro - bg) * dt_all[:, None])
    R, p, v = R_wb, p_wb, v_cur
    for i in range(gyro.shape[0]):
        dt = dt_all[i]
        a_w = R @ a_all[i] + g
        p = p + v * dt + 0.5 * a_w * dt * dt
        v = v + a_w * dt
        R = R @ dR_all[i]
    # body pose -> camera pose
    R_bw2 = R.T
    t_bw2 = -R_bw2 @ p
    R_pred = R_bc.T @ R_bw2
    t_pred = R_bc.T @ (t_bw2 - t_bc)
    m2, f_u, obs_clean, res, summary = _track_image(m, img, R_pred, t_pred,
                                                    cam, ex_cfg)
    # the body velocity: the difference of the body centres over the frame
    # interval (no propagation drift accumulates)
    R_bw_new = R_bc @ res.R
    t_bw_new = R_bc @ res.t + t_bc
    c_new = -R_bw_new.T @ t_bw_new
    v_new = (c_new - p_wb) / torch.clamp(dt_frame, min=1e-6)
    return (m2, f_u, obs_clean, res.R, res.t, v_new,
            torch.cat([summary, v_new]))


def add_stereo_landmarks(m: ms.MapState, kf_id, R, t, bits, mask, X_cam,
                         valid) -> ms.MapState:
    """Spawn a landmark for each feature of keyframe `kf_id` with a metric
    point (`X_cam`, left camera frame) and no map point yet, placed in the
    world with the keyframe's pose T_cw = (R, t) (the JAX
    `_insert_keyframe_stereo_landmarks`, `runtime/system.py:923-940`)."""
    N = X_cam.shape[0]
    Rw, tw = lie.se3_inverse(R, t)
    X_w = lie.se3_apply(Rw, tw, X_cam)
    free = ms.row(m.kf_obs_lm, kf_id) < 0
    feat = torch.arange(N, dtype=torch.int32, device=X_cam.device)
    return ms.add_landmarks(m, X_w, bits, valid & mask & free, kf_id, kf_id,
                            feat, kf_id, feat)


def insert_and_fuse(m: ms.MapState, R, t, timestamp, uv, level, bits, mask,
                    obs_clean, fx, fy, cx, cy, width, height, stereo=None):
    """A keyframe's insertion through the SearchAndFuse (the JAX
    `mapping_step`, `runtime/system.py:369-418`, up to its local BA):
    insert the keyframe → triangulate against its predecessor → add
    landmarks → pick the most covisible second partner → strict
    triangulation → add → SearchAndFuse.

    `stereo` = (X_cam (N, 3), valid (N,)) adds the rig sensors' stage after
    the triangulations, in the order of the JAX staged
    `_insert_keyframe(..., stereo=sm)` (:1580-1696): landmarks for the
    features still without a map point, placed with the tracked pose (R, t)
    from before BA (`add_stereo_landmarks`).

    Keyframe ids stay 0-dim device tensors and the second partner's
    validity is a device-side mask, so the step makes no host sync.
    Returns (m', new keyframe id as a 0-dim tensor)."""
    new_id = m.n_kf.long()
    prev_id = new_id - 1
    m = ms.insert_keyframe(m, R, t, timestamp, uv, level, bits, mask,
                           obs_clean)
    X, bts, acc, fa, fb = trk.triangulate_between(m, new_id, prev_id, fx, fy,
                                                  cx, cy)
    m = ms.add_landmarks(m, X, bts, acc, new_id, new_id, fa, prev_id, fb)
    # second partner: the most covisible beyond the predecessor;
    # best_covisible falls back to prev_id when nothing qualifies, and the
    # strict pass then masks itself out
    partner = trk.best_covisible(m, new_id, torch.stack([new_id, prev_id]))
    partner_ok = (partner != new_id) & (partner != prev_id) & (partner >= 0)
    X2, b2, a2, fa2, fb2 = trk.triangulate_between(
        m, new_id, partner, fx, fy, cx, cy, reproj_th=1.0, max_dist=35.0)
    m = ms.add_landmarks(m, X2, b2, a2 & partner_ok, new_id, new_id, fa2,
                         partner, fb2)
    if stereo is not None:
        m = add_stereo_landmarks(m, new_id, R, t, bits, mask, *stereo)
    m, _, _ = trk.fuse_map_points(m, new_id, fx, fy, cx, cy, width, height)
    return m, new_id


def window_ba(m: ms.MapState, new_id, fx, fy, cx, cy, n_window: int,
              n_fixed_ring: int, ba_iters: int = 10) -> ms.MapState:
    """The visual local BA over `new_id`'s covisibility window."""
    ids, fix = trk.select_local_window(m, new_id, n_window=n_window,
                                       n_fixed_ring=n_fixed_ring)
    return trk.local_ba(m, ids, fix, fx, fy, cx, cy, n_iters=ba_iters)


def keyframe_summary(m: ms.MapState, new_id) -> torch.Tensor:
    """[R(9), t(3), n_kf, n_lm] of keyframe `new_id`, as one (14,) tensor
    (one fetch)."""
    return torch.cat([
        ms.row(m.kf_R, new_id).reshape(-1), ms.row(m.kf_t, new_id),
        torch.stack([m.n_kf.to(torch.float32), m.n_lm.to(torch.float32)]),
    ])


def mapping_step(m: ms.MapState, R, t, timestamp, uv, level, bits, mask,
                 obs_clean, fx, fy, cx, cy, width, height, n_window: int,
                 n_fixed_ring: int, ba_iters: int = 10, stereo=None):
    """The whole visual keyframe insertion (the JAX `mapping_step`,
    `runtime/system.py:369-418`): `insert_and_fuse` → covisibility-window
    local BA (`window_ba`) → landmark culling, with no host sync. Returns
    (m', summary) with the `keyframe_summary` of the new keyframe after
    BA."""
    m, new_id = insert_and_fuse(m, R, t, timestamp, uv, level, bits, mask,
                                obs_clean, fx, fy, cx, cy, width, height,
                                stereo=stereo)
    m = window_ba(m, new_id, fx, fy, cx, cy, n_window, n_fixed_ring,
                  ba_iters)
    m = trk.cull_landmarks(m)
    return m, keyframe_summary(m, new_id)


class Sensor(enum.IntEnum):
    """Sensor modes (the reference's enum)."""

    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4
    IMU_RGBD = 5


IMU_MODES = (Sensor.IMU_MONOCULAR, Sensor.IMU_STEREO, Sensor.IMU_RGBD)
# modes whose maps are born at metric scale (loop-closing Sim3 fixes s = 1)
METRIC_MODES = (Sensor.STEREO, Sensor.RGBD, Sensor.IMU_STEREO,
                Sensor.IMU_RGBD)


class ImuPoint:
    """One IMU measurement (the reference's `ORB_SLAM3::IMU::Point`):
    accelerometer (m/s²), gyroscope (rad/s), time (s)."""

    __slots__ = ("acc", "gyro", "t")

    def __init__(self, acc, gyro, t):
        self.acc = np.asarray(acc, np.float64)
        self.gyro = np.asarray(gyro, np.float64)
        self.t = float(t)


def apply_sim3_to_map(m: ms.MapState, R_align, s) -> ms.MapState:
    """x_new = s · R_align x_old on every landmark and keyframe; poses stay
    consistent (the JAX `apply_sim3_to_map`, `runtime/system.py:468-476`)."""
    lm_X = s * (m.lm_X @ R_align.T)
    kf_R = m.kf_R @ R_align.T[None]
    kf_t = s * m.kf_t
    return m._replace(lm_X=lm_X, kf_R=kf_R, kf_t=kf_t)


def vi_ba2(m: ms.MapState, window_ids, fixed_mask, pres, v0, bg, ba, fx, fy,
           cx, cy, R_bc, t_bc, n_iters: int = 8, opt_gravity: bool = True,
           n_inertial: Optional[int] = None):
    """VIBA2 / LocalInertialBA over a consecutive-keyframe window, written
    back into the map (the JAX `vi_ba2`, `runtime/system.py:553-605`).

    `window_ids` may carry trailing visual-only anchor keyframes past the
    `n_inertial` intervals of the consecutive block (the fixed covisible
    ring); duplicate ids deactivate past their first occurrence, as in
    `local_ba`. The accel-bias prior is anchored at zero, not at the
    running estimate: at these excitations ba is confounded with scale, and
    a prior re-centred on each window let it absorb a 23% map-scale error
    in the JAX package. Returns (m', v, bg, ba, cost, thg)."""
    W = window_ids.shape[0]
    dev = window_ids.device
    same = window_ids[None, :] == window_ids[:, None]
    earlier = torch.ones((W, W), dtype=torch.bool, device=dev).tril(-1)
    first_occurrence = ~(same & earlier).any(dim=1)
    uv_t, w_t, kf_ok = ms.observation_table(m, window_ids)
    active = kf_ok & first_occurrence
    ids = window_ids.long()
    p = ba_mod.BAProblem(
        R=m.kf_R[ids], t=m.kf_t[ids], X=m.lm_X, uv=uv_t,
        w=w_t * active[:, None], fixed=fixed_mask | ~active,
        point_valid=m.lm_valid)
    out = vi_ba_mod.vi_bundle_adjust(
        p, pres, v0, bg, ba, fx, fy, cx, cy, R_bc=R_bc, t_bc=t_bc,
        n_iters=n_iters, opt_gravity=opt_gravity, n_inertial=n_inertial,
        prior_bg=1e2, prior_ba=1e6, ba_prior_center=torch.zeros_like(ba))
    K = m.kf_R.shape[0]
    write_ids = torch.where(active, ids, K)
    kf_R = ms._scatter_drop(m.kf_R, write_ids, out.R)
    kf_t = ms._scatter_drop(m.kf_t, write_ids, out.t)
    moved = (w_t * active[:, None]).sum(0) > 0
    lm_X = torch.where(moved[:, None], out.X, m.lm_X)
    return (m._replace(kf_R=kf_R, kf_t=kf_t, lm_X=lm_X), out.v, out.bg,
            out.ba, out.cost, out.thg)


class TrackingState(enum.IntEnum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


class System:
    """SLAM engine with the reference System's API: the monocular, stereo
    and RGB-D System of the JAX package, with or without an IMU, and its
    pipelined mode."""

    MIN_INIT_MATCHES = 90
    MIN_TRACK_INLIERS = MIN_TRACK_INLIERS
    KF_MIN_GAP = 3  # frames
    LOCAL_WINDOW = 8  # covisible keyframes optimized by local BA
    LOCAL_FIXED_RING = 4  # second-ring observers held fixed in local BA
    MATCH_CAP_VISIBLE = MATCH_CAP_VISIBLE
    VI_INIT_KFS = 8  # keyframes before attempting VI initialization
    VI_LOCAL_WINDOW = 6  # keyframes in the local inertial BA window
    VI_FIXED_RING = 4  # fixed covisible anchors appended to the VI window
    # the inertial schedule, on the count of stored inter-keyframe
    # intervals: scale/gravity refinements (the reference re-runs the
    # inertial-only optimization as excitation accumulates), full joint VI
    # BA (FullInertialBA), and the longest refinement window
    SCALE_REFINE_AT = (8, 12, 16, 24, 32, 48, 64)
    FULL_VIBA_AT = (11, 21)
    SCALE_REFINE_MAX_INT = 48

    LM_COMPACT_FRAC = 0.90  # landmark-slot occupancy that triggers compaction
    KF_CULL_HEADROOM = 3  # free keyframe slots to maintain
    KF_PROTECT_RECENT = 12  # newest keyframes never culled
    KF_REDUNDANT_TH = 0.8  # redundancy score above which a KF is expendable

    def __init__(
        self,
        vocab_path: Optional[str],
        settings_path: str,
        sensor: Sensor = Sensor.MONOCULAR,
        use_viewer: bool = False,
        map_cfg: Optional[ms.MapConfig] = None,
        init_frame: int = 0,
        load_atlas: Optional[str] = None,
        mesh=None,
        pipelined: bool = False,
        device=None,
    ):
        """As the JAX constructor, plus `device` (default "cuda"; the CPU
        only when the caller passes device="cpu")."""
        del init_frame
        self.sensor = Sensor(sensor)
        # frames consumed one behind (`_track_pipelined`)
        self.pipelined = bool(pipelined)
        # a shard mesh (`parallel/mesh.py`): the global BA then runs
        # landmark-sharded over it (`parallel/distributed_map.py`)
        self.mesh = mesh
        self._metric_scale = self.sensor in METRIC_MODES
        self.settings = settings_mod.load_settings(settings_path)
        self.use_viewer = use_viewer
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"System(device={device!r}): no CUDA device is available; "
                "pass device=\"cpu\" to run on the CPU")
        # the reference's ORBvoc.txt constructor slot: None -> the default
        # codebook; a DBoW2 .txt, a trained codebook .npz or a tree .npz
        self.vocab = vocab_mod.Vocabulary(
            dbow2_mod.load_vocabulary_any(vocab_path) if vocab_path else None,
            self.device)
        cam = self.settings.camera
        self.cam = cam
        self.ex_cfg = ex.ExtractorConfig(
            n_features=self.settings.n_features,
            n_levels=self.settings.n_levels,
            scale_factor=self.settings.scale_factor,
            ini_th_fast=float(self.settings.ini_th_fast),
            min_th_fast=float(self.settings.min_th_fast),
            height=cam.height,
            width=cam.width,
        )
        n_cap = ex.total_capacity(self.ex_cfg)
        self.map_cfg = map_cfg or ms.MapConfig(max_kf=256, max_lm=8192,
                                               n_feat=n_cap)
        assert self.map_cfg.n_feat == n_cap, "map n_feat must match extractor"
        self._extract = ex.make_extractor(self.ex_cfg)
        self._cap_vis = (self.MATCH_CAP_VISIBLE
                         if self.map_cfg.max_lm > self.MATCH_CAP_VISIBLE
                         else None)
        # the stereo observation builder (JAX `_build_jitted`, :214-263):
        # the general two-view path for a rig with `camera2` and
        # `Stereo.T_c1_c2` (KannalaBrandt8 fisheye, distorted PinHole), the
        # rectified scanline path for `Stereo.b` alone
        cam2 = self.settings.camera2
        self._stereo_right_raw = (cam2 is not None
                                  and self.settings.T_c1_c2 is not None)
        if self._stereo_right_raw:
            T12 = np.asarray(self.settings.T_c1_c2, np.float64)
            self._R12 = self._tensor(T12[:3, :3])
            self._t12 = self._tensor(T12[:3, 3])
            self.stereo_baseline = float(np.linalg.norm(T12[:3, 3]))
        else:
            self.stereo_baseline = float(self.settings.stereo_b
                                         or cam.baseline or 0.05)
        # the IMU: body-from-camera extrinsic (identity without
        # `IMU.T_b_c1`), and the per-frame preintegration batch size of the
        # JAX System (4 frames of samples, at least 16); an interval keeps
        # at most 4 of those
        T_bc = (np.asarray(self.settings.T_b_c1, np.float64)
                if self.settings.T_b_c1 is not None else np.eye(4))
        self._T_bc = T_bc
        self._R_bc = self._tensor(T_bc[:3, :3])
        self._t_bc = self._tensor(T_bc[:3, 3])
        self._pre_cap = max(int(4.0 * self.settings.imu_frequency
                                / max(self.settings.fps, 1.0)), 16)
        # the pipelined mode's pinned uploads (the image and the per-frame
        # inputs of `frame_step_vi`) and summary reads
        self._staging = (staging_mod.PipeStaging(
            self.device, cam.height * cam.width + 8 * self._pre_cap + 7)
            if self.pipelined else None)
        # per-stage wall-clock tracer (host clock, no device sync)
        self.tracer = tracing.StageTracer()
        self.reset()
        # `System.LoadAtlasFromFile`: a missing file starts a new Atlas; a
        # loaded one is relocalized into, and never discarded
        load = load_atlas or self.settings.load_atlas_from_file
        if load:
            path = load if load.endswith(".npz") else load + ".npz"
            if os.path.isfile(path):
                loaded = atlas_mod.Atlas.load(path, self.device)
                if (loaded.cfg == self.map_cfg
                        and loaded.n_words == self.vocab.n_words):
                    self.atlas = loaded
                    self._rows_per_keyframe()
                    self.state = TrackingState.LOST
                    self._map_protected = True
                    self.kf_times = self._map_kf_times()

    # ------------------------------------------------------------------ state

    def reset(self):
        self.atlas = atlas_mod.Atlas(self.map_cfg, self.vocab.n_words,
                                     self.device)
        self.state = TrackingState.NOT_INITIALIZED
        self._map_protected = False  # see LoadAtlasFromFile / _relocalize
        self.Tcw = np.eye(4, dtype=np.float32)  # current camera pose
        self.velocity: Optional[np.ndarray] = None  # T_cur_last (4, 4)
        self.last_Tcw: Optional[np.ndarray] = None
        self.ref_feats = None  # initialization reference frame
        self.ref_time = None
        self.frames_since_kf = 0
        self.last_kf_inliers = 1
        self.n_frames = 0
        self.trajectory: List[Tuple[float, np.ndarray]] = []
        self.tracking_log: List[dict] = []
        # per-frame reference-keyframe record (ref KF timestamp, its pose at
        # track time, map scale); get_frame_trajectory re-expresses each
        # frame against it (the reference's SaveTrajectoryTUM protocol)
        self.frame_refs: List[tuple] = []
        self.kf_times: List[float] = []  # host timestamps, Python floats
        self.last_frame_feats = None
        self.last_frame_time: Optional[float] = None
        self.scale_applied = 1.0
        self._scene_depth = None  # median tracked-landmark depth (summary)
        self._last_kf_center = None  # camera centre at the last keyframe
        self._frame_ref_cache = None
        # loop closing and relocalization
        self.n_loops_closed = 0
        self.n_maps_merged = 0
        self.last_loop_kf = -10**9
        self.frames_lost = 0
        # temporal consistency: [(covisible group, count), ...]
        self._loop_consistency: List[Tuple[set, int]] = []
        # the IMU
        self.imu_initialized = False
        self.inertial_ba1 = False
        self.inertial_ba2 = False
        self.kf_preints: List[pre_mod.Preintegrated] = []  # between keyframes
        self._kf_imu_buf: List[ImuPoint] = []
        self.bg = np.zeros(3)
        self.ba = np.zeros(3)
        self.kf_velocities: dict = {}
        self.v_cur: Optional[np.ndarray] = None  # body velocity (world)
        self._scale_stable_count = 0  # consecutive converged refinements
        self._n_scale_refines = 0
        # samples beyond an interval's 4 * _pre_cap rows, which the JAX
        # System drops without a word (`_finish_kf_preint`, :2250)
        self.dropped_imu_samples = 0
        self.n_mesh_solves = 0  # global BAs run over the shard mesh
        # landmark or keyframe compactions so far (the pipelined consume
        # drops the device chain when one happens)
        self._compact_events = 0
        # the pipelined mode (see _track_pipelined): the frame in flight,
        # the dispatched keyframe insertion, the device pose chain, its
        # time and the IMU samples since it
        self._pend = None
        self._pend_kf = None
        self._chain = None
        self._chain_time: Optional[float] = None
        self._pipe_imu: List[ImuPoint] = []
        # callbacks invoked as cb(remap, old_n_kf) after keyframe compaction
        self.kf_remap_listeners: List = []

    # ---------------------------------------------------------------- atlas

    @property
    def map(self) -> ms.MapState:
        """The active map (the Atlas holds it)."""
        return self.atlas.current_map

    @map.setter
    def map(self, m: ms.MapState) -> None:
        self.atlas.current_map = m

    @property
    def bow_db(self) -> vocab_mod.BowDatabase:
        """The active map's BoW database."""
        return self.atlas.current_bow

    @bow_db.setter
    def bow_db(self, db: vocab_mod.BowDatabase) -> None:
        self.atlas.current_bow = db

    def save_atlas(self, path: Optional[str] = None) -> Optional[str]:
        """`System.SaveAtlasToFile`: the Atlas as `.npz` at `path` (or the
        settings' `System.SaveAtlasToFile`); returns the path."""
        self._flush_pipeline()
        path = path or self.settings.save_atlas_to_file
        if not path:
            return None
        if not path.endswith(".npz"):
            path = path + ".npz"
        self.atlas.save(path)
        return path

    def _spawn_new_map(self):
        """Tracking irrecoverably lost: freeze the active map and start a
        fresh one."""
        self.atlas.create_new_map()
        self._spawn_state_reset()
        self._map_protected = False

    def _map_kf_times(self) -> List[float]:
        """Host keyframe times of the active map, from its `kf_time`."""
        n_kf = int(self.map.n_kf)
        return [float(t) for t in self.map.kf_time[:n_kf].cpu().numpy()]

    def _rows_per_keyframe(self):
        """Rebuild every map's BoW rows from its keyframes' stored
        descriptors, keyframe k at slot k. An Atlas saved by the JAX System
        has no rows for the initializer's keyframes and its slot s holds
        keyframe s + 2 (ROADMAP.md §3); a row is a function of the
        vocabulary and its keyframe's features, so the port's own rows come
        back as they were saved."""
        self.atlas.bow_dbs = [
            vocab_mod.rows_from_keyframes(self.vocab, m.kf_bits,
                                          m.kf_feat_valid, int(m.n_kf))
            for m in self.atlas.maps]

    def _add_bow_row(self, kf_id: int, feats):
        """Keyframe kf_id's BoW row, at slot kf_id."""
        self.bow_db = vocab_mod.add_keyframe(self.bow_db, self.vocab,
                                             feats.signs, feats.mask,
                                             slot=kf_id)

    # --------------------------------------------------------------- helpers

    @staticmethod
    def _pose44(R, t) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray(R)
        T[:3, 3] = np.asarray(t)
        return T

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _host_image(self, im: np.ndarray) -> np.ndarray:
        """The frame as the extractor takes it: gray, at the camera's size,
        float32 (on the host)."""
        if im.ndim == 3:
            im = im.mean(axis=-1)
        H, W = self.cam.height, self.cam.width
        if im.shape != (H, W):
            import cv2

            im = cv2.resize(np.asarray(im, np.float32), (W, H),
                            interpolation=cv2.INTER_AREA)
        return np.asarray(im, np.float32)

    def _preprocess(self, im: np.ndarray) -> torch.Tensor:
        return self._tensor(self._host_image(im))

    def _extract_undistorted(self, img: torch.Tensor):
        f = self._extract(img)
        return dataclasses.replace(f, uv=undistort(self.cam, f.uv))

    def _stereo_obs(self, f_l, f_r) -> stereo_mod.StereoObs:
        """Metric points for the left features: the left uv are undistorted
        pinhole pixels; the general path takes the right camera's raw
        detections through its own unprojection."""
        cam = self.cam
        if self._stereo_right_raw:
            uv = f_l.uv
            rays_l = torch.stack([(uv[:, 0] - cam.cx) / cam.fx,
                                  (uv[:, 1] - cam.cy) / cam.fy,
                                  torch.ones_like(uv[:, 0])], dim=-1)
            rays_r = cam_mod.unproject(self.settings.camera2, f_r.uv)
            return stereo_mod.match_stereo_general(
                rays_l, f_l.signs, f_l.mask, f_l.level, rays_r, f_r.signs,
                f_r.mask, f_r.level, self._R12, self._t12,
                scale_factor=self.ex_cfg.scale_factor)
        sm = stereo_mod.match_stereo(
            f_l.uv, f_l.signs, f_l.mask, f_l.level, f_r.uv, f_r.signs,
            f_r.mask, f_r.level, cam.fx, self.stereo_baseline)
        return stereo_mod.obs_from_rectified(sm, f_l.uv, cam.fx, cam.fy,
                                             cam.cx, cam.cy)

    # ------------------------------------------------------------ public API

    def track_monocular(self, im: np.ndarray, timestamp: float,
                        imu_measurements: Sequence = ()) -> np.ndarray:
        """Per-frame entry point; returns the 4x4 T_cw (camera from world).
        IMU_MONOCULAR takes the IMU samples in (t_prev, timestamp]; the
        visual modes ignore them."""
        t0 = _time.perf_counter()
        self._buffer_imu(imu_measurements)
        if (self.pipelined and self.state == TrackingState.OK
                and (self.sensor == Sensor.MONOCULAR
                     or (self.sensor == Sensor.IMU_MONOCULAR
                         and self.imu_initialized
                         and self.v_cur is not None))):
            # one behind: dispatch this frame, consume the previous one
            # (its records are appended then, one per frame); IMU_MONOCULAR
            # joins once its IMU is initialized, and runs the staged path
            # for its VI bootstrap before that
            if self.sensor == Sensor.IMU_MONOCULAR:
                self._pipe_imu.extend(imu_measurements)
            self._track_pipelined(im, timestamp, t0)
            self.n_frames += 1
            return self.Tcw.copy()
        self._flush_pipeline()
        img = self._preprocess(im)
        with self.tracer.stage("extract"):
            feats = self._extract_undistorted(img)
        if self.state == TrackingState.NOT_INITIALIZED:
            self._try_initialize(feats, timestamp)
        elif self.state == TrackingState.OK:
            self._track(feats, timestamp, imu=imu_measurements)
        else:
            self._relocalize(feats, timestamp)
        return self._end_frame(feats, timestamp, t0)

    def track_stereo(self, im_left: np.ndarray, im_right: np.ndarray,
                     timestamp: float,
                     imu_measurements: Sequence = ()) -> np.ndarray:
        """Stereo per-frame entry point; returns the 4x4 T_cw. Landmarks
        are spawned at metric depth from rectified scanline matches or
        general two-view triangulation, so no two-view initialization is
        needed. IMU_STEREO takes the IMU samples in (t_prev, timestamp]."""
        t0 = _time.perf_counter()
        self._buffer_imu(imu_measurements)
        img_l = self._preprocess(im_left)
        img_r = self._preprocess(im_right)
        with self.tracer.stage("extract"):
            feats = self._extract_undistorted(img_l)
            feats_r = (self._extract(img_r) if self._stereo_right_raw
                       else self._extract_undistorted(img_r))
        with self.tracer.stage("stereo_match"):
            sm = self._stereo_obs(feats, feats_r)
        self._step_metric(feats, sm, timestamp, imu_measurements)
        return self._end_frame(feats, timestamp, t0)

    def track_rgbd(self, im: np.ndarray, depthmap: np.ndarray,
                   timestamp: float,
                   imu_measurements: Sequence = ()) -> np.ndarray:
        """RGB-D per-frame entry point; returns the 4x4 T_cw. Depth is
        sampled at each raw keypoint and backprojected through the
        undistorted pixel; the rest is the stereo path's. IMU_RGBD takes
        the IMU samples in (t_prev, timestamp]."""
        t0 = _time.perf_counter()
        self._buffer_imu(imu_measurements)
        img = self._preprocess(im)
        with self.tracer.stage("extract"):
            f_raw = self._extract(img)
            feats = dataclasses.replace(f_raw,
                                        uv=undistort(self.cam, f_raw.uv))
        cam = self.cam
        with self.tracer.stage("stereo_match"):
            sm = stereo_mod.obs_from_depth(
                f_raw.uv, feats.uv, feats.mask, self._tensor(depthmap),
                cam.fx, cam.fy, cam.cx, cam.cy,
                max_depth=float(self.settings.th_far_points or 40.0))
        self._step_metric(feats, sm, timestamp, imu_measurements)
        return self._end_frame(feats, timestamp, t0)

    def _step_metric(self, feats, sm, timestamp: float, imu=()):
        if self.state == TrackingState.NOT_INITIALIZED:
            self._initialize_stereo(feats, sm, timestamp)
        elif self.state == TrackingState.OK:
            self._track(feats, timestamp, stereo=sm, imu=imu)
        else:
            self._relocalize(feats, timestamp)

    def _buffer_imu(self, imu_measurements):
        """The inertial sensors keep every sample until its keyframe
        interval is preintegrated."""
        if self.sensor in IMU_MODES:
            self._kf_imu_buf.extend(imu_measurements)

    def _end_frame(self, feats, timestamp: float, t0: float) -> np.ndarray:
        """The per-frame bookkeeping every entry point ends with."""
        self.last_frame_feats = feats
        self.last_frame_time = timestamp
        self.n_frames += 1
        self.trajectory.append((timestamp, self.Tcw.copy()))
        self.frame_refs.append(self._current_frame_ref())
        self.tracking_log.append({
            "t": timestamp, "state": int(self.state),
            "ms": (_time.perf_counter() - t0) * 1e3})
        return self.Tcw.copy()

    def is_imu_initialized(self) -> bool:
        return self.imu_initialized

    def get_inertial_ba1(self) -> bool:
        return self.inertial_ba1

    def get_inertial_ba2(self) -> bool:
        return self.inertial_ba2

    def get_map_pcl(self) -> np.ndarray:
        """Map-point snapshot (`GetMapPCL`)."""
        self._flush_pipeline()
        X = self.map.lm_X.cpu().numpy()
        return X[self.map.lm_valid.cpu().numpy()]

    def get_pretty_frame(self, img: Optional[np.ndarray] = None
                         ) -> Optional[np.ndarray]:
        """Annotated tracking image (the fork's `getPrettyFrame`,
        `src/imu_mono_realsense.cpp:340`): `img` with the last frame's
        detected keypoints drawn on it, for the video recorder. The engine
        keeps features, not images, so the caller passes the pixels."""
        if self.last_frame_feats is None or img is None:
            return None
        from orb_slam3_ros2_tpu_torch.runtime import outputs as out_mod

        f = self.last_frame_feats
        return out_mod.annotate_frame(np.asarray(img, np.uint8),
                                      f.uv.cpu().numpy(), f.mask.cpu().numpy())

    def get_tracking_state(self) -> TrackingState:
        return self.state

    def get_trajectory(self):
        self._flush_pipeline()
        return list(self.trajectory)

    def _mark_frame_ref_dirty(self):
        self._frame_ref_cache = None

    def _current_frame_ref(self):
        """Latest keyframe's (timestamp, current map pose, map scale): the
        reference a frame's relative pose is stored against. Cached; the
        keyframe insertion refills it from its summary with no fetch."""
        if self._frame_ref_cache is not None:
            return self._frame_ref_cache
        n_kf = int(self.map.n_kf)
        if not self.kf_times or n_kf == 0:
            ref = (None, None, 1.0)
        else:
            k = min(len(self.kf_times), n_kf) - 1
            ref = (self.kf_times[k],
                   self._pose44(self.map.kf_R[k].cpu().numpy(),
                                self.map.kf_t[k].cpu().numpy()),
                   float(self.scale_applied))
        self._frame_ref_cache = ref
        return ref

    def get_frame_trajectory(self):
        """(t, T_cw 4x4) per tracked frame with retroactive corrections:
        each frame's track-time pose relative to its reference keyframe's
        track-time pose, composed with that keyframe's final pose (the
        reference's SaveTrajectoryTUM). Frames whose reference keyframe no
        longer exists keep their raw online pose."""
        self._flush_pipeline()
        kf_final = {round(t, 9): T for t, T in self.get_keyframe_trajectory()}
        s_now = float(self.scale_applied)
        out = []
        for (t, T_online), ref in zip(self.trajectory, self.frame_refs):
            ref_t, ref_T, s_then = ref
            T_final = kf_final.get(round(ref_t, 9)) if ref_t is not None \
                else None
            if ref_T is None or T_final is None:
                out.append((t, T_online.copy()))
                continue
            T_rel = (T_online @ np.linalg.inv(ref_T)).copy()
            T_rel[:3, 3] *= s_now / max(s_then, 1e-12)
            out.append((t, (T_rel @ T_final).astype(np.float32)))
        return out

    def get_keyframe_trajectory(self):
        """(t, T_cw 4x4) per keyframe from the current map."""
        self._flush_pipeline()
        n_kf = int(self.map.n_kf)
        kR = self.map.kf_R[:n_kf].cpu().numpy()
        kt = self.map.kf_t[:n_kf].cpu().numpy()
        return [(self.kf_times[k] if k < len(self.kf_times) else 0.0,
                 self._pose44(kR[k], kt[k])) for k in range(n_kf)]

    def shutdown(self):
        """The reference's `Shutdown`. There is no mapping thread to stop,
        as in the JAX System; the readers drain the pipelined mode's frame
        in flight."""

    # ------------------------------------------------------- initialization

    def _try_initialize(self, feats, timestamp: float):
        n_valid = int(feats.mask.sum())
        if self.ref_feats is None or n_valid < self.MIN_INIT_MATCHES:
            if n_valid >= self.MIN_INIT_MATCHES:
                self.ref_feats = feats
                self.ref_time = timestamp
            return
        res = matcher.match(self.ref_feats.signs, self.ref_feats.mask,
                            feats.signs, feats.mask, max_dist=60.0,
                            ratio=0.85, mutual=True)
        valid = res.idx >= 0
        if int(valid.sum()) < self.MIN_INIT_MATCHES:
            # the reference drops the init frame if matching degrades
            if timestamp - self.ref_time > 2.0:
                self.ref_feats = feats
                self.ref_time = timestamp
            return
        idx_safe = torch.where(valid, res.idx, 0)
        uv2 = feats.uv[idx_safe.long()]
        # each attempt draws its RANSAC samples on the device from a stream
        # keyed by the frame index, as the JAX System's PRNGKey(n_frames);
        # the two packages' generators cannot draw the same samples
        gen = torch.Generator(device=self.device).manual_seed(self.n_frames)
        out = init_mod.initialize(gen, self.ref_feats.uv, uv2, valid,
                                  self.cam.fx, self.cam.fy, self.cam.cx,
                                  self.cam.cy, min_good=50)
        if not bool(out.ok):
            if timestamp - self.ref_time > 2.0:
                self.ref_feats = feats
                self.ref_time = timestamp
            return
        self._create_initial_map(out, feats, idx_safe, timestamp)

    def _create_initial_map(self, out, feats, idx_safe, timestamp: float):
        good = out.good.cpu().numpy()
        X = out.X.cpu().numpy()  # frame-1 (== world) camera coords
        # median-depth normalization: the initial map's median depth is 1
        med = np.median(X[good, 2]) if good.any() else 1.0
        s = 1.0 / max(med, 1e-6)
        f0 = self.ref_feats
        N = f0.uv.shape[0]
        dev = self.device
        none = torch.full((N,), -1, dtype=torch.int32, device=dev)
        m = ms.insert_keyframe(self.map, torch.eye(3, device=dev),
                               torch.zeros(3, device=dev),
                               self.ref_time or 0.0, f0.uv, f0.level,
                               f0.bits, f0.mask, none)
        m = ms.insert_keyframe(m, self._tensor(out.R.cpu().numpy()),
                               self._tensor(out.t.cpu().numpy() * s),
                               timestamp, feats.uv, feats.level, feats.bits,
                               feats.mask, none)
        feat = torch.arange(N, dtype=torch.int32, device=dev)
        m = ms.add_landmarks(m, self._tensor(X * s), f0.bits,
                             torch.from_numpy(good).to(dev), 0, 0, feat, 1,
                             idx_safe.to(torch.int32))
        # two-view BA: keyframe 0 fixed, the padding slots inactive
        W = self.LOCAL_WINDOW
        window = torch.tensor([0, 1] + [0] * (W - 2), dtype=torch.int32,
                              device=dev)
        fix = torch.tensor([True, False] + [True] * (W - 2), device=dev)
        cam = self.cam
        m = trk.local_ba(m, window, fix, cam.fx, cam.fy, cam.cx, cam.cy,
                         n_iters=12)
        self.map = m
        self.state = TrackingState.OK
        self.Tcw = self._pose44(m.kf_R[1].cpu().numpy(),
                                m.kf_t[1].cpu().numpy())
        self.last_Tcw = self.Tcw.copy()
        self.velocity = None
        self.frames_since_kf = 0
        self.last_kf_inliers = int(good.sum())
        self.kf_times = [self.ref_time or 0.0, timestamp]
        # both initializer keyframes get their BoW rows (slots 0 and 1)
        self._add_bow_row(0, f0)
        self._add_bow_row(1, feats)
        self._start_kf_preint()

    def _initialize_stereo(self, feats, sm, timestamp: float):
        """One-frame metric initialization: at least 80 features with a
        valid point make keyframe 0 at the identity, each one a landmark."""
        accept = sm.valid & feats.mask
        n_depth = int(accept.sum())
        if n_depth < 80:
            return
        N = feats.uv.shape[0]
        dev = self.device
        m = ms.insert_keyframe(self.map, torch.eye(3, device=dev),
                               torch.zeros(3, device=dev), timestamp, feats.uv,
                               feats.level, feats.bits, feats.mask,
                               torch.full((N,), -1, dtype=torch.int32,
                                          device=dev))
        feat = torch.arange(N, dtype=torch.int32, device=dev)
        self.map = ms.add_landmarks(m, sm.X_cam, feats.bits, accept, 0, 0,
                                    feat, 0, feat)
        self.state = TrackingState.OK
        self.Tcw = np.eye(4, dtype=np.float32)
        self.last_Tcw = self.Tcw.copy()
        self.frames_since_kf = 0
        self.last_kf_inliers = n_depth
        self.kf_times = [timestamp]
        self._add_bow_row(0, feats)

    # ------------------------------------------------------------- tracking

    def _predict_pose(self) -> np.ndarray:
        if self.velocity is not None:
            return self.velocity @ self.Tcw
        return self.Tcw

    def _track(self, feats, timestamp: float, stereo=None, imu=()):
        # IMU-propagated prediction once the IMU is initialized (the
        # reference's PredictStateIMU), constant velocity otherwise
        with self.tracer.stage("predict"):
            T_pred = self._predict_pose_imu(list(imu), timestamp)
            if T_pred is None:
                T_pred = self._predict_pose()
        cam = self.cam
        # one device program and one fetch of the (16,) summary
        with self.tracer.stage("track_frame"):
            tm, res, obs_clean, summary = trk.track_frame(
                self.map, feats.uv, feats.bits, feats.mask, feats.level,
                self._tensor(T_pred[:3, :3]), self._tensor(T_pred[:3, 3]),
                cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                scale_factor=self.ex_cfg.scale_factor,
                min_matches=self.MIN_TRACK_INLIERS, cap_visible=self._cap_vis)
            s = summary.cpu().numpy()
        n_match, n_inl, n_kf_now = int(s[12]), int(s[13]), int(s[14])
        self._scene_depth = float(s[15])
        if n_match < self.MIN_TRACK_INLIERS or n_inl < self.MIN_TRACK_INLIERS:
            self.state = TrackingState.LOST
            return
        self.map = self.map._replace(
            lm_visible=self.map.lm_visible + tm.lm_visible_inc,
            lm_found=self.map.lm_found + tm.lm_found_inc)
        T_prev = self.Tcw
        T_new = self._pose44(s[:9].reshape(3, 3), s[9:12])
        if self.last_Tcw is not None:
            self.velocity = T_new @ np.linalg.inv(self.last_Tcw)
        self.last_Tcw = T_new
        self.Tcw = T_new
        # the body velocity for the IMU prediction: the difference of the
        # body centres (no propagation drift accumulates)
        if self.imu_initialized and self.last_frame_time is not None:
            dt = timestamp - self.last_frame_time
            if dt > 1e-6:
                self.v_cur = (self._body_center(T_new)
                              - self._body_center(T_prev)) / dt
        self.frames_since_kf += 1
        if self._need_keyframe(n_inl, n_kf_now):
            with self.tracer.stage("insert_kf"):
                if self.sensor in IMU_MODES:
                    self._insert_keyframe_inertial(feats, obs_clean,
                                                   timestamp, n_inl, stereo)
                else:
                    self._insert_keyframe_fused(feats, obs_clean, timestamp,
                                                n_inl, stereo)

    def _need_keyframe(self, n_inl: int, n_kf: int = -1) -> bool:
        """The keyframe cadence: a keyframe every max(fps // 2, 5) frames,
        or earlier (after KF_MIN_GAP frames) when the inliers drop under 75%
        of the last keyframe's or under 60. IMU_MONOCULAR also inserts
        every max(fps // 3, 3) frames once the camera has moved at least
        0.5% of the scene depth since the last keyframe (the VI initializer
        needs keyframes to fill its windows; the parallax gate keeps their
        triangulations conditioned)."""
        if n_kf < 0:
            n_kf = int(self.map.n_kf)
        if n_kf >= self.map_cfg.max_kf - 1:
            return False
        sparse_gap = max(int(self.cam.fps) // 2, 5)
        if self.sensor == Sensor.IMU_MONOCULAR:
            dense_gap = max(int(self.cam.fps) // 3, 3)
            if self.frames_since_kf >= dense_gap:
                base = None
                if (self._last_kf_center is not None
                        and self._scene_depth is not None):
                    c = -self.Tcw[:3, :3].T @ self.Tcw[:3, 3]
                    base = float(np.linalg.norm(c - self._last_kf_center))
                if (base is None
                        or base >= 0.005 * max(self._scene_depth, 1e-3)):
                    return True
        if self.frames_since_kf >= sparse_gap:
            return True
        if self.frames_since_kf < self.KF_MIN_GAP:
            return False
        return n_inl < 0.75 * self.last_kf_inliers or n_inl < 60

    def _insert_keyframe_fused(self, feats, obs_clean, timestamp: float,
                               n_inl: int, stereo=None):
        """One `mapping_step` (with the stereo stage when `stereo`, a
        StereoObs, is given) and one fetch of its summary, then the host
        side: the keyframe's BoW row (at its slot, known from the summary,
        so `mapping_step` stays one device program), compaction triggers
        and loop closing."""
        cam = self.cam
        with self.tracer.stage("mapping_fused"):
            m, summary = mapping_step(
                self.map, self._tensor(self.Tcw[:3, :3]),
                self._tensor(self.Tcw[:3, 3]), timestamp, feats.uv,
                feats.level, feats.bits, feats.mask,
                obs_clean.to(torch.int32), cam.fx, cam.fy, cam.cx, cam.cy,
                cam.width, cam.height, n_window=self.LOCAL_WINDOW,
                n_fixed_ring=self.LOCAL_FIXED_RING,
                stereo=(None if stereo is None
                        else (stereo.X_cam, stereo.valid)))
            self.map = m
            s = summary.cpu().numpy()
            n_kf_after, n_lm = int(s[12]), int(s[13])
            new_id = n_kf_after - 1
            self._add_bow_row(new_id, feats)
        self.kf_times.append(timestamp)
        self.frames_since_kf = 0
        self.last_kf_inliers = max(n_inl, 1)
        kf_remap = self._maybe_compact(n_kf=n_kf_after, n_lm=n_lm)
        if kf_remap is not None:
            new_id = int(kf_remap[new_id])
        closed, merged = self.n_loops_closed, self.n_maps_merged
        if self.settings.loop_closing:
            with self.tracer.stage("loop_closing"):
                self._try_close_loop(new_id, feats)
        if self.n_loops_closed != closed:
            # the correction moved the keyframe: re-read it
            self.Tcw = self._pose44(self.map.kf_R[new_id].cpu().numpy(),
                                    self.map.kf_t[new_id].cpu().numpy())
            self._mark_frame_ref_dirty()
        elif self.n_maps_merged != merged:
            # `_try_merge_maps` moved the live pose into the merged world
            self._mark_frame_ref_dirty()
        else:
            # adopt the BA-refined keyframe pose: it seeds the next frame's
            # motion model, and refills the frame-reference cache with no
            # fetch
            self.Tcw = self._pose44(s[:9].reshape(3, 3), s[9:12])
            self._frame_ref_cache = (timestamp, self.Tcw.copy(),
                                     float(self.scale_applied))
        self._last_kf_center = -self.Tcw[:3, :3].T @ self.Tcw[:3, 3]

    def _insert_keyframe_inertial(self, feats, obs_clean, timestamp: float,
                                  n_inl: int, stereo=None):
        """The inertial sensors' keyframe insertion, in the order of the
        JAX staged `_insert_keyframe` (:1580-1696): `insert_and_fuse`
        (with the rig sensors' stereo landmarks) and one summary fetch, the
        BoW row, the interval's preintegration, a joint visual-inertial
        window BA once the IMU is initialized (else the visual
        `window_ba`), the landmark culling, compaction, then the
        inertial schedule (VI initialization; full inertial BA at
        FULL_VIBA_AT intervals; scale refinement) and loop closing. The
        frame's pose becomes the keyframe's final one, except after a map
        merge, which has moved the live pose into the merged world."""
        cam = self.cam
        m, new_id = insert_and_fuse(
            self.map, self._tensor(self.Tcw[:3, :3]),
            self._tensor(self.Tcw[:3, 3]), timestamp, feats.uv, feats.level,
            feats.bits, feats.mask, obs_clean.to(torch.int32), cam.fx,
            cam.fy, cam.cx, cam.cy, cam.width, cam.height,
            stereo=None if stereo is None else (stereo.X_cam, stereo.valid))
        self.map = m
        s = keyframe_summary(m, new_id).cpu().numpy()
        n_kf_after, n_lm = int(s[12]), int(s[13])
        new_id = n_kf_after - 1
        self._add_bow_row(new_id, feats)
        self.kf_times.append(timestamp)
        self._finish_kf_preint(timestamp)
        with self.tracer.stage("local_ba"):
            if not (self.imu_initialized and self._vi_local_ba_step()):
                self.map = window_ba(self.map, new_id, cam.fx, cam.fy,
                                     cam.cx, cam.cy, self.LOCAL_WINDOW,
                                     self.LOCAL_FIXED_RING)
        self.map = trk.cull_landmarks(self.map)
        self.frames_since_kf = 0
        self.last_kf_inliers = max(n_inl, 1)
        kf_remap = self._maybe_compact(n_kf=n_kf_after, n_lm=n_lm)
        if kf_remap is not None:
            new_id = int(kf_remap[new_id])
        n_int = len(self.kf_preints)
        if not self.imu_initialized:
            if n_int >= self.VI_INIT_KFS - 1:
                self._run_vi_init()
        elif n_int in self.FULL_VIBA_AT:
            # joint VI BA over the recent map (FullInertialBA): reconciles
            # the map's geometry with the IMU where the inertial-only
            # refinement can only rescale rigidly
            self._run_inertial_gba(max_kfs=48, n_iters=8, opt_gravity=True)
        elif ((self._scale_stable_count < 2 and self._n_scale_refines < 12
               and n_int % 2 == 0) or n_int in self.SCALE_REFINE_AT):
            # refine every other keyframe until two consecutive estimates
            # agree, then on the sparse schedule
            self._refine_scale()
        merged = self.n_maps_merged
        if self.settings.loop_closing:
            with self.tracer.stage("loop_closing"):
                self._try_close_loop(new_id, feats)
        if self.n_maps_merged == merged and 0 <= new_id < int(self.map.n_kf):
            self.Tcw = self._pose44(self.map.kf_R[new_id].cpu().numpy(),
                                    self.map.kf_t[new_id].cpu().numpy())
        self._last_kf_center = -self.Tcw[:3, :3].T @ self.Tcw[:3, 3]
        self._mark_frame_ref_dirty()

    # ------------------------------------------------------ pipelined mode

    def _pack_pipe_imu(self, t_img: float):
        """This frame's fixed-shape IMU batch (gyro, acc (P, 3), dts (P,),
        mask (P,), numpy) over (chain time, t_img] from the pipelined
        buffer, P = `_pre_cap` (the JAX `_pack_pipe_imu`, :1233-1259).
        Samples after t_img stay in the buffer; those in the window past
        the P-th are dropped, as in JAX, and counted in
        `dropped_imu_samples`."""
        P = self._pre_cap
        gyro = np.zeros((P, 3), np.float32)
        acc = np.zeros((P, 3), np.float32)
        dts = np.zeros((P,), np.float32)
        mask = np.zeros((P,), bool)
        t_prev = self._chain_time if self._chain_time is not None else t_img
        keep = []
        i = 0
        for p in self._pipe_imu:
            if p.t <= t_prev:
                continue
            if p.t > t_img + 1e-9:
                keep.append(p)
                continue
            if i < P:
                gyro[i] = p.gyro
                acc[i] = p.acc
                dts[i] = max(p.t - t_prev, 0.0)
                t_prev = p.t
                mask[i] = True
                i += 1
            else:
                self.dropped_imu_samples += 1
        self._pipe_imu = keep
        return gyro, acc, dts, mask

    def _track_pipelined(self, im: np.ndarray, timestamp: float, t0: float):
        """Dispatch this frame's device program and consume the previous
        frame's summary, whose copy to the host was started a frame ago
        (the JAX `_track_pipelined`, :1261-1311)."""
        pend = self._dispatch_pipelined(im, timestamp, t0)
        if pend is not None:
            self._consume_pend(pend)

    def _dispatch_pipelined(self, im: np.ndarray, timestamp: float,
                            t0: float):
        """The dispatch half: upload the frame, run `frame_step` (MONOCULAR:
        constant velocity from the device pose chain (R, t, R_prev, t_prev))
        or `frame_step_vi` (the chain (R, t, v) and this frame's IMU
        batch), start the summary's copy, and make this frame the one in
        flight. Returns the previous one. Once the chain is up, nothing
        here waits for the device."""
        vi = self.sensor == Sensor.IMU_MONOCULAR
        if self._chain is None:
            R_cur = self._tensor(self.Tcw[:3, :3])
            t_cur = self._tensor(self.Tcw[:3, 3])
            if vi:
                self._chain = (R_cur, t_cur, self._tensor(self.v_cur))
                self._chain_time = (self.last_frame_time
                                    if self.last_frame_time is not None
                                    else timestamp)
            else:
                Tp = (np.linalg.inv(self.velocity) @ self.Tcw
                      if self.velocity is not None else self.Tcw)
                self._chain = (R_cur, t_cur, self._tensor(Tp[:3, :3]),
                               self._tensor(Tp[:3, 3]))
        img_np = self._host_image(im)
        H, W = img_np.shape
        cam = self.cam
        if vi:
            gyro, acc, dts, mask = self._pack_pipe_imu(timestamp)
            dtf = max(timestamp - self._chain_time, 1e-3)
            up = self._staging.upload(np.concatenate([
                img_np.reshape(-1), gyro.reshape(-1), acc.reshape(-1), dts,
                mask, self.bg, self.ba, [dtf]]).astype(np.float32))
            P = self._pre_cap
            x = up[H * W:]
            with self.tracer.stage("frame_step"):
                m2, feats, obs_clean, Rk, tk, v_new, summary = frame_step_vi(
                    self.map, *self._chain, up[:H * W].view(H, W),
                    x[:3 * P].view(P, 3), x[3 * P:6 * P].view(P, 3),
                    x[6 * P:7 * P], x[7 * P:8 * P], x[8 * P:8 * P + 3],
                    x[8 * P + 3:8 * P + 6], x[8 * P + 6], self._R_bc,
                    self._t_bc, cam, self.ex_cfg)
            self._chain = (Rk, tk, v_new)
            self._chain_time = timestamp
        else:
            img = self._staging.upload(img_np.reshape(-1)).view(H, W)
            with self.tracer.stage("frame_step"):
                m2, feats, obs_clean, Rk, tk, summary = frame_step(
                    self.map, *self._chain, img, cam, self.ex_cfg)
            self._chain = (Rk, tk, self._chain[0], self._chain[1])
        self.map = m2
        pend, self._pend = self._pend, (self._staging.fetch(summary), feats,
                                        obs_clean, timestamp, t0)
        return pend

    def _flush_pipeline(self):
        """Consume the frame in flight and finalize a dispatched keyframe,
        if any, and drop the device chain: every reader and every frame of
        the staged path calls it first."""
        pend, self._pend = self._pend, None
        if pend is not None:
            self._consume_pend(pend)
        self._finalize_pend_kf()
        self._chain = None
        self._chain_time = None
        self._pipe_imu = []

    def _drop_in_flight(self):
        """Drop the device chain and the frame in flight, recorded at the
        current pose."""
        self._chain = None
        self._chain_time = None
        drop, self._pend = self._pend, None
        if drop is not None:
            self._append_frame_record(drop[3], drop[4])

    def _insert_keyframe_fused_dispatch(self, feats, obs_clean,
                                        timestamp: float, n_inl: int):
        """The MONOCULAR keyframe insertion of the pipelined mode, dispatch
        half (the JAX `_insert_keyframe_fused_dispatch`, :1324-1351): one
        `mapping_step` and the start of its summary's copy; the next
        consume finalizes it (`_finalize_pend_kf`), so the device maps
        while the host dispatches the next frame."""
        cam = self.cam
        with self.tracer.stage("mapping_dispatch"):
            self.map, summary = mapping_step(
                self.map, self._tensor(self.Tcw[:3, :3]),
                self._tensor(self.Tcw[:3, 3]), timestamp, feats.uv,
                feats.level, feats.bits, feats.mask,
                obs_clean.to(torch.int32), cam.fx, cam.fy, cam.cx, cam.cy,
                cam.width, cam.height, n_window=self.LOCAL_WINDOW,
                n_fixed_ring=self.LOCAL_FIXED_RING)
        self.kf_times.append(timestamp)
        self.frames_since_kf = 0
        self.last_kf_inliers = max(n_inl, 1)
        self._pend_kf = (self._staging.fetch(summary, "keyframe"), timestamp,
                         feats)

    def _finalize_pend_kf(self) -> bool:
        """Finalize a dispatched keyframe insertion (the JAX
        `_finalize_pend_kf`, :1353-1389): read its summary, write the
        keyframe's BoW row at its slot, then compaction and loop closing.
        The consumed frames' poses stay the motion model's; the keyframe
        pose refills only the frame-reference cache. Returns True if the
        map was compacted, corrected or merged (the caller drops the
        chain)."""
        pk, self._pend_kf = self._pend_kf, None
        if pk is None:
            return False
        fetch, timestamp, feats = pk
        with self.tracer.stage("mapping_fused"):
            s = self._staging.read(fetch)
        n_kf_after, n_lm = int(s[12]), int(s[13])
        new_id = n_kf_after - 1
        self._add_bow_row(new_id, feats)
        before = (self._compact_events, self.n_loops_closed,
                  self.n_maps_merged)
        kf_remap = self._maybe_compact(n_kf=n_kf_after, n_lm=n_lm)
        if kf_remap is not None:
            new_id = int(kf_remap[new_id])
        if self.settings.loop_closing:
            with self.tracer.stage("loop_closing"):
                self._try_close_loop(new_id, feats)
        events = (self._compact_events, self.n_loops_closed,
                  self.n_maps_merged) != before
        if events:
            self._mark_frame_ref_dirty()
        else:
            T_kf = self._pose44(s[:9].reshape(3, 3), s[9:12])
            self._frame_ref_cache = (timestamp, T_kf,
                                     float(self.scale_applied))
            self._last_kf_center = -T_kf[:3, :3].T @ T_kf[:3, 3]
        return events

    def _append_frame_record(self, ts: float, t0: float):
        """A consumed frame's trajectory, frame-reference and tracking-log
        records."""
        self.trajectory.append((ts, self.Tcw.copy()))
        self.frame_refs.append(self._current_frame_ref())
        self.tracking_log.append({
            "t": ts, "state": int(self.state),
            "ms": (_time.perf_counter() - t0) * 1e3})

    def _consume_pend(self, pend):
        """Apply one frame's lagged result to the host state (the JAX
        `_consume_pend`, :1399-1471): finalize the keyframe dispatched at
        the previous consume, read the summary, decide LOST (one frame
        late: the frame in flight chained off the failed pose and is
        dropped, both recorded at the last good pose), take the pose, and
        insert a keyframe when the cadence asks for one."""
        fetch, feats, obs_clean, ts, t0 = pend
        if self._finalize_pend_kf():
            self._append_frame_record(ts, t0)
            self._drop_in_flight()
            return
        with self.tracer.stage("summary_fetch"):
            s = self._staging.read(fetch)
        n_match, n_inl, n_kf = int(s[12]), int(s[13]), int(s[14])
        self._scene_depth = float(s[15])
        if n_match < self.MIN_TRACK_INLIERS or n_inl < self.MIN_TRACK_INLIERS:
            self.state = TrackingState.LOST
            self._append_frame_record(ts, t0)
            self._drop_in_flight()
            return
        T_new = self._pose44(s[:9].reshape(3, 3), s[9:12])
        if self.last_Tcw is not None:
            self.velocity = T_new @ np.linalg.inv(self.last_Tcw)
        self.last_Tcw = T_new
        self.Tcw = T_new
        self.frames_since_kf += 1
        self.last_frame_feats = feats
        self.last_frame_time = ts
        if s.shape[0] >= 19:
            # the device's body velocity keeps the host's IMU state warm
            self.v_cur = s[16:19].astype(np.float64)
        self._append_frame_record(ts, t0)
        if not self._need_keyframe(n_inl, n_kf):
            return
        if self.sensor == Sensor.MONOCULAR:
            self._insert_keyframe_fused_dispatch(feats, obs_clean, ts, n_inl)
            return
        with self.tracer.stage("insert_kf"):
            before = (self._compact_events, self.scale_applied,
                      self.n_loops_closed, self.n_maps_merged)
            self._insert_keyframe_inertial(feats, obs_clean, ts, n_inl)
            if (self._compact_events, self.scale_applied,
                    self.n_loops_closed, self.n_maps_merged) != before:
                # the map was remapped or moved: the frame in flight
                # tracked against the old one
                self._drop_in_flight()

    # ------------------------------------------------------- map maintenance

    def _maybe_compact(self, n_kf: int = -1, n_lm: int = -1):
        """Reclaim culled-landmark slots and cull redundant keyframes when a
        capacity nears exhaustion. Returns the keyframe remap (old id -> new
        id, -1 dropped) if keyframes moved, else None."""
        if n_lm < 0:
            n_lm = int(self.map.n_lm)
        if n_lm > self.LM_COMPACT_FRAC * self.map_cfg.max_lm:
            self.map, _ = ms.compact_landmarks(self.map)
            self._compact_events += 1
        if n_kf < 0:
            n_kf = int(self.map.n_kf)
        if n_kf >= self.map_cfg.max_kf - self.KF_CULL_HEADROOM:
            remap = self._cull_keyframes()
            if remap is not None:
                self._compact_events += 1
                self._mark_frame_ref_dirty()
            return remap
        return None

    def _cull_keyframes(self):
        """Pick expendable keyframes (most redundant first, then decimate
        the oldest unprotected stretch), compact them out, and remap the
        host bookkeeping."""
        m = self.map
        n_kf = int(m.n_kf)
        protect_n = max(self.KF_PROTECT_RECENT, self.LOCAL_WINDOW,
                        self.VI_LOCAL_WINDOW + 1)
        if n_kf <= protect_n + 2:
            return None
        scores = ms.keyframe_redundancy(m).cpu().numpy()[:n_kf]
        protect = np.zeros(n_kf, bool)
        protect[:2] = True  # gauge anchors / map origin
        protect[n_kf - protect_n:] = True
        target_free = max(self.map_cfg.max_kf // 8, 4)
        cand = sorted(((scores[k], k) for k in range(n_kf)
                       if not protect[k] and scores[k] >= self.KF_REDUNDANT_TH),
                      reverse=True)
        cull = set(k for _, k in cand[:target_free])
        if len(cull) < target_free:
            for k in range(2, n_kf - protect_n, 2):
                if k not in cull:
                    cull.add(k)
                    if len(cull) >= target_free:
                        break
        if not cull:
            return None
        keep = np.ones(self.map_cfg.max_kf, bool)
        keep[list(cull)] = False
        m2, remap = ms.compact_keyframes(m, torch.from_numpy(keep).to(
            self.device))
        remap_np = remap.cpu().numpy()
        self.map = m2
        self._remap_host_kf_state(remap_np, n_kf)
        return remap_np

    def _remap_host_kf_state(self, remap: np.ndarray, old_n_kf: int):
        """Rewrite the host bookkeeping after a keyframe compaction: the
        keyframe times, the BoW rows (which follow their keyframes' slots;
        document counts recounted), the keyframe velocities, the last loop
        keyframe, the loop consistency groups and the inter-keyframe
        preintegrations; then the `kf_remap_listeners`."""
        kept = [k for k in range(old_n_kf) if remap[k] >= 0]
        self.kf_times = [self.kf_times[k] for k in kept
                         if k < len(self.kf_times)]
        self.bow_db = vocab_mod.place_rows(
            vocab_mod.empty_database(self.map_cfg.max_kf,
                                     self.vocab.n_words, self.device),
            self.bow_db, kept, remap[kept])
        self.kf_velocities = {
            int(remap[k]): v for k, v in self.kf_velocities.items()
            if 0 <= int(k) < old_n_kf and remap[int(k)] >= 0}
        if 0 <= self.last_loop_kf < old_n_kf:
            r = int(remap[self.last_loop_kf])
            self.last_loop_kf = r if r >= 0 else -10**9
        self._loop_consistency = [
            (g2, c) for g2, c in (
                ({int(remap[k]) for k in g
                  if 0 <= k < old_n_kf and remap[k] >= 0}, c)
                for g, c in self._loop_consistency) if g2]
        # preintegrations: kf_preints[i] ends at old keyframe old_n_kf - n +
        # i; the intervals across a culled keyframe merge (the reference's
        # MergePrevious). A gap before preintegration began truncates the
        # list's head; its tail stays aligned with the newest keyframes,
        # which is all the VI windows read.
        n_pre = len(self.kf_preints)
        if n_pre:
            end2pre = {old_n_kf - n_pre + i: p
                       for i, p in enumerate(self.kf_preints)}
            new_pre = []
            for a, b in zip(kept[:-1], kept[1:]):
                segs = [end2pre.get(e) for e in range(a + 1, b + 1)]
                if any(sg is None for sg in segs):
                    new_pre = []
                    continue
                p = segs[0]
                for sg in segs[1:]:
                    p = pre_mod.merge(p, sg)
                new_pre.append(p)
            self.kf_preints = new_pre
        # external subscribers (parallel/live_session.py keeps per-keyframe
        # BoW rows, feature records and weld anchors by slot)
        for cb in self.kf_remap_listeners:
            cb(remap, old_n_kf)

    # ------------------------------------------------------------ loop close

    LOOP_EXCLUDE = 12  # recent keyframes excluded from candidates
    LOOP_MIN_SCORE = 0.10
    LOOP_COOLDOWN = 10  # keyframes between accepted loops
    # a loop region must be re-detected on this many consecutive keyframes
    # before geometric verification (upstream LoopClosing::DetectLoop)
    LOOP_CONSISTENCY_TH = 2
    MERGE_MIN_SCORE = 0.10

    def _sim3_generator(self, offset: int) -> torch.Generator:
        """The Sim3 RANSAC draw of a verification, seeded as the JAX
        System keys it (`PRNGKey(n_frames + offset)`)."""
        return torch.Generator(device=self.device).manual_seed(
            self.n_frames + offset)

    def _try_close_loop(self, new_kf: int, feats):
        """Cross-map merging (when the Atlas holds other maps), then BoW
        candidates → covisibility-group accumulation → temporal consistency
        → Sim3 verification → essential-graph correction → seam fusion →
        global BA (the JAX `_try_close_loop`, :1895-1995)."""
        if self.atlas.n_maps() > 1 and new_kf >= 2:
            if self._try_merge_maps(new_kf, feats):
                return
        if new_kf < self.LOOP_EXCLUDE + 2:
            return
        if new_kf - self.last_loop_kf < self.LOOP_COOLDOWN:
            return
        covis = ms.covisibility_matrix(self.map).cpu().numpy()
        K = self.map_cfg.max_kf
        exclude = np.zeros((K,), bool)
        exclude[covis[new_kf] > 0] = True
        exclude[max(new_kf - self.LOOP_EXCLUDE, 0):] = True
        scores, ids = vocab_mod.query(
            self.bow_db, self.vocab, feats.signs, feats.mask,
            torch.from_numpy(exclude).to(self.device), top_k=8)
        scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
        # covisibility-group accumulation (upstream KeyFrameDatabase::
        # DetectLoopCandidates): groups under 0.75x the best accumulated
        # score drop out, the best member represents each group
        hits = [(int(ids[r]), float(scores[r])) for r in range(len(ids))
                if scores[r] >= self.LOOP_MIN_SCORE]
        acc = []
        for c, sc in hits:
            group = set(np.flatnonzero(covis[c] > 0).tolist()) | {c}
            acc.append((c, sc, sum(s2 for c2, s2 in hits if c2 in group)))
        keep_ids, keep_scores = [], []
        if acc:
            best_acc = max(a for _, _, a in acc)
            seen: set = set()
            for c, sc, a in sorted(acc, key=lambda x: -x[2]):
                if a < 0.75 * best_acc or c in seen:
                    continue
                keep_ids.append(c)
                keep_scores.append(sc)
                seen |= set(np.flatnonzero(covis[c] > 0).tolist())
                seen.add(c)
        consistent = self._update_loop_consistency(
            np.asarray(keep_scores, np.float32),
            np.asarray(keep_ids, np.int32), covis)
        fix_scale = self.imu_initialized or self._metric_scale
        cam = self.cam
        for cand_kf in consistent:
            cand = closing_mod.detect_and_verify(
                self.map, new_kf, cand_kf, self._sim3_generator(cand_kf),
                fix_scale=fix_scale)
            if cand is None:
                continue
            self.map = closing_mod.close_loop(self.map, new_kf, cand,
                                              covis=covis,
                                              fix_scale=fix_scale)
            # SearchAndFuse across the seam: duplicates created while the
            # loop was open merge into their older counterparts
            for seam_kf in (new_kf, cand.cand_kf):
                self.map, _, _ = trk.fuse_map_points(
                    self.map, seam_kf, cam.fx, cam.fy, cam.cx, cam.cy,
                    cam.width, cam.height)
            # the global polish: a full inertial BA once the IMU is
            # initialized (a visual-only one would fight the gravity and
            # scale states)
            if self.imu_initialized:
                self._run_inertial_gba()
            else:
                self._run_global_ba(n_iters=8)
            self.Tcw = self._pose44(self.map.kf_R[new_kf].cpu().numpy(),
                                    self.map.kf_t[new_kf].cpu().numpy())
            self.last_Tcw = self.Tcw.copy()
            self.velocity = None
            self.n_loops_closed += 1
            self.last_loop_kf = new_kf
            return

    def _update_loop_consistency(self, scores, ids, covis) -> list:
        """Temporal-consistency vetting: each candidate expands to its
        covisible group, and becomes consistent when its group meets a
        group detected on LOOP_CONSISTENCY_TH consecutive keyframes.
        Returns the candidate ids cleared for verification."""
        consistent, new_groups = [], []
        for rank in range(len(ids)):
            if scores[rank] < self.LOOP_MIN_SCORE:
                continue
            cand = int(ids[rank])
            group = set(np.flatnonzero(covis[cand] > 0).tolist()) | {cand}
            count = 1
            for prev_group, prev_count in self._loop_consistency:
                if group & prev_group:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count >= self.LOOP_CONSISTENCY_TH:
                consistent.append(cand)
        self._loop_consistency = new_groups
        return consistent

    def _run_global_ba(self, n_iters: int = 8):
        """`tracking.global_ba` over the live keyframes; with a mesh, the
        same window (the live keyframes padded to a power of 2, keyframe 0
        fixed) solved landmark-sharded over it (JAX :2033-2047)."""
        n_kf = int(self.map.n_kf)
        if n_kf < 2:
            return
        cam = self.cam
        if self.mesh is not None:
            ids, fix = trk.global_ba_window(n_kf, self.map_cfg.max_kf,
                                            self.device)
            self.map = distributed_map.distributed_map_ba(
                self.map, ids, fix, self.mesh, cam.fx, cam.fy, cam.cx,
                cam.cy, n_iters=n_iters)
            self.n_mesh_solves += 1
        else:
            self.map = trk.global_ba(self.map, n_kf, cam.fx, cam.fy, cam.cx,
                                     cam.cy, n_iters=n_iters)
        self._mark_frame_ref_dirty()

    def _try_merge_maps(self, new_kf: int, feats) -> bool:
        """A BoW hit in another Atlas map → Sim3 → PnP refinement → weld the
        active map into it; the merged map becomes the active one (the JAX
        `_try_merge_maps`, :2107-2213)."""
        cam = self.cam
        K = self.map_cfg.max_kf
        for mi in range(self.atlas.n_maps()):
            if mi == self.atlas.active:
                continue
            old_map = self.atlas.maps[mi]
            old_db = self.atlas.bow_dbs[mi]
            if int(old_db.n) < 1:
                continue
            scores, ids = vocab_mod.query(
                old_db, self.vocab, feats.signs, feats.mask,
                torch.zeros((K,), dtype=torch.bool, device=self.device),
                top_k=1)
            if float(scores[0]) < self.MERGE_MIN_SCORE:
                continue
            cand = merging_mod.detect_cross_map(
                self.map, new_kf, old_map, int(ids[0]),
                self._sim3_generator(77),
                fix_scale=self.imu_initialized or self._metric_scale)
            if cand is None:
                continue
            cand = merging_mod.refine_weld_pnp(self.map, old_map, cand,
                                               cam.fx, cam.fy, cam.cx, cam.cy)
            # detect_cross_map solved x_active = s R x_old + t; the active
            # map is welded into the old one, so invert
            s_inv = 1.0 / cand.s
            R_inv = cand.R.T
            t_inv = -s_inv * (R_inv @ cand.t)
            alias = np.full(self.map_cfg.max_lm, -1, np.int32)
            if cand.lm_pairs.size:
                alias[cand.lm_pairs[:, 0]] = cand.lm_pairs[:, 1]
            merged, kept_kf, first_slot = merging_mod.merge_maps(
                old_map, self.map, R_inv, t_inv, s_inv, self.map_cfg,
                lm_alias=alias)
            # BoW rows: the old map's, then the kept active rows at their
            # keyframes' new slots
            new_db = vocab_mod.place_rows(
                old_db, self.bow_db, kept_kf,
                first_slot + np.arange(len(kept_kf)))
            prev_active = self.atlas.active
            self.atlas.maps[mi] = merged
            self.atlas.bow_dbs[mi] = new_db
            del self.atlas.maps[prev_active]
            del self.atlas.bow_dbs[prev_active]
            self.atlas.active = mi if mi < prev_active else mi - 1
            self.kf_times = self._map_kf_times()
            # the active map's keyframes moved to slots from first_slot on;
            # the preintegrations between the kept ones stay
            shift = first_slot - (int(kept_kf[0]) if len(kept_kf) else 0)
            kept_set = set(int(x) for x in kept_kf)
            self.kf_velocities = {
                int(k) + shift: v for k, v in self.kf_velocities.items()
                if int(k) in kept_set}
            keep_int = max(len(kept_kf) - 1, 0)
            self.kf_preints = self.kf_preints[-keep_int:] if keep_int else []
            # the live pose into the merged world
            R_cw2 = self.Tcw[:3, :3] @ R_inv.T
            t_cw2 = s_inv * self.Tcw[:3, 3] - R_cw2 @ t_inv
            self.Tcw = self._pose44(R_cw2, t_cw2)
            self.last_Tcw = self.Tcw.copy()
            self.velocity = None
            if self.v_cur is not None:
                self.v_cur = s_inv * (R_inv @ np.asarray(self.v_cur))
            self.n_maps_merged += 1
            self.last_loop_kf = int(merged.n_kf) - 1
            return True
        return False

    # ------------------------------------------------------- relocalization

    LOST_FRAMES_NEW_MAP = 20  # ~2 s at 10 FPS before spawning a fresh map
    MIN_KFS_KEEP_MAP = 8  # smaller lost maps are discarded, not frozen
    RELOC_MIN_SCORE = 0.05  # BoW floor for cross-map candidates
    RELOC_MIN_MATCHES = 25  # matches and pose inliers a try needs

    def _reloc_try(self, m: ms.MapState, feats, R0, t0, radius: float):
        """Search-by-projection from the pose (R0, t0) at `radius` px with
        max_dist 45, then the pose LM: the refined (R, t), or None under
        RELOC_MIN_MATCHES matches or inliers (one host sync on each)."""
        cam = self.cam
        tm = trk.match_to_map(
            m, feats.uv, feats.bits, feats.mask, R0, t0, cam.fx, cam.fy,
            cam.cx, cam.cy, cam.width, cam.height, radius=radius,
            max_dist=45.0, cap_visible=self._cap_vis)
        if int(tm.n_matches) < self.RELOC_MIN_MATCHES:
            return None
        res, _ = trk.track_pose(m, tm.obs_lm, feats.uv, feats.level, R0, t0,
                                cam.fx, cam.fy, cam.cx, cam.cy,
                                scale_factor=self.ex_cfg.scale_factor)
        if int(res.n_inliers) < self.RELOC_MIN_MATCHES:
            return None
        return res.R, res.t

    def _relocalize(self, feats, timestamp: float):
        """Relocalization: the last pose at 80 px, then the BoW top-5
        keyframes of the active map at 60 px; then every other Atlas map;
        after LOST_FRAMES_NEW_MAP failures a small unprotected map restarts
        in place and any other is frozen behind a new map."""
        del timestamp
        self._mark_frame_ref_dirty()
        tries = [(self._tensor(self.Tcw[:3, :3]),
                  self._tensor(self.Tcw[:3, 3]), 80.0)]
        n_kf = int(self.map.n_kf)
        if n_kf > 0:
            scores, ids = vocab_mod.query(
                self.bow_db, self.vocab, feats.signs, feats.mask,
                torch.zeros((self.map_cfg.max_kf,), dtype=torch.bool,
                            device=self.device), top_k=5)
            for sc, kid in zip(scores.cpu().numpy(), ids.cpu().numpy()):
                if sc > 0.0:
                    tries.append((self.map.kf_R[kid], self.map.kf_t[kid],
                                  60.0))
        for R0, t0, radius in tries:
            pose = self._reloc_try(self.map, feats, R0, t0, radius)
            if pose is not None:
                self.Tcw = self._pose44(pose[0].cpu().numpy(),
                                        pose[1].cpu().numpy())
                self.last_Tcw = self.Tcw.copy()
                self.velocity = None
                self.state = TrackingState.OK
                self.frames_lost = 0
                return
        if self._reloc_other_maps(feats):
            return
        self.frames_lost += 1
        if self.frames_lost >= self.LOST_FRAMES_NEW_MAP:
            if n_kf < self.MIN_KFS_KEEP_MAP and not self._map_protected:
                self.atlas.reset_current()
                self._spawn_state_reset()
            else:
                self._spawn_new_map()

    def _reloc_other_maps(self, feats) -> bool:
        """Atlas-wide relocalization: each non-active map's BoW top-2 at 60
        px; on a verified hit that map becomes the active one."""
        K = self.map_cfg.max_kf
        for mi in range(self.atlas.n_maps()):
            if mi == self.atlas.active:
                continue
            old_map = self.atlas.maps[mi]
            old_db = self.atlas.bow_dbs[mi]
            if int(old_db.n) < 1:
                continue
            scores, ids = vocab_mod.query(
                old_db, self.vocab, feats.signs, feats.mask,
                torch.zeros((K,), dtype=torch.bool, device=self.device),
                top_k=2)
            for sc, kid in zip(scores.cpu().numpy(), ids.cpu().numpy()):
                if sc < self.RELOC_MIN_SCORE:
                    continue
                pose = self._reloc_try(old_map, feats, old_map.kf_R[kid],
                                       old_map.kf_t[kid], 60.0)
                if pose is not None:
                    self._switch_active_map(mi)
                    self.Tcw = self._pose44(pose[0].cpu().numpy(),
                                            pose[1].cpu().numpy())
                    self.last_Tcw = self.Tcw.copy()
                    return True
        return False

    def _switch_active_map(self, mi: int):
        """Resume Atlas map `mi`. The abandoned map stays frozen if it has
        MIN_KFS_KEEP_MAP keyframes or is protected; else it is dropped."""
        prev = self.atlas.active
        if int(self.map.n_kf) < self.MIN_KFS_KEEP_MAP and \
                not self._map_protected:
            del self.atlas.maps[prev]
            del self.atlas.bow_dbs[prev]
            if mi > prev:
                mi -= 1
        self.atlas.active = mi
        self.kf_times = self._map_kf_times()
        # the inertial chain is broken across the gap: preintegration
        # restarts
        self.kf_preints = []
        self.kf_velocities = {}
        self._kf_imu_buf = []
        self._loop_consistency = []
        self._map_protected = True  # resumed history is never discarded
        self.velocity = None
        self.v_cur = None
        self.state = TrackingState.OK
        self.frames_lost = 0
        self.frames_since_kf = 0
        self.last_loop_kf = -10**9

    def _spawn_state_reset(self):
        self._mark_frame_ref_dirty()
        self.state = TrackingState.NOT_INITIALIZED
        self.Tcw = np.eye(4, dtype=np.float32)
        self.velocity = None
        self.last_Tcw = None
        self.ref_feats = None
        self.ref_time = None
        self.frames_since_kf = 0
        self.frames_lost = 0
        self.kf_times = []
        self.kf_preints = []
        self.kf_velocities = {}
        self._kf_imu_buf = []
        self.v_cur = None
        self.last_loop_kf = -10**9
        self._loop_consistency = []

    # ------------------------------------------------------------------ IMU

    def _body_center(self, Tcw: np.ndarray) -> np.ndarray:
        """World position of the IMU body for a camera pose T_cw."""
        R_bc, t_bc = self._T_bc[:3, :3], self._T_bc[:3, 3]
        R_bw = R_bc @ Tcw[:3, :3]
        t_bw = R_bc @ Tcw[:3, 3] + t_bc
        return -R_bw.T @ t_bw

    @staticmethod
    def _hat_np(v):
        return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]],
                         [-v[1], v[0], 0]], float)

    @staticmethod
    def _so3_exp_np(phi: np.ndarray) -> np.ndarray:
        th = float(np.linalg.norm(phi))
        if th < 1e-12:
            return np.eye(3) + System._hat_np(phi)
        A = System._hat_np(phi / th)
        return np.eye(3) + np.sin(th) * A + (1.0 - np.cos(th)) * (A @ A)

    def _predict_pose_imu(self, imu_points, t_img: float
                          ) -> Optional[np.ndarray]:
        """Integrate the frame's gyro/accel samples forward from the last
        frame to predict the camera pose (the reference's PredictStateIMU),
        on the host in float64, as the JAX System does. None before the
        IMU is initialized, without a velocity or without samples."""
        if not self.imu_initialized or self.v_cur is None or not imu_points:
            return None
        t_prev = self.last_frame_time
        if t_prev is None:
            return None
        R_bc, t_bc = self._T_bc[:3, :3], self._T_bc[:3, 3]
        R_cw = self.Tcw[:3, :3].astype(float)
        t_cw = self.Tcw[:3, 3].astype(float)
        R_bw = R_bc @ R_cw
        t_bw = R_bc @ t_cw + t_bc
        R_wb = R_bw.T
        p_wb = -R_bw.T @ t_bw
        v = np.asarray(self.v_cur, float).copy()
        g = np.array(pre_mod.GRAVITY)
        t0 = t_prev
        for pt in imu_points:
            if pt.t <= t_prev or pt.t > t_img + 1e-9:
                continue
            dt = min(pt.t, t_img) - t0
            if dt <= 0:
                continue
            w = pt.gyro - self.bg
            a = pt.acc - self.ba
            a_w = R_wb @ a + g
            p_wb = p_wb + v * dt + 0.5 * a_w * dt * dt
            v = v + a_w * dt
            R_wb = R_wb @ self._so3_exp_np(w * dt)
            t0 = pt.t
        R_bw = R_wb.T
        t_bw = -R_bw @ p_wb
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R_bc.T @ R_bw
        T[:3, 3] = R_bc.T @ (t_bw - t_bc)
        return T

    def _start_kf_preint(self):
        self._kf_imu_buf = []

    def _finish_kf_preint(self, timestamp: float):
        """Preintegrate the buffered samples of the interval ending at this
        keyframe, (t_prev_kf, timestamp]. A virtual sample at the keyframe's
        time closes it (linear interpolation against the next sample, or a
        zero-order hold when it has not arrived), as the reference's
        PreintegrateIMU does: dropping that tail lost ~g·dt_sample of
        velocity per interval in the JAX package.

        The JAX System integrates a batch of 4 * _pre_cap rows and drops
        any sample past it silently; the port keeps that result and counts
        the dropped samples in `dropped_imu_samples`. It integrates only
        the rows that hold samples: the masked rows of the JAX batch leave
        the state unchanged, so the result is the same."""
        buf = [p for p in self._kf_imu_buf if p.t <= timestamp]
        rest = [p for p in self._kf_imu_buf if p.t > timestamp]
        if buf and buf[-1].t < timestamp - 1e-9:
            a = buf[-1]
            if rest:
                b = rest[0]
                w = (timestamp - a.t) / max(b.t - a.t, 1e-9)
                gy = (1.0 - w) * a.gyro + w * b.gyro
                ac = (1.0 - w) * a.acc + w * b.acc
            else:
                gy, ac = a.gyro, a.acc
            buf = buf + [ImuPoint(ac, gy, timestamp)]
        self._kf_imu_buf = rest
        cap = self._pre_cap * 4
        self.dropped_imu_samples += max(len(buf) - cap, 0)
        buf = buf[:cap]
        n = len(buf)
        gyro = np.zeros((n, 3), np.float32)
        acc = np.zeros((n, 3), np.float32)
        dts = np.zeros((n,), np.float32)
        tprev = self.kf_times[-2] if len(self.kf_times) >= 2 else (
            buf[0].t if buf else timestamp)
        for i, p in enumerate(buf):
            gyro[i] = p.gyro
            acc[i] = p.acc
            dts[i] = max(p.t - tprev, 1e-5)
            tprev = p.t
        self.kf_preints.append(pre_mod.preintegrate(
            self._tensor(gyro), self._tensor(acc), self._tensor(dts),
            torch.ones((n,), dtype=torch.bool, device=self.device),
            self._tensor(self.bg), self._tensor(self.ba),
            noise_gyro=self.settings.noise_gyro,
            noise_acc=self.settings.noise_acc))

    def _inertial_window(self, max_int: Optional[int] = None):
        """The consecutive-keyframe window the stored preintegrations cover:
        (kf_ids, stacked preintegrations, body R_wb, body p_wb) or None.
        The length is bucketed as in the JAX System (48, 32, 24, 16, 12, 8
        intervals): scale and gravity separate only over windows with
        enough variation of the acceleration."""
        n_kf = int(self.map.n_kf)
        n_int = len(self.kf_preints)
        if max_int is not None and n_int > max_int:
            n_int = max_int
        for b in (48, 32, 24, 16, 12, 8):
            if n_int >= b:
                n_int = b
                break
        k0 = n_kf - (n_int + 1)
        if k0 < 0 or n_int < 2:
            return None
        kf_ids = np.arange(k0, n_kf)
        R_cw = self.map.kf_R[k0:n_kf].cpu().numpy()
        t_cw = self.map.kf_t[k0:n_kf].cpu().numpy()
        R_bc = self._T_bc[:3, :3].astype(np.float32)
        t_bc = self._T_bc[:3, 3].astype(np.float32)
        # T_wb = T_wc ∘ T_cb
        R_wc = np.swapaxes(R_cw, -1, -2)
        p_wc = -np.einsum("kij,kj->ki", R_wc, t_cw)
        R_wb = R_wc @ R_bc.T[None]
        p_wb = p_wc - np.einsum("kij,jl,l->ki", R_wc, R_bc.T, t_bc)
        return (kf_ids, pre_mod.stack(self.kf_preints[-n_int:]), R_wb,
                p_wb)

    def _velocity_guess(self, k: int, kR, kt) -> np.ndarray:
        """Backward difference of the camera centres of keyframes k-1, k."""
        k1 = max(k - 1, 0)
        c2 = -kR[k].T @ kt[k]
        c1 = -kR[k1].T @ kt[k1]
        dt = max(self.kf_times[k] - self.kf_times[k1], 1e-3)
        return (c2 - c1) / dt

    def _vi_ba(self, window, fixed, pres, v0, **kw):
        cam = self.cam
        return vi_ba2(
            self.map, torch.as_tensor(np.asarray(window), dtype=torch.int32,
                                      device=self.device),
            torch.as_tensor(np.asarray(fixed), device=self.device), pres,
            self._tensor(np.stack(v0)), self._tensor(self.bg),
            self._tensor(self.ba), cam.fx, cam.fy, cam.cx, cam.cy,
            self._R_bc, self._t_bc, **kw)

    def _refine_scale(self):
        """Inertial-only re-estimation of the residual scale and gravity
        over the recent window; applies a damped correction when the
        window observes it."""
        self._mark_frame_ref_dirty()
        self._n_scale_refines += 1
        win = self._inertial_window(self.SCALE_REFINE_MAX_INT)
        if win is None:
            return
        kf_ids, pres, R_wb, p_wb = win
        # gyro bias lightly anchored at the running estimate; accel bias
        # re-anchored at zero (a running-estimate anchor let a corrupted
        # ba mask the residual scale completely in the JAX package)
        out = vii.vi_init(pres, self._tensor(R_wb), self._tensor(p_wb),
                          prior_bg=1e4, prior_ba=1e10,
                          bg_center=self._tensor(self.bg))
        s = float(out.scale)
        if not (0.2 < s < 5.0) or not np.isfinite(s):
            self._scale_stable_count = 0
            return
        if abs(s - 1.0) < 0.02:
            self._scale_stable_count += 1
        else:
            self._scale_stable_count = 0
        # observability-weighted: confident windows apply (nearly) the full
        # correction, noisy ones almost none; low-confidence ones skip
        sigma = float(np.sqrt(max(float(out.scale_var), 0.0)))
        gain = 1.0 / (1.0 + (sigma / 0.03) ** 2)
        if gain < 0.25:
            return
        # a capped step per refinement: one large Sim3 mid-run disturbs
        # tracking more than the scale error does
        dlog = float(np.clip(gain * np.log(s), -0.1, 0.1))
        s = float(np.exp(dlog))
        thg = gain * lie.so3_log(out.R_wg).cpu().numpy()
        nrm = float(np.linalg.norm(thg))
        if nrm > 0.05:
            thg = thg * (0.05 / nrm)
        if abs(s - 1.0) < 0.01 and np.linalg.norm(thg) < 5e-3:
            return
        R_wg = lie.so3_exp(self._tensor(thg)).cpu().numpy()
        self.map = apply_sim3_to_map(self.map, self._tensor(R_wg.T),
                                     self._tensor(s))
        self.Tcw = self._pose44(self.Tcw[:3, :3] @ R_wg, self.Tcw[:3, 3] * s)
        self.last_Tcw = self.Tcw.copy()
        self.velocity = None
        self.bg = out.bg.cpu().numpy()
        # self.ba is not updated: the refinement anchors ba at zero only to
        # make the scale observable; the joint VI BA estimates ba
        self.scale_applied *= s
        # the scene depth is in map units: it rides every world Sim3
        if self._scene_depth is not None:
            self._scene_depth *= s
        v_opt = out.v.cpu().numpy() @ R_wg
        self.kf_velocities.update(
            {int(k): v_opt[i] for i, k in enumerate(kf_ids)})

    def _vi_local_ba_step(self) -> bool:
        """Joint visual-inertial BA over the sliding keyframe window (the
        reference's LocalInertialBA): reprojection and preintegration
        factors, velocities and biases refined, gravity held, and the
        VI_FIXED_RING most covisible older keyframes held fixed so that the
        window cannot drift off the map."""
        self._mark_frame_ref_dirty()
        W = self.VI_LOCAL_WINDOW
        n_kf = int(self.map.n_kf)
        n_int = len(self.kf_preints)
        if n_kf < W or n_int < W - 1:
            return False
        kf_ids = np.arange(n_kf - W, n_kf)
        pres = pre_mod.stack(self.kf_preints[-(W - 1):])
        kR = self.map.kf_R[:n_kf].cpu().numpy()
        kt = self.map.kf_t[:n_kf].cpu().numpy()
        v0 = []
        for k in kf_ids:
            v = self.kf_velocities.get(int(k))
            if v is None:
                v = self._velocity_guess(int(k), kR, kt)
            v0.append(np.asarray(v, np.float32))
        R_RING = self.VI_FIXED_RING
        covis = ms.covisibility_matrix(self.map).cpu().numpy()
        ring_w = covis[kf_ids].sum(0).astype(np.float64)
        ring_w[kf_ids] = -1.0
        ring_w[n_kf:] = -1.0
        order = np.argsort(-ring_w)[:R_RING]
        ring = [int(r) for r in order if ring_w[r] > 0]
        ring += [int(kf_ids[0])] * (R_RING - len(ring))  # pad; deduped
        window = np.concatenate([kf_ids, np.asarray(ring, np.int64)])
        fixed = np.zeros(W + R_RING, bool)
        fixed[0] = True
        fixed[W:] = True
        v0 += [np.zeros(3, np.float32)] * R_RING  # ring velocities unused
        m2, v_opt, bg2, ba2, cost, _ = self._vi_ba(
            window, fixed, pres, v0, opt_gravity=False, n_inertial=W - 1)
        if not np.isfinite(float(cost)):
            return False
        self.map = m2
        self.bg = bg2.cpu().numpy()
        self.ba = ba2.cpu().numpy()
        v_opt = v_opt.cpu().numpy()
        self.kf_velocities.update(
            {int(k): v_opt[i] for i, k in enumerate(kf_ids)})
        self.v_cur = v_opt[W - 1]  # the last consecutive entry, not the ring
        last = int(kf_ids[-1])
        self.Tcw = self._pose44(self.map.kf_R[last].cpu().numpy(),
                                self.map.kf_t[last].cpu().numpy())
        self.last_Tcw = self.Tcw.copy()
        return True

    def _run_vi_init(self):
        """VIBA1: inertial-only optimization with the visual poses fixed;
        the map takes the recovered scale and gravity rotation; then VIBA2,
        the joint visual-inertial BA over the window (FullInertialBA)."""
        self._mark_frame_ref_dirty()
        win = self._inertial_window()
        if win is None:
            return
        kf_ids, pres, R_wb, p_wb = win
        # stereo(-inertial) and RGB-D maps are metric already: log s = 0
        fixed_scale = self.sensor in (Sensor.IMU_STEREO, Sensor.IMU_RGBD)
        out = vii.vi_init(pres, self._tensor(R_wb), self._tensor(p_wb),
                          fix_scale=fixed_scale)
        s = float(out.scale)
        if not (0.05 < s < 50.0) or not np.isfinite(s):
            return
        # observability gate (monocular): no upgrade on a window whose
        # log-scale posterior std says the estimate is unreliable; with a
        # fixed scale that variance is meaningless
        if (not fixed_scale
                and float(np.sqrt(max(float(out.scale_var), 0.0))) > 0.3):
            return
        R_wg = out.R_wg.cpu().numpy()
        # gravity to world -z, the map to metric units
        self.map = apply_sim3_to_map(self.map, self._tensor(R_wg.T),
                                     self._tensor(s))
        self.Tcw = self._pose44(self.Tcw[:3, :3] @ R_wg, self.Tcw[:3, 3] * s)
        self.last_Tcw = self.Tcw.copy()
        self.velocity = None
        self.bg = out.bg.cpu().numpy()
        self.ba = out.ba.cpu().numpy()
        self.scale_applied = s
        if self._scene_depth is not None:
            self._scene_depth *= s  # depth rides the world Sim3
        self.imu_initialized = True
        self.inertial_ba1 = True
        self._scale_stable_count = 0  # start the convergence-driven refine

        # VIBA2 over the init window; the velocities rotate with the
        # gravity alignment (already metric)
        v_new = out.v.cpu().numpy() @ R_wg
        fixed = np.zeros(len(kf_ids), bool)
        fixed[0] = True
        m2, v_opt, bg2, ba2, cost, thg = self._vi_ba(kf_ids, fixed, pres,
                                                     list(v_new))
        if np.isfinite(float(cost)):
            self.map = m2
            self.bg = bg2.cpu().numpy()
            self.ba = ba2.cpu().numpy()
            v_opt = v_opt.cpu().numpy()
            # VIBA2 refines the gravity direction too: rotate the world so
            # that gravity is -z again
            thg = thg.cpu().numpy()
            if np.linalg.norm(thg) > 1e-8:
                R_g = lie.so3_exp(self._tensor(
                    [thg[0], thg[1], 0.0])).cpu().numpy()
                self.map = apply_sim3_to_map(self.map, self._tensor(R_g.T),
                                             self._tensor(1.0))
                v_opt = v_opt @ R_g
            self.kf_velocities = {int(k): v_opt[i]
                                  for i, k in enumerate(kf_ids)}
            self.v_cur = v_opt[-1]
            last = int(kf_ids[-1])
            self.Tcw = self._pose44(self.map.kf_R[last].cpu().numpy(),
                                    self.map.kf_t[last].cpu().numpy())
            self.last_Tcw = self.Tcw.copy()
            self.velocity = None
        self.inertial_ba2 = True

    def _run_inertial_gba(self, max_kfs: int = 64, n_iters: int = 10,
                          opt_gravity: bool = False):
        """Full inertial BA over the trailing consecutive keyframes that
        the stored preintegrations cover (at most `max_kfs`), keyframe 0 of
        the window fixed: after a loop correction (the reference's
        RunGlobalBundleAdjustment → FullInertialBA) and at FULL_VIBA_AT.
        Velocities restart from backward differences of the (corrected)
        keyframe poses."""
        self._mark_frame_ref_dirty()
        n_kf = int(self.map.n_kf)
        W = min(len(self.kf_preints) + 1, n_kf, max_kfs)
        if W < 3:
            return
        kf_ids = np.arange(n_kf - W, n_kf)
        pres = pre_mod.stack(self.kf_preints[-(W - 1):])
        kR = self.map.kf_R[:n_kf].cpu().numpy()
        kt = self.map.kf_t[:n_kf].cpu().numpy()
        v0 = [self._velocity_guess(int(k), kR, kt).astype(np.float32)
              for k in kf_ids]
        fixed = np.zeros(W, bool)
        fixed[0] = True
        m2, v_opt, bg2, ba2, cost, _ = self._vi_ba(
            kf_ids, fixed, pres, v0, opt_gravity=opt_gravity,
            n_iters=n_iters)
        if not np.isfinite(float(cost)):
            return
        self.map = m2
        self.bg = bg2.cpu().numpy()
        self.ba = ba2.cpu().numpy()
        v_opt = v_opt.cpu().numpy()
        self.kf_velocities.update(
            {int(k): v_opt[i] for i, k in enumerate(kf_ids)})
        self.v_cur = v_opt[-1]
