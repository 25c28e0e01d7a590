"""The System: the reference's host API over the port's device functions.

Port of `orb_slam3_ros2_tpu/runtime/system.py`, the synchronous visual
subset. `System.track_monocular` initializes a map from two views;
`System.track_stereo` (rectified scanline or general two-view rig) and
`System.track_rgbd` initialize from one frame's metric depth. Each frame is
then tracked against the map, and keyframes go through `mapping_step`
(insert → triangulate against two partners → stereo landmarks, for the rig
sensors → fuse → local BA → cull) with one device-to-host fetch per
keyframe (the packed summary). Also here: `undistort` and `frame_step`, the
per-frame program of the JAX `System._build_jitted` (:205-210, :422-450).

What this slice leaves out raises `NotImplementedError` naming the ROADMAP
item it waits on (`ROADMAP.md` §1): the inertial sensors (item 7), loop
closing, a vocabulary, a saved atlas and relocalization after tracking is
lost (item 8, which ports `loop/vocab.py` and the Atlas), and the
pipelined mode (item 10).
"""

from __future__ import annotations

import dataclasses
import enum
import time as _time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
from orb_slam3_ros2_tpu_torch.frontend import initializer as init_mod
from orb_slam3_ros2_tpu_torch.frontend import stereo as stereo_mod
from orb_slam3_ros2_tpu_torch.frontend import tracking as trk
from orb_slam3_ros2_tpu_torch.geom import lie
from orb_slam3_ros2_tpu_torch.io import settings as settings_mod
from orb_slam3_ros2_tpu_torch.models import cameras as cam_mod
from orb_slam3_ros2_tpu_torch.ops import matcher

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


def mapping_step(m: ms.MapState, R, t, timestamp, uv, level, bits, mask,
                 obs_clean, fx, fy, cx, cy, width, height, n_window: int,
                 n_fixed_ring: int, ba_iters: int = 10, stereo=None):
    """The whole visual keyframe insertion (the JAX `mapping_step`,
    `runtime/system.py:369-418`): insert the keyframe → triangulate against
    its predecessor → add landmarks → pick the most covisible second
    partner → strict triangulation → add → SearchAndFuse → covisibility-
    window local BA → landmark culling.

    `stereo` = (X_cam (N, 3), valid (N,)) adds the rig sensors' stage after
    the triangulations, in the order of the JAX staged
    `_insert_keyframe(..., stereo=sm)` (:1580-1696): landmarks for the
    features still without a map point, placed with the tracked pose (R, t)
    from before BA (`add_stereo_landmarks`).

    Keyframe ids stay 0-dim device tensors and the second partner's
    validity is a device-side mask, so the step makes no host sync. Returns
    (m', summary) with summary = [R(9), t(3), n_kf, n_lm] of the new
    keyframe after BA, as one (14,) tensor."""
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
    ids, fix = trk.select_local_window(m, new_id, n_window=n_window,
                                       n_fixed_ring=n_fixed_ring)
    m = trk.local_ba(m, ids, fix, fx, fy, cx, cy, n_iters=ba_iters)
    m = trk.cull_landmarks(m)
    summary = torch.cat([
        ms.row(m.kf_R, new_id).reshape(-1), ms.row(m.kf_t, new_id),
        torch.stack([m.n_kf.to(torch.float32), m.n_lm.to(torch.float32)]),
    ])
    return m, summary


class Sensor(enum.IntEnum):
    """Sensor modes (the reference's enum). MONOCULAR, STEREO and RGBD are
    ported; the IMU_* modes wait on ROADMAP §1 item 7."""

    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4
    IMU_RGBD = 5


class TrackingState(enum.IntEnum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to torch yet (ROADMAP.md §1 item {item})")


class System:
    """SLAM engine with the reference System's API: the synchronous
    monocular, stereo and RGB-D subset of the JAX `System`."""

    MIN_INIT_MATCHES = 90
    MIN_TRACK_INLIERS = MIN_TRACK_INLIERS
    KF_MIN_GAP = 3  # frames
    LOCAL_WINDOW = 8  # covisible keyframes optimized by local BA
    LOCAL_FIXED_RING = 4  # second-ring observers held fixed in local BA
    MATCH_CAP_VISIBLE = MATCH_CAP_VISIBLE
    VI_INIT_KFS = 8  # kept for the keyframe-culling protection window
    VI_LOCAL_WINDOW = 6
    VI_FIXED_RING = 4

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
        if self.sensor not in (Sensor.MONOCULAR, Sensor.STEREO, Sensor.RGBD):
            _not_ported(f"sensor {self.sensor.name}", "7")
        if pipelined:
            _not_ported("the pipelined mode", "10")
        if vocab_path:
            _not_ported("a vocabulary (vocab_path)", "8")
        if mesh is not None:
            _not_ported("a device mesh", "9")
        self.settings = settings_mod.load_settings(settings_path)
        if self.settings.loop_closing:
            _not_ported("loop closing (settings loopClosing: 1)", "8")
        if load_atlas or self.settings.load_atlas_from_file:
            _not_ported("loading a saved atlas", "8")
        self.use_viewer = use_viewer
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"System(device={device!r}): no CUDA device is available; "
                "pass device=\"cpu\" to run on the CPU")
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
        self.reset()

    # ------------------------------------------------------------------ state

    def reset(self):
        self.map = ms.empty_map(self.map_cfg, self.device)
        self.state = TrackingState.NOT_INITIALIZED
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

    # --------------------------------------------------------------- helpers

    @staticmethod
    def _pose44(R, t) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray(R)
        T[:3, 3] = np.asarray(t)
        return T

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _preprocess(self, im: np.ndarray) -> torch.Tensor:
        if im.ndim == 3:
            im = im.mean(axis=-1)
        H, W = self.cam.height, self.cam.width
        if im.shape != (H, W):
            import cv2

            im = cv2.resize(np.asarray(im, np.float32), (W, H),
                            interpolation=cv2.INTER_AREA)
        return self._tensor(im)

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
        Monocular mode reads no IMU samples."""
        del imu_measurements
        t0 = _time.perf_counter()
        feats = self._extract_undistorted(self._preprocess(im))
        if self.state == TrackingState.NOT_INITIALIZED:
            self._try_initialize(feats, timestamp)
        elif self.state == TrackingState.OK:
            self._track(feats, timestamp)
        else:
            self._relocalize(feats, timestamp)
        return self._end_frame(feats, timestamp, t0)

    def track_stereo(self, im_left: np.ndarray, im_right: np.ndarray,
                     timestamp: float,
                     imu_measurements: Sequence = ()) -> np.ndarray:
        """Stereo per-frame entry point; returns the 4x4 T_cw. Landmarks
        are spawned at metric depth from rectified scanline matches or
        general two-view triangulation, so no two-view initialization is
        needed."""
        del imu_measurements
        t0 = _time.perf_counter()
        img_l = self._preprocess(im_left)
        img_r = self._preprocess(im_right)
        feats = self._extract_undistorted(img_l)
        feats_r = (self._extract(img_r) if self._stereo_right_raw
                   else self._extract_undistorted(img_r))
        self._step_metric(feats, self._stereo_obs(feats, feats_r), timestamp)
        return self._end_frame(feats, timestamp, t0)

    def track_rgbd(self, im: np.ndarray, depthmap: np.ndarray,
                   timestamp: float,
                   imu_measurements: Sequence = ()) -> np.ndarray:
        """RGB-D per-frame entry point; returns the 4x4 T_cw. Depth is
        sampled at each raw keypoint and backprojected through the
        undistorted pixel; the rest is the stereo path's."""
        del imu_measurements
        t0 = _time.perf_counter()
        f_raw = self._extract(self._preprocess(im))
        feats = dataclasses.replace(f_raw, uv=undistort(self.cam, f_raw.uv))
        cam = self.cam
        sm = stereo_mod.obs_from_depth(
            f_raw.uv, feats.uv, feats.mask, self._tensor(depthmap), cam.fx,
            cam.fy, cam.cx, cam.cy,
            max_depth=float(self.settings.th_far_points or 40.0))
        self._step_metric(feats, sm, timestamp)
        return self._end_frame(feats, timestamp, t0)

    def _step_metric(self, feats, sm, timestamp: float):
        if self.state == TrackingState.NOT_INITIALIZED:
            self._initialize_stereo(feats, sm, timestamp)
        elif self.state == TrackingState.OK:
            self._track(feats, timestamp, stereo=sm)
        else:
            self._relocalize(feats, timestamp)

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

    def get_map_pcl(self) -> np.ndarray:
        """Map-point snapshot (`GetMapPCL`)."""
        X = self.map.lm_X.cpu().numpy()
        return X[self.map.lm_valid.cpu().numpy()]

    def get_tracking_state(self) -> TrackingState:
        return self.state

    def get_trajectory(self):
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
        n_kf = int(self.map.n_kf)
        kR = self.map.kf_R[:n_kf].cpu().numpy()
        kt = self.map.kf_t[:n_kf].cpu().numpy()
        return [(self.kf_times[k] if k < len(self.kf_times) else 0.0,
                 self._pose44(kR[k], kt[k])) for k in range(n_kf)]

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

    # ------------------------------------------------------------- tracking

    def _predict_pose(self) -> np.ndarray:
        if self.velocity is not None:
            return self.velocity @ self.Tcw
        return self.Tcw

    def _track(self, feats, timestamp: float, stereo=None):
        T_pred = self._predict_pose()
        cam = self.cam
        # one device program and one fetch of the (16,) summary
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
        T_new = self._pose44(s[:9].reshape(3, 3), s[9:12])
        if self.last_Tcw is not None:
            self.velocity = T_new @ np.linalg.inv(self.last_Tcw)
        self.last_Tcw = T_new
        self.Tcw = T_new
        self.frames_since_kf += 1
        if self._need_keyframe(n_inl, n_kf_now):
            self._insert_keyframe_fused(feats, obs_clean, timestamp, n_inl,
                                        stereo)

    def _relocalize(self, feats, timestamp: float):
        _not_ported("relocalization after tracking is lost (loop/vocab.py "
                    "and the keyframe BoW database)", "8")

    def _need_keyframe(self, n_inl: int, n_kf: int = -1) -> bool:
        """The keyframe cadence of every ported sensor (the JAX System gives
        only IMU_MONOCULAR a denser one): a keyframe every max(fps // 2, 5)
        frames, or earlier (after KF_MIN_GAP frames) when the inliers drop
        under 75% of the last keyframe's or under 60."""
        if n_kf < 0:
            n_kf = int(self.map.n_kf)
        if n_kf >= self.map_cfg.max_kf - 1:
            return False
        sparse_gap = max(int(self.cam.fps) // 2, 5)
        if self.frames_since_kf >= sparse_gap:
            return True
        if self.frames_since_kf < self.KF_MIN_GAP:
            return False
        return n_inl < 0.75 * self.last_kf_inliers or n_inl < 60

    def _insert_keyframe_fused(self, feats, obs_clean, timestamp: float,
                               n_inl: int, stereo=None):
        """One `mapping_step` (with the stereo stage when `stereo`, a
        StereoObs, is given) and one fetch of its summary, then the host
        bookkeeping (compaction triggers). The JAX version also inserts the
        keyframe's BoW row here, which goes with relocalization (ROADMAP §1
        item 8)."""
        cam = self.cam
        m, summary = mapping_step(
            self.map, self._tensor(self.Tcw[:3, :3]),
            self._tensor(self.Tcw[:3, 3]), timestamp, feats.uv, feats.level,
            feats.bits, feats.mask, obs_clean.to(torch.int32), cam.fx,
            cam.fy, cam.cx, cam.cy, cam.width, cam.height,
            n_window=self.LOCAL_WINDOW, n_fixed_ring=self.LOCAL_FIXED_RING,
            stereo=None if stereo is None else (stereo.X_cam, stereo.valid))
        self.map = m
        s = summary.cpu().numpy()
        n_kf_after, n_lm = int(s[12]), int(s[13])
        self.kf_times.append(timestamp)
        self.frames_since_kf = 0
        self.last_kf_inliers = max(n_inl, 1)
        self._maybe_compact(n_kf=n_kf_after, n_lm=n_lm)
        # adopt the BA-refined keyframe pose: it seeds the next frame's
        # motion model, and refills the frame-reference cache with no fetch
        self.Tcw = self._pose44(s[:9].reshape(3, 3), s[9:12])
        self._frame_ref_cache = (timestamp, self.Tcw.copy(),
                                 float(self.scale_applied))
        self._last_kf_center = -self.Tcw[:3, :3].T @ self.Tcw[:3, 3]

    # ------------------------------------------------------- map maintenance

    def _maybe_compact(self, n_kf: int = -1, n_lm: int = -1):
        """Reclaim culled-landmark slots and cull redundant keyframes when a
        capacity nears exhaustion. Returns the keyframe remap (old id -> new
        id, -1 dropped) if keyframes moved, else None."""
        if n_lm < 0:
            n_lm = int(self.map.n_lm)
        if n_lm > self.LM_COMPACT_FRAC * self.map_cfg.max_lm:
            self.map, _ = ms.compact_landmarks(self.map)
        if n_kf < 0:
            n_kf = int(self.map.n_kf)
        if n_kf >= self.map_cfg.max_kf - self.KF_CULL_HEADROOM:
            remap = self._cull_keyframes()
            if remap is not None:
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
        """Rewrite the host bookkeeping after a keyframe compaction: of the
        JAX version's, the keyframe times (BoW rows, velocities, loop ids,
        preintegrations and listeners belong to parts not ported)."""
        kept = [k for k in range(old_n_kf) if remap[k] >= 0]
        self.kf_times = [self.kf_times[k] for k in kept
                         if k < len(self.kf_times)]
