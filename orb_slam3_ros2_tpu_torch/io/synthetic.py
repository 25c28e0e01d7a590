"""Rendered synthetic sequences for the port's smoke run and tests.

numpy-only pieces copied verbatim from `orb_slam3_ros2_tpu/io/synthetic.py`
(`_so3_exp_np`, `Trajectory`, `default_trajectory`: lines 30-72;
`_texture`, `render_sequence`: lines 154-251; the textured room and
`render_room_sequence_kb8`: lines 259-322, 355-363, 435-545;
`_render_planes`, `render_room_sequence`: lines 325-352, 366-432;
`Scene`, `make_scene`: lines 75-146;
`umeyama_scale`, `ate_rmse`: lines 606-645; `GRAVITY`, `make_imu`: lines
27, 548-603), and the leave-and-return
trajectory of the loop-closing clip (`_WaypointTrajectory`,
`_loop_trajectory`, from `orb_slam3_ros2_tpu/runtime/bench_eval.py:130-197`),
so that a machine without JAX can render the same frames from the same seed
and score a trajectory. The renderers need cv2.
`render_sequence`'s optional `cx`/`cy` (default: the image centre, as in the
source) is the port's only addition, so a camera with an off-centre
principal point such as EuRoC cam0 or KITTI can be rendered.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

GRAVITY = np.array([0.0, 0.0, -9.81])


def _so3_exp_np(phi: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(phi, axis=-1, keepdims=True)
    theta = np.maximum(theta, 1e-12)
    axis = phi / theta
    K = np.zeros(phi.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -axis[..., 2], axis[..., 1]
    K[..., 1, 0], K[..., 1, 2] = axis[..., 2], -axis[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -axis[..., 1], axis[..., 0]
    th = theta[..., None]
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


@dataclasses.dataclass
class Trajectory:
    """Smooth analytic camera/body trajectory. T_wb(t): body-to-world."""

    amp_t: np.ndarray  # (3,) translation amplitudes
    freq_t: np.ndarray  # (3,)
    amp_r: np.ndarray  # (3,) rotation-vector amplitudes
    freq_r: np.ndarray  # (3,)
    lookat_depth: float = 6.0

    def position(self, t: np.ndarray) -> np.ndarray:
        t = np.asarray(t)[..., None]
        return self.amp_t * np.sin(2 * np.pi * self.freq_t * t)

    def rotation(self, t: np.ndarray) -> np.ndarray:
        t = np.asarray(t)[..., None]
        phi = self.amp_r * np.sin(2 * np.pi * self.freq_r * t + 0.7)
        return _so3_exp_np(phi)

    def pose_wb(self, t):
        return self.rotation(t), self.position(t)


def default_trajectory(seed: int = 0, scale: float = 1.0) -> Trajectory:
    rng = np.random.default_rng(seed)
    return Trajectory(
        amp_t=rng.uniform(0.3, 0.9, 3) * scale,
        freq_t=rng.uniform(0.05, 0.15, 3),
        amp_r=rng.uniform(0.05, 0.15, 3),
        freq_r=rng.uniform(0.05, 0.2, 3),
    )


@dataclasses.dataclass
class Scene:
    X: np.ndarray  # (L, 3) world landmarks
    R_cw: np.ndarray  # (K, 3, 3) camera-from-world rotations (groundtruth)
    t_cw: np.ndarray  # (K, 3)
    uv: np.ndarray  # (K, L, 2) pixel observations (noisy)
    vis: np.ndarray  # (K, L) bool visibility
    timestamps: np.ndarray  # (K,)
    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 752
    height: int = 480


def make_scene(
    n_frames: int = 12,
    n_points: int = 300,
    noise_px: float = 0.5,
    outlier_frac: float = 0.0,
    seed: int = 0,
    fps: float = 20.0,
    fx: float = 458.0,
    fy: float = 457.0,
    cx: float = 367.0,
    cy: float = 248.0,
    width: int = 752,
    height: int = 480,
) -> Scene:
    """Random landmarks in a box in front of the trajectory; full projections."""
    rng = np.random.default_rng(seed)
    traj = default_trajectory(seed=seed + 1)
    ts = np.arange(n_frames) / fps

    X = np.stack(
        [
            rng.uniform(-4.0, 4.0, n_points),
            rng.uniform(-3.0, 3.0, n_points),
            rng.uniform(4.0, 10.0, n_points),
        ],
        axis=-1,
    )

    R_wb, p_wb = traj.pose_wb(ts)  # body == camera here
    R_cw = np.swapaxes(R_wb, -1, -2)
    t_cw = -np.einsum("kij,kj->ki", R_cw, p_wb)

    x_c = np.einsum("kij,lj->kli", R_cw, X) + t_cw[:, None]
    z = x_c[..., 2]
    uv = np.stack(
        [fx * x_c[..., 0] / z + cx, fy * x_c[..., 1] / z + cy], axis=-1
    )
    vis = (
        (z > 0.2)
        & (uv[..., 0] >= 0)
        & (uv[..., 0] < width)
        & (uv[..., 1] >= 0)
        & (uv[..., 1] < height)
    )
    uv = uv + rng.normal(0, noise_px, uv.shape)
    if outlier_frac > 0:
        out = rng.random(vis.shape) < outlier_frac
        uv = np.where(
            out[..., None],
            rng.uniform(0, [width, height], uv.shape),
            uv,
        )
    return Scene(
        X=X, R_cw=R_cw, t_cw=t_cw, uv=uv.astype(np.float32), vis=vis,
        timestamps=ts, fx=fx, fy=fy, cx=cx, cy=cy, width=width, height=height,
    )


def _texture(h: int, w: int, seed: int, n_boxes: int = 300) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 30.0, np.float32)
    for _ in range(n_boxes):
        y, x = rng.integers(0, h - 20), rng.integers(0, w - 20)
        bh, bw = rng.integers(6, 24, size=2)
        img[y : y + bh, x : x + bw] = rng.uniform(40, 255)
    return np.clip(img, 0, 255)


def render_sequence(
    n_frames: int = 30,
    width: int = 640,
    height: int = 480,
    fx: float = 450.0,
    fy: float = 450.0,
    fps: float = 20.0,
    seed: int = 0,
    plane_depths=(6.0, 9.0),
    traj_scale: float = 1.0,
    stereo_baseline: float = 0.0,
    return_depth: bool = False,
    cx: float | None = None,
    cy: float | None = None,
):
    """Render a camera flying in front of fronto-parallel textured planes.

    Returns (images (K, H, W) float32, R_cw (K,3,3), t_cw (K,3), timestamps).
    Plane i occupies world z = plane_depths[i], x∈[-6,6], y∈[-4.5,4.5]; the
    nearer planes are composited over the farther by painting far-to-near.
    With return_depth (mono only): (images, depths, R_cw, t_cw, ts) where
    depths is the metric z-in-camera of the visible surface per pixel (an
    ideal registered RGBD depth channel; 0 where no plane is visible).
    """
    import cv2

    cx = width / 2.0 if cx is None else float(cx)
    cy = height / 2.0 if cy is None else float(cy)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    traj = default_trajectory(seed=seed + 3, scale=traj_scale)
    ts = np.arange(n_frames) / fps
    R_wb, p_wb = traj.pose_wb(ts)
    R_cw = np.swapaxes(R_wb, -1, -2)
    t_cw = -np.einsum("kij,kj->ki", R_cw, p_wb)

    tex_h, tex_w = 720, 960
    half_x, half_y = 6.0, 4.5
    planes = []
    for i, depth in enumerate(plane_depths):
        planes.append((_texture(tex_h, tex_w, seed + 10 + i), depth))

    uu, vv = np.meshgrid(np.arange(width), np.arange(height))
    rx = (uu - cx) / fx
    ry = (vv - cy) / fy

    def render(Rk, tk):
        frame = np.zeros((height, width), np.float32)
        zmap = np.zeros((height, width), np.float32)
        R_wc = Rk.T
        c_w = -Rk.T @ tk
        for tex, depth in sorted(planes, key=lambda p: -p[1]):  # far first
            sx = 2 * half_x / tex_w
            sy = 2 * half_y / tex_h
            # world point of texture pixel (u, v): (u*sx - half_x, v*sy - half_y, depth)
            A = np.array([[sx, 0, -half_x], [0, sy, -half_y], [0, 0, depth]])
            P = np.concatenate([Rk, tk[:, None]], axis=1)  # (3,4)
            M = K @ (P[:, :3] @ A + np.outer(P[:, 3], [0, 0, 1]))
            warped = cv2.warpPerspective(
                tex, M.astype(np.float64), (width, height),
                flags=cv2.INTER_LINEAR, borderValue=-1.0,
            )
            vis = warped >= 0
            frame = np.where(vis, warped, frame)
            if return_depth:
                # ray (rx, ry, 1) meets world plane z=depth at
                # z_cam = (depth - c_w_z) / (R_wc[2] · ray)
                den = R_wc[2, 0] * rx + R_wc[2, 1] * ry + R_wc[2, 2]
                z = (depth - c_w[2]) / np.where(np.abs(den) < 1e-9, 1e-9,
                                                den)
                zmap = np.where(vis, z.astype(np.float32), zmap)
        return frame, zmap

    images = np.zeros((n_frames, height, width), np.float32)
    depths = np.zeros((n_frames, height, width), np.float32)
    for k in range(n_frames):
        images[k], depths[k] = render(R_cw[k], t_cw[k])
    if return_depth:
        assert stereo_baseline == 0.0, "return_depth is mono-only"
        return (images, depths, R_cw.astype(np.float32),
                t_cw.astype(np.float32), ts)

    if stereo_baseline > 0.0:
        # right camera: displaced +baseline along the left camera's x-axis;
        # point coords in the right frame are x_r = x_l - (b, 0, 0)
        images_r = np.zeros_like(images)
        off = np.array([stereo_baseline, 0.0, 0.0])
        for k in range(n_frames):
            images_r[k], _ = render(R_cw[k], t_cw[k] - off)
        return (images, images_r, R_cw.astype(np.float32),
                t_cw.astype(np.float32), ts)
    return images, R_cw.astype(np.float32), t_cw.astype(np.float32), ts


# Textured room with general planes and photometrics, and the KB8 fisheye
# renderer on top of it: copied from orb_slam3_ros2_tpu/io/synthetic.py
# (lines 259-322, 355-363, 435-545); the rays come from the port's
# `cameras.unproject` on a CPU tensor.


def _value_noise_texture(h: int, w: int, seed: int) -> np.ndarray:
    """Multi-octave value-noise texture in [0, 255].

    Natural-image-like autocorrelation (power at all scales) so ORB
    descriptor repeatability is stressed the way real scenes stress it —
    the box texture of `_texture` is axis-aligned high contrast everywhere,
    which flatters FAST/BRIEF."""
    import cv2

    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    amp, cells = 1.0, 4
    total = 0.0
    while cells < max(h, w):
        grid = rng.uniform(0, 1, (cells + 1, cells + 1)).astype(np.float32)
        img += amp * cv2.resize(grid, (w, h), interpolation=cv2.INTER_CUBIC)
        total += amp
        amp *= 0.55
        cells *= 2
    img = (img - img.min()) / max(img.max() - img.min(), 1e-6)
    # sprinkle a few high-contrast patches (posters/furniture edges)
    for _ in range(40):
        y, x = rng.integers(0, h - 30), rng.integers(0, w - 30)
        bh, bw = rng.integers(8, 30, size=2)
        img[y:y + bh, x:x + bw] = rng.uniform(0, 1)
    return (20.0 + 220.0 * img).astype(np.float32)


@dataclasses.dataclass
class _Plane:
    origin: np.ndarray  # (3,) world point at texture (0, 0)
    ax_u: np.ndarray    # (3,) world step per texture pixel along u
    ax_v: np.ndarray    # (3,) world step per texture pixel along v
    tex: np.ndarray     # (th, tw) float32


def _room_planes(seed: int, half_x=3.0, half_y=2.2, z_near=-2.0, z_far=6.0,
                 tex_hw=(720, 960)):
    """Five textured planes forming an open box the camera flies inside:
    back wall, left/right walls, floor, ceiling (y down = floor at +y)."""
    th, tw = tex_hw
    depth_span = z_far - z_near

    def mk(origin, du, dv, extent_u, extent_v, s):
        return _Plane(
            origin=np.asarray(origin, np.float64),
            ax_u=np.asarray(du, np.float64) * (extent_u / tw),
            ax_v=np.asarray(dv, np.float64) * (extent_v / th),
            tex=_value_noise_texture(th, tw, seed + s),
        )

    return [
        mk([-half_x, -half_y, z_far], [1, 0, 0], [0, 1, 0],
           2 * half_x, 2 * half_y, 0),                      # back wall
        mk([-half_x, -half_y, z_near], [0, 0, 1], [0, 1, 0],
           depth_span, 2 * half_y, 1),                      # left wall
        mk([half_x, -half_y, z_near], [0, 0, 1], [0, 1, 0],
           depth_span, 2 * half_y, 2),                      # right wall
        mk([-half_x, half_y, z_near], [1, 0, 0], [0, 0, 1],
           2 * half_x, depth_span, 3),                      # floor (+y down)
        mk([-half_x, -half_y, z_near], [1, 0, 0], [0, 0, 1],
           2 * half_x, depth_span, 4),                      # ceiling
    ]



def _photometric(frame, vignette, gain, noise_dn, rng):
    """Realistic image formation on top of the ideal render: vignetting,
    exposure gain, sensor noise, 8-bit quantization, slight defocus."""
    import cv2

    img = frame * vignette * gain
    img = cv2.GaussianBlur(img, (0, 0), 0.6)
    img = img + rng.normal(0.0, noise_dn, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.float32)


def _render_planes_rays(planes, dirs_cam, R_cw, t_cw):
    """Z-buffered render for a GENERAL camera: per-pixel rays instead of the
    pinhole homography warp. dirs_cam (H, W, 3) are unit-z camera-frame ray
    directions (models.cameras.unproject); sampling is ray-plane
    intersection + cv2.remap per plane. Shared by the KB8 fisheye path —
    the image-formation side of `Camera.type: "KannalaBrandt8"`
    (the reference's `config/Stereo/TUM-VI.yaml:8,17-32`)."""
    import cv2

    H, W = dirs_cam.shape[:2]
    R_wc = R_cw.T
    c_w = -R_cw.T @ t_cw
    dirs_w = dirs_cam @ R_wc.T  # (H, W, 3) world ray directions
    frame = np.zeros((H, W), np.float32)
    zbuf = np.full((H, W), np.inf, np.float32)
    for pl in planes:
        n = np.cross(pl.ax_u, pl.ax_v)
        n /= max(np.linalg.norm(n), 1e-12)
        den = dirs_w @ n
        s = float(np.dot(n, pl.origin - c_w)) / np.where(
            np.abs(den) < 1e-9, 1e-9, den)
        p = c_w + s[..., None] * dirs_w
        rel = p - pl.origin
        # dual basis of (ax_u, ax_v) within the plane
        Gm = np.array([
            [pl.ax_u @ pl.ax_u, pl.ax_u @ pl.ax_v],
            [pl.ax_v @ pl.ax_u, pl.ax_v @ pl.ax_v],
        ])
        Gi = np.linalg.inv(Gm)
        bu = Gi[0, 0] * pl.ax_u + Gi[0, 1] * pl.ax_v
        bv = Gi[1, 0] * pl.ax_u + Gi[1, 1] * pl.ax_v
        ut = (rel @ bu).astype(np.float32)
        vt = (rel @ bv).astype(np.float32)
        warped = cv2.remap(pl.tex, ut, vt, cv2.INTER_LINEAR,
                           borderValue=-1.0)
        vis = (warped >= 0) & (s > 0.1) & (s < zbuf)
        frame = np.where(vis, warped, frame)
        zbuf = np.where(vis, s.astype(np.float32), zbuf)
    zbuf = np.where(np.isinf(zbuf), 0.0, zbuf)
    return frame, zbuf


def render_room_sequence_kb8(
    n_frames: int,
    cam,
    fps: float = 20.0,
    seed: int = 0,
    traj: Optional[Trajectory] = None,
    traj_scale: float = 1.5,
    photometric: bool = True,
    noise_dn: float = 3.0,
    exposure_drift: float = 0.02,
    stereo_baseline: float = 0.0,
    cam2=None,
):
    """KB8-fisheye render of the textured room (the JAX package's
    `render_room_sequence` with per-pixel rays; any camera model renders,
    since the rays come from its own unprojection). `cam` / `cam2` are
    models.cameras.Camera instances (KANNALA_BRANDT8); rays come from the
    camera model's own unprojection, so the rendered distortion is exactly
    the model the engine undistorts with."""
    import torch

    from orb_slam3_ros2_tpu_torch.models import cameras as cam_mod

    width, height = cam.width, cam.height
    rng = np.random.default_rng(seed + 77)
    traj = traj or default_trajectory(seed=seed + 3, scale=traj_scale)
    ts = np.arange(n_frames) / fps
    R_wb, p_wb = traj.pose_wb(ts)
    R_cw = np.swapaxes(R_wb, -1, -2)
    t_cw = -np.einsum("kij,kj->ki", R_cw, p_wb)

    planes = _room_planes(seed)

    def rays_for(c):
        uu, vv = np.meshgrid(np.arange(c.width, dtype=np.float64),
                             np.arange(c.height, dtype=np.float64))
        uv = np.stack([uu, vv], axis=-1).reshape(-1, 2)
        d = cam_mod.unproject(c, torch.as_tensor(uv, dtype=torch.float32))
        d = np.asarray(d.numpy(), np.float64)
        return d.reshape(c.height, c.width, 3)

    dirs = rays_for(cam)
    r2 = dirs[..., 0] ** 2 + dirs[..., 1] ** 2
    vignette = 1.0 / (1.0 + r2) ** 1.5
    gains = np.exp(np.cumsum(rng.normal(0, exposure_drift, n_frames)))
    gains = np.clip(gains, 0.7, 1.4)

    images = np.zeros((n_frames, height, width), np.float32)
    for k in range(n_frames):
        frame, _ = _render_planes_rays(planes, dirs, R_cw[k], t_cw[k])
        images[k] = (_photometric(frame, vignette, gains[k], noise_dn, rng)
                     if photometric else frame)

    if stereo_baseline > 0.0:
        c2 = cam2 or cam
        dirs2 = rays_for(c2) if cam2 is not None else dirs
        r2b = dirs2[..., 0] ** 2 + dirs2[..., 1] ** 2
        vig2 = 1.0 / (1.0 + r2b) ** 1.5
        off = np.array([stereo_baseline, 0.0, 0.0])
        images_r = np.zeros((n_frames, c2.height, c2.width), np.float32)
        for k in range(n_frames):
            fr, _ = _render_planes_rays(planes, dirs2, R_cw[k],
                                        t_cw[k] - off)
            images_r[k] = (_photometric(fr, vig2, gains[k], noise_dn, rng)
                           if photometric else fr)
        return (images, images_r, R_cw.astype(np.float32),
                t_cw.astype(np.float32), ts)
    return images, R_cw.astype(np.float32), t_cw.astype(np.float32), ts


def _render_planes(planes, K, Rk, tk, width, height, rx, ry):
    """Z-buffered render of general textured planes (homography warp per
    plane + analytic ray-plane depth)."""
    import cv2

    frame = np.zeros((height, width), np.float32)
    zbuf = np.full((height, width), np.inf, np.float32)
    R_wc = Rk.T
    c_w = -Rk.T @ tk
    for pl in planes:
        A = np.stack([pl.ax_u, pl.ax_v, pl.origin], axis=1)
        M = K @ (Rk @ A + np.outer(tk, [0.0, 0.0, 1.0]))
        warped = cv2.warpPerspective(
            pl.tex, M, (width, height), flags=cv2.INTER_LINEAR,
            borderValue=-1.0)
        n = np.cross(pl.ax_u, pl.ax_v)
        n /= max(np.linalg.norm(n), 1e-12)
        den = (n[0] * (R_wc[0, 0] * rx + R_wc[0, 1] * ry + R_wc[0, 2])
               + n[1] * (R_wc[1, 0] * rx + R_wc[1, 1] * ry + R_wc[1, 2])
               + n[2] * (R_wc[2, 0] * rx + R_wc[2, 1] * ry + R_wc[2, 2]))
        s = np.dot(n, pl.origin - c_w) / np.where(
            np.abs(den) < 1e-9, 1e-9, den)
        vis = (warped >= 0) & (s > 0.1) & (s < zbuf)
        frame = np.where(vis, warped, frame)
        zbuf = np.where(vis, s.astype(np.float32), zbuf)
    zbuf = np.where(np.isinf(zbuf), 0.0, zbuf)
    return frame, zbuf


def render_room_sequence(
    n_frames: int = 60,
    width: int = 640,
    height: int = 480,
    fx: float = 450.0,
    fy: float = 450.0,
    fps: float = 20.0,
    seed: int = 0,
    traj=None,
    traj_scale: float = 1.5,
    photometric: bool = True,
    noise_dn: float = 3.0,
    exposure_drift: float = 0.02,
    stereo_baseline: float = 0.0,
    return_depth: bool = False,
):
    """A pinhole camera flying inside the textured room: oblique surfaces,
    depth discontinuities at wall seams, vignetting, exposure drift, sensor
    noise and quantization. Returns the tuples of `render_sequence`."""
    cx, cy = width / 2.0, height / 2.0
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    rng = np.random.default_rng(seed + 77)
    traj = traj or default_trajectory(seed=seed + 3, scale=traj_scale)
    ts = np.arange(n_frames) / fps
    R_wb, p_wb = traj.pose_wb(ts)
    R_cw = np.swapaxes(R_wb, -1, -2)
    t_cw = -np.einsum("kij,kj->ki", R_cw, p_wb)

    planes = _room_planes(seed)
    uu, vv = np.meshgrid(np.arange(width), np.arange(height))
    rx = (uu - cx) / fx
    ry = (vv - cy) / fy
    vignette = 1.0 / (1.0 + rx * rx + ry * ry) ** 1.5
    gains = np.exp(np.cumsum(rng.normal(0, exposure_drift, n_frames)))
    gains = np.clip(gains, 0.7, 1.4)

    images = np.zeros((n_frames, height, width), np.float32)
    depths = np.zeros((n_frames, height, width), np.float32)
    for k in range(n_frames):
        frame, zbuf = _render_planes(planes, K, R_cw[k], t_cw[k], width,
                                     height, rx, ry)
        depths[k] = zbuf
        images[k] = (_photometric(frame, vignette, gains[k], noise_dn, rng)
                     if photometric else frame)
    if return_depth:
        assert stereo_baseline == 0.0, "return_depth is mono-only"
        return (images, depths, R_cw.astype(np.float32),
                t_cw.astype(np.float32), ts)
    if stereo_baseline > 0.0:
        images_r = np.zeros_like(images)
        off = np.array([stereo_baseline, 0.0, 0.0])
        for k in range(n_frames):
            fr, _ = _render_planes(planes, K, R_cw[k], t_cw[k] - off, width,
                                   height, rx, ry)
            images_r[k] = (_photometric(fr, vignette, gains[k], noise_dn,
                                        rng) if photometric else fr)
        return (images, images_r, R_cw.astype(np.float32),
                t_cw.astype(np.float32), ts)
    return images, R_cw.astype(np.float32), t_cw.astype(np.float32), ts


class _WaypointTrajectory:
    """Leave-and-return trajectory: smooth (C1 smoothstep) interpolation
    through (time, position, yaw) waypoints; the middle leg turns away
    from the start region, so the revisit shares no covisibility with the
    early map."""

    def __init__(self, waypoints):
        self.t_k = np.asarray([w[0] for w in waypoints], float)
        self.p_k = np.asarray([w[1] for w in waypoints], float)
        self.yaw_k = np.asarray([w[2] for w in waypoints], float)

    @staticmethod
    def _smooth(u):
        return u * u * (3.0 - 2.0 * u)

    def _interp(self, vals, t):
        t = np.atleast_1d(np.asarray(t, float))
        idx = np.clip(np.searchsorted(self.t_k, t, side="right") - 1,
                      0, len(self.t_k) - 2)
        t0 = self.t_k[idx]
        t1 = self.t_k[idx + 1]
        u = self._smooth(np.clip((t - t0) / np.maximum(t1 - t0, 1e-9),
                                 0.0, 1.0))
        out = (1 - u)[..., None] * vals[idx] + u[..., None] * vals[idx + 1]
        return out if vals.ndim > 1 else out[..., 0]

    def position(self, t):
        p = self._interp(self.p_k, t)
        return p[0] if np.isscalar(t) else p

    def pose_wb(self, t):
        t = np.atleast_1d(np.asarray(t, float))
        p = self._interp(self.p_k, t)
        yaw = self._interp(self.yaw_k[:, None], t)[..., 0]
        cz, sz = np.cos(yaw), np.sin(yaw)
        R = np.zeros(t.shape + (3, 3))
        R[..., 0, 0] = cz
        R[..., 0, 2] = sz
        R[..., 1, 1] = 1.0
        R[..., 2, 0] = -sz
        R[..., 2, 2] = cz
        return R, p


def _loop_trajectory(n_frames: int, fps: float) -> _WaypointTrajectory:
    """Start viewing the back wall near the origin, wander right and turn
    180 deg to map the opposite end of the room, then return to the start
    pose (yaw rate under ~25 deg/s)."""
    T = n_frames / fps
    pi = np.pi
    return _WaypointTrajectory([
        (0.00 * T, (-0.5, 0.0, 0.0), 0.0),
        (0.08 * T, (0.4, 0.12, 0.3), -0.3),
        (0.16 * T, (0.9, -0.08, 0.3), -0.9),
        (0.26 * T, (1.1, 0.08, 0.0), -1.7),
        (0.36 * T, (0.8, -0.1, -0.4), -2.5),
        (0.46 * T, (0.0, 0.1, -0.6), -pi - 0.4),
        (0.56 * T, (-0.8, -0.08, -0.4), -pi - 1.0),
        (0.66 * T, (-1.1, 0.08, 0.0), -2 * pi + 1.3),
        (0.76 * T, (-0.9, -0.06, 0.2), -2 * pi + 0.7),
        (0.88 * T, (-0.5, 0.0, 0.0), -2 * pi),
        (1.00 * T, (0.4, 0.1, 0.3), -2 * pi - 0.25),
    ])


def make_imu(
    traj,
    t0: float,
    t1: float,
    rate: float = 200.0,
    gyro_noise: float = 0.0,
    acc_noise: float = 0.0,
    gyro_bias: Optional[np.ndarray] = None,
    acc_bias: Optional[np.ndarray] = None,
    gyro_walk: float = 0.0,
    acc_walk: float = 0.0,
    seed: int = 0,
):
    """Sample gyro/accel along the trajectory (central finite differences).

    Returns (t (M,), gyro (M, 3), acc (M, 3)) in body frame; accelerometer
    measures specific force f_b = R_bw (a_w - g_w), g_w = (0,0,-9.81).
    `traj` is any object with `rotation(t)` and `position(t)` (world from
    body) over an array of times.

    `gyro_walk`/`acc_walk` are bias random-walk densities (rad/s/s/√Hz,
    m/s²/s/√Hz — the `IMU.GyroWalk`/`IMU.AccWalk` settings keys); the
    white-noise args are per-sample σ, i.e. density·√rate. EuRoC-grade
    realism at 200 Hz: gyro_noise=1.7e-4*√200≈2.4e-3, acc_noise=2e-3*√200≈
    2.8e-2, gyro_walk=1.9e-5, acc_walk=3e-3.
    """
    rng = np.random.default_rng(seed)
    dt = 1.0 / rate
    t = np.arange(t0, t1, dt)
    h = 1e-4

    Rm = traj.rotation(t - h)
    Rp = traj.rotation(t + h)
    R = traj.rotation(t)
    # gyro: log(R(t)^T R(t+h)) / h ≈ vee(R^T (Rp - Rm) / 2h)
    dR = np.einsum("kji,kjl->kil", R, (Rp - Rm) / (2 * h))
    gyro = np.stack([dR[:, 2, 1], dR[:, 0, 2], dR[:, 1, 0]], axis=-1)

    pm = traj.position(t - h)
    pp = traj.position(t + h)
    p = traj.position(t)
    a_w = (pp - 2 * p + pm) / (h * h)
    acc = np.einsum("kji,kj->ki", R, a_w - GRAVITY)

    if gyro_bias is not None:
        gyro = gyro + gyro_bias
    if acc_bias is not None:
        acc = acc + acc_bias
    if gyro_walk > 0:
        gyro = gyro + np.cumsum(
            rng.normal(0, gyro_walk * np.sqrt(dt), gyro.shape), axis=0)
    if acc_walk > 0:
        acc = acc + np.cumsum(
            rng.normal(0, acc_walk * np.sqrt(dt), acc.shape), axis=0)
    gyro = gyro + rng.normal(0, gyro_noise, gyro.shape)
    acc = acc + rng.normal(0, acc_noise, acc.shape)
    return t, gyro.astype(np.float64), acc.astype(np.float64)


def umeyama_scale(t_est: np.ndarray, t_gt: np.ndarray) -> float:
    """Sim3 Umeyama scale mapping est -> gt: the MOTION-WEIGHTED metric
    scale of a trajectory. Unlike the per-chunk length-ratio statistic it
    is dominated by the trajectory's actual spatial extent, so chunks with
    near-zero groundtruth motion cannot blow it up."""
    est = np.asarray(t_est, np.float64)
    gt = np.asarray(t_gt, np.float64)
    e = est - est.mean(0)
    g = gt - gt.mean(0)
    U, D, Vt = np.linalg.svd(g.T @ e / len(e))
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    var_e = (e * e).sum() / len(e)
    return float(np.trace(np.diag(D) @ S) / max(var_e, 1e-12))


def ate_rmse(t_est: np.ndarray, t_gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE after (optional) Sim3 Umeyama alignment.

    Standard EuRoC evaluation protocol."""
    est = np.asarray(t_est, np.float64)
    gt = np.asarray(t_gt, np.float64)
    if align:
        mu_e, mu_g = est.mean(0), gt.mean(0)
        e, g = est - mu_e, gt - mu_g
        U, D, Vt = np.linalg.svd(g.T @ e / len(e))
        S = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            S[2, 2] = -1
        R = U @ S @ Vt
        var_e = (e * e).sum() / len(e)
        s = np.trace(np.diag(D) @ S) / max(var_e, 1e-12)
        est = s * (R @ e.T).T + mu_g
        gt = g + mu_g
    err = est - gt
    return float(np.sqrt((err * err).sum(-1).mean()))
