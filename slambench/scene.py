"""The rendered world of the benchmark's traffic: the textured room, a
closed orbit through it, the distorted camera, the photometric model and
the IMU, in plain torch (the renderer) and numpy (the IMU).

Frozen copies, so that a later change to the program cannot move the
benchmark's inputs:

- `_value_noise_texture`, `room_planes`: `_value_noise_texture` and
  `_room_planes` of `orb_slam3_ros2_tpu_torch/io/synthetic.py`, with the
  texture's octaves and patches drawn by a `torch.Generator` on the device
  (bicubic upsampling as cv2's INTER_CUBIC).
- `render_rays`: `_render_planes_rays` of the same file (ray-plane
  intersection per pixel and bilinear sampling of each plane's texture,
  z-buffered), in torch over a batch of frames.
- `pinhole_rays`: the radtan camera's fixed-point undistortion,
  `_unproject_pinhole` of `orb_slam3_ros2_tpu_torch/models/cameras.py`, so
  that each raw pixel samples the room along its own ray, as
  `render_euroc_distorted` of `orb_slam3_ros2_tpu_torch/tools/system_run.py`
  renders EuRoC cam0 through its distortion.
- `photometric`: `_photometric` of `io/synthetic.py` (vignetting, exposure
  gain, a 0.6 px Gaussian defocus with cv2's 7 taps and reflect-101
  border, sensor noise, 8-bit quantization).
- `so3_exp_np`, `make_imu`, `GRAVITY`: `_so3_exp_np`, `make_imu` and
  `GRAVITY` of `io/synthetic.py`; `BodyTrajectory` of
  `tools/system_run.py`.

`Orbit` is the benchmark's own: a camera path whose position and rotation
vector are sums of harmonics of one lap, so its end joins its start in
pose and in every derivative.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

GRAVITY = np.array([0.0, 0.0, -9.81])


def so3_exp_np(phi: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(phi, axis=-1, keepdims=True)
    theta = np.maximum(theta, 1e-12)
    axis = phi / theta
    K = np.zeros(phi.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -axis[..., 2], axis[..., 1]
    K[..., 1, 0], K[..., 1, 2] = axis[..., 2], -axis[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -axis[..., 1], axis[..., 0]
    th = theta[..., None]
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


class Orbit:
    """A closed camera path (camera to world, camera looking along +z, y
    down). Over a lap of `lap_s` seconds the angle θ = 2π t / lap_s runs
    once round; the position is `centre` plus Σ_h sin_h sin(hθ) + cos_h
    cos(hθ) and the rotation vector Σ_h rot_sin_h sin(hθ) + rot_cos_h
    cos(hθ), for the harmonics h = 1, 2, ... of the lists."""

    def __init__(self, lap_s: float, centre, pos_sin, pos_cos, rot_sin,
                 rot_cos):
        self.lap_s = float(lap_s)
        self.centre = np.asarray(centre, np.float64)
        self.pos_sin = np.asarray(pos_sin, np.float64)
        self.pos_cos = np.asarray(pos_cos, np.float64)
        self.rot_sin = np.asarray(rot_sin, np.float64)
        self.rot_cos = np.asarray(rot_cos, np.float64)

    @classmethod
    def from_params(cls, p: dict) -> "Orbit":
        return cls(p["lap_s"], p["centre"], p["pos_sin"], p["pos_cos"],
                   p["rot_sin"], p["rot_cos"])

    def _series(self, t, s, c):
        t = np.asarray(t, np.float64)
        th = 2.0 * np.pi * t / self.lap_s
        h = np.arange(1, s.shape[0] + 1, dtype=np.float64)
        ang = th[..., None] * h  # (..., H)
        return np.sin(ang) @ s + np.cos(ang) @ c

    def position(self, t) -> np.ndarray:
        return self.centre + self._series(t, self.pos_sin, self.pos_cos)

    def rotation(self, t) -> np.ndarray:
        return so3_exp_np(self._series(t, self.rot_sin, self.rot_cos))

    def pose_cw(self, t):
        """(R_cw (..., 3, 3), t_cw (..., 3)) at times t."""
        R_wc = self.rotation(t)
        R_cw = np.swapaxes(R_wc, -1, -2)
        return R_cw, -np.einsum("...ij,...j->...i", R_cw, self.position(t))


class BodyTrajectory:
    """The IMU body's trajectory of a camera trajectory: T_wb = T_wc T_cb,
    with T_cb the inverse of `T_b_c` (the settings' `IMU.T_b_c1`)."""

    def __init__(self, cam_traj, T_b_c):
        self.cam_traj = cam_traj
        T = np.asarray(T_b_c, np.float64)
        self.R_cb = T[:3, :3].T
        self.t_cb = -T[:3, :3].T @ T[:3, 3]

    def rotation(self, t):
        return self.cam_traj.rotation(t) @ self.R_cb

    def position(self, t):
        return self.cam_traj.position(t) + self.cam_traj.rotation(t) @ \
            self.t_cb


def make_imu(traj, t, gyro_noise: float = 0.0, acc_noise: float = 0.0,
             gyro_bias=None, acc_bias=None, gyro_walk: float = 0.0,
             acc_walk: float = 0.0, rng=None):
    """Gyro and accelerometer at the sample times `t` (M,) along `traj`
    (central finite differences), in the body frame: the accelerometer
    measures f_b = R_bw (a_w - g_w). `make_imu` of `io/synthetic.py` with
    the sample times given (the rate is 1 / their step) and the noise drawn
    from `rng`. Returns (gyro (M, 3), acc (M, 3)) float64."""
    t = np.asarray(t, np.float64)
    dt = float(t[1] - t[0]) if t.shape[0] > 1 else 0.005
    h = 1e-4
    Rm = traj.rotation(t - h)
    Rp = traj.rotation(t + h)
    R = traj.rotation(t)
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
    if rng is not None:
        if gyro_walk > 0:
            gyro = gyro + np.cumsum(
                rng.normal(0, gyro_walk * np.sqrt(dt), gyro.shape), axis=0)
        if acc_walk > 0:
            acc = acc + np.cumsum(
                rng.normal(0, acc_walk * np.sqrt(dt), acc.shape), axis=0)
        gyro = gyro + rng.normal(0, gyro_noise, gyro.shape)
        acc = acc + rng.normal(0, acc_noise, acc.shape)
    return gyro.astype(np.float64), acc.astype(np.float64)


# ------------------------------------------------------------ the room


def _value_noise_texture(h: int, w: int, gen: torch.Generator,
                         device) -> torch.Tensor:
    """Multi-octave value noise in [20, 240] with 40 flat patches."""
    img = torch.zeros((h, w), dtype=torch.float32, device=device)
    amp, cells = 1.0, 4
    while cells < max(h, w):
        grid = torch.rand((1, 1, cells + 1, cells + 1), generator=gen,
                          device=device)
        img += amp * torch.nn.functional.interpolate(
            grid, size=(h, w), mode="bicubic", align_corners=False)[0, 0]
        amp *= 0.55
        cells *= 2
    img = (img - img.min()) / (img.max() - img.min()).clamp(min=1e-6)
    ys = torch.randint(0, h - 30, (40,), generator=gen, device=device)
    xs = torch.randint(0, w - 30, (40,), generator=gen, device=device)
    hs = torch.randint(8, 30, (40, 2), generator=gen, device=device)
    vs = torch.rand((40,), generator=gen, device=device)
    for y, x, (bh, bw), v in zip(ys.tolist(), xs.tolist(), hs.tolist(),
                                 vs.tolist()):
        img[y:y + bh, x:x + bw] = v
    return 20.0 + 220.0 * img


class Plane:
    def __init__(self, origin, ax_u, ax_v, tex: torch.Tensor):
        self.origin = np.asarray(origin, np.float64)
        self.ax_u = np.asarray(ax_u, np.float64)  # world step per texel u
        self.ax_v = np.asarray(ax_v, np.float64)
        self.tex = tex  # (th, tw) float32 on the device


def room_surfaces(half_x=3.0, half_y=2.2, z_near=-2.0, z_far=6.0):
    """(origin, U, V) of the back wall, left and right walls, floor (+y)
    and ceiling of an open box: the surface is origin + a U + b V, a, b in
    [0, 1]."""
    span = z_far - z_near
    e = np.eye(3)
    return [
        ([-half_x, -half_y, z_far], 2 * half_x * e[0], 2 * half_y * e[1]),
        ([-half_x, -half_y, z_near], span * e[2], 2 * half_y * e[1]),
        ([half_x, -half_y, z_near], span * e[2], 2 * half_y * e[1]),
        ([-half_x, half_y, z_near], 2 * half_x * e[0], span * e[2]),
        ([-half_x, -half_y, z_near], 2 * half_x * e[0], span * e[2]),
    ]


def room_planes(seed: int, device, tex_hw=(720, 960)):
    """The room's surfaces, each with a value-noise texture drawn from
    `seed`."""
    th, tw = tex_hw
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return [Plane(o, np.asarray(U) / tw, np.asarray(V) / th,
                  _value_noise_texture(th, tw, gen, device))
            for o, U, V in room_surfaces()]


def pinhole_rays(params: Sequence[float], width: int, height: int,
                 device, iters: int = 8) -> torch.Tensor:
    """(H, W, 3) unit-z rays of the raw pixels of a radtan camera with
    params [fx, fy, cx, cy, k1, k2, p1, p2, k3] (fixed-point
    undistortion)."""
    fx, fy, cx, cy, k1, k2, p1, p2, k3 = [float(v) for v in params]
    vv, uu = torch.meshgrid(
        torch.arange(height, dtype=torch.float64, device=device),
        torch.arange(width, dtype=torch.float64, device=device),
        indexing="ij")
    xd = (uu - cx) / fx
    yd = (vv - cy) / fy
    a, b = xd, yd
    for _ in range(iters):
        r2 = a * a + b * b
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * a * b + p2 * (r2 + 2.0 * a * a)
        dy = p1 * (r2 + 2.0 * b * b) + 2.0 * p2 * a * b
        a = (xd - dx) / radial
        b = (yd - dy) / radial
    return torch.stack([a, b, torch.ones_like(a)], dim=-1).to(torch.float32)


def render_rays(planes, rays: torch.Tensor, R_cw: torch.Tensor,
                t_cw: torch.Tensor) -> torch.Tensor:
    """Ideal z-buffered renders (B, H, W) float32 of the planes seen along
    `rays` (H, W, 3) from the poses T_cw = (R_cw (B, 3, 3), t_cw (B, 3))."""
    B = R_cw.shape[0]
    H, W = rays.shape[:2]
    dev = rays.device
    R_wc = R_cw.transpose(1, 2)
    c_w = -(R_wc @ t_cw[:, :, None])[:, :, 0]  # (B, 3)
    dirs = torch.einsum("bij,hwj->bhwi", R_wc, rays)  # (B, H, W, 3)
    frame = torch.zeros((B, H, W), dtype=torch.float32, device=dev)
    zbuf = torch.full((B, H, W), float("inf"), dtype=torch.float32,
                      device=dev)
    for pl in planes:
        n = np.cross(pl.ax_u, pl.ax_v)
        n /= max(np.linalg.norm(n), 1e-12)
        Gm = np.array([[pl.ax_u @ pl.ax_u, pl.ax_u @ pl.ax_v],
                       [pl.ax_v @ pl.ax_u, pl.ax_v @ pl.ax_v]])
        Gi = np.linalg.inv(Gm)
        bu = Gi[0, 0] * pl.ax_u + Gi[0, 1] * pl.ax_v
        bv = Gi[1, 0] * pl.ax_u + Gi[1, 1] * pl.ax_v
        f = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
        nt, ot, but, bvt = f(n), f(pl.origin), f(bu), f(bv)
        den = dirs @ nt
        den = torch.where(den.abs() < 1e-9, torch.full_like(den, 1e-9), den)
        s = ((ot - c_w) @ nt)[:, None, None] / den  # (B, H, W)
        p = c_w[:, None, None, :] + s[..., None] * dirs
        rel = p - ot
        ut = rel @ but
        vt = rel @ bvt
        th, tw = pl.tex.shape
        grid = torch.stack([2.0 * ut / (tw - 1) - 1.0,
                            2.0 * vt / (th - 1) - 1.0], dim=-1)
        warped = torch.nn.functional.grid_sample(
            pl.tex[None, None].expand(B, 1, th, tw), grid, mode="bilinear",
            padding_mode="zeros", align_corners=True)[:, 0]
        inside = (ut >= 0) & (ut <= tw - 1) & (vt >= 0) & (vt <= th - 1)
        vis = inside & (s > 0.1) & (s < zbuf)
        frame = torch.where(vis, warped, frame)
        zbuf = torch.where(vis, s, zbuf)
    return frame


def _gauss_taps(sigma: float) -> list:
    """cv2.getGaussianKernel's taps for a float image: ksize =
    round(sigma * 8 + 1) | 1."""
    k = int(round(sigma * 8 + 1)) | 1
    r = k // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (g / g.sum()).tolist()


def photometric(frames: torch.Tensor, vignette: torch.Tensor,
                gains: torch.Tensor, noise_dn: float,
                gen: torch.Generator, sigma: float = 0.6) -> torch.Tensor:
    """Image formation of the ideal renders (B, H, W): vignetting, the
    exposure gain of each frame (B,), a Gaussian defocus, sensor noise and
    8-bit quantization. Returns uint8 (B, H, W)."""
    img = frames * vignette[None] * gains[:, None, None]
    taps = _gauss_taps(sigma)
    r = len(taps) // 2
    x = torch.nn.functional.pad(img[:, None], (r, r, 0, 0),
                                mode="reflect")[:, 0]
    W = img.shape[2]
    img = sum(w * x[:, :, i:i + W] for i, w in enumerate(taps))
    H = img.shape[1]
    x = torch.nn.functional.pad(img[:, None], (0, 0, r, r),
                                mode="reflect")[:, 0]
    img = sum(w * x[:, i:i + H, :] for i, w in enumerate(taps))
    img = img + noise_dn * torch.randn(img.shape, generator=gen,
                                       device=img.device)
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def periodic_gains(n: int, drift: float, rng: np.random.Generator
                   ) -> np.ndarray:
    """Exposure gains of one lap of n frames: a random walk of step
    `drift` in log gain, bridged so that the lap ends where it starts
    (gain 1), clipped to [0.7, 1.4] as the JAX renderer clips it."""
    w = np.cumsum(rng.normal(0.0, drift, n))
    w = w - np.arange(1, n + 1) / n * w[-1]
    return np.clip(np.exp(w), 0.7, 1.4)


def vignette_of(rays: torch.Tensor) -> torch.Tensor:
    r2 = rays[..., 0] ** 2 + rays[..., 1] ** 2
    return 1.0 / (1.0 + r2) ** 1.5


def lap_poses(orbit: Orbit, n: int, fps: float):
    """(R_cw, t_cw) float64 of the n frames of one lap at times k / fps."""
    return orbit.pose_cw(np.arange(n) / fps)


def render_lap(planes, rays: torch.Tensor, orbit: Orbit, n: int,
               fps: float, batch: int = 8) -> torch.Tensor:
    """The clean lap (n, H, W) float32 on the device."""
    R, t = lap_poses(orbit, n, fps)
    dev = rays.device
    out = []
    for i in range(0, n, batch):
        out.append(render_rays(
            planes, rays,
            torch.as_tensor(R[i:i + batch], dtype=torch.float32, device=dev),
            torch.as_tensor(t[i:i + batch], dtype=torch.float32,
                            device=dev)))
    return torch.cat(out)


def lap_seam_gap(orbit: Orbit, dt: float = 1e-3) -> dict:
    """Position, velocity and rotation gaps between the lap's end and its
    start (all zero for a closed orbit)."""
    T = orbit.lap_s
    p0, p1 = orbit.position(np.array([0.0, T]))
    v0 = (orbit.position(np.array([dt]))[0]
          - orbit.position(np.array([-dt]))[0]) / (2 * dt)
    v1 = (orbit.position(np.array([T + dt]))[0]
          - orbit.position(np.array([T - dt]))[0]) / (2 * dt)
    R0, R1 = orbit.rotation(np.array([0.0, T]))
    ang = math.acos(max(-1.0, min(1.0, (np.trace(R0.T @ R1) - 1) / 2)))
    return dict(position_m=float(np.linalg.norm(p1 - p0)),
                velocity_m_s=float(np.linalg.norm(v1 - v0)),
                rotation_rad=ang)
