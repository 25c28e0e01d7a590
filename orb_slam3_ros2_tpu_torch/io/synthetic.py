"""Rendered synthetic sequences for the port's smoke run and tests.

numpy-only pieces copied verbatim from `orb_slam3_ros2_tpu/io/synthetic.py`
(`_so3_exp_np`, `Trajectory`, `default_trajectory`: lines 30-72;
`_texture`, `render_sequence`: lines 154-251; `umeyama_scale`, `ate_rmse`:
lines 606-645), so that a machine without JAX can render the same frames
from the same seed and score a trajectory. `render_sequence` needs cv2; its
optional `cx`/`cy` (default: the image centre, as in the source) is the
port's only addition, so a camera with an off-centre principal point such as
EuRoC cam0 can be rendered.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
