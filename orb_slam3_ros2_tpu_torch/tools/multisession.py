"""The multi-session problems of `scripts/multisession_demo.py`, built
without JAX.

`build_city_graph` and `centers_rmse` are copies of the script's lines
43-149, with `geom.lie`'s Sim3 functions from the port (float32 on the
CPU, as the script's JAX arrays); `ba_window` is its stage-2 problem
(lines 218-237): a 48-pose x 16,384-landmark BA window, the 512
landmarks of a synthetic scene tiled with position noise. Both take
the script's defaults and seeds, so they build MULTISESSION.json's
problems: a 12-session, 384-keyframe, 401-edge city pose graph and the
window of its distributed BA.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod
from orb_slam3_ros2_tpu_torch.geom import lie
from orb_slam3_ros2_tpu_torch.io import synthetic

BA_CAMERA = (350.0, 350.0, 320.0, 240.0)  # fx, fy, cx, cy of the BA window


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def build_city_graph(n_sessions: int = 12, poses_per: int = 32,
                     drift: float = 0.004, seed: int = 0):
    """Sessions on a sqrt(S) x sqrt(S) block grid; each session loops its
    block. Returns the pose-graph arrays + groundtruth camera centers:
    (R0, t0, s0, ei, ej, Rm, tm, sm, fixed, Rg, tg, n_cross)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_sessions)))
    block = 8.0  # meters between block centers
    radius = 4.2  # loop radius: adjacent loops nearly touch -> cross edges

    Rg, tg, sess_of = [], [], []
    for s in range(n_sessions):
        cx_b = (s % side) * block
        cy_b = (s // side) * block
        for k in range(poses_per):
            a = 2 * np.pi * k / poses_per
            Rwk = np.array([[np.cos(a), -np.sin(a), 0],
                            [np.sin(a), np.cos(a), 0],
                            [0, 0, 1.0]])
            cw = np.array([cx_b + radius * np.cos(a),
                           cy_b + radius * np.sin(a), 0.0])
            R_cw = Rwk.T
            Rg.append(R_cw)
            tg.append(-R_cw @ cw)
            sess_of.append(s)
    Rg = np.asarray(Rg, np.float32)
    tg = np.asarray(tg, np.float32)
    sess_of = np.asarray(sess_of)
    K = len(Rg)
    sg = np.ones(K, np.float32)

    ei, ej, Rm, tm, sm = [], [], [], [], []

    def add_edge(i, j):
        Rj_inv, tj_inv, sj_inv = lie.sim3_inverse(_t(Rg[j]), _t(tg[j]),
                                                  _t(sg[j]))
        Rij, tij, sij = lie.sim3_compose(_t(Rg[i]), _t(tg[i]), _t(sg[i]),
                                         Rj_inv, tj_inv, sj_inv)
        ei.append(i)
        ej.append(j)
        Rm.append(Rij.numpy())
        tm.append(tij.numpy())
        sm.append(float(sij))

    # odometry + in-session loop edge
    for s in range(n_sessions):
        base = s * poses_per
        for k in range(poses_per - 1):
            add_edge(base + k + 1, base + k)
        add_edge(base, base + poses_per - 1)
    # cross-session edges: nearest pose pairs of adjacent blocks (the
    # constraints Atlas merging would produce from place recognition)
    centers = np.stack([-R.T @ t for R, t in zip(Rg, tg)])
    n_cross = 0
    for s in range(n_sessions):
        for s2 in (s + 1, s + side):
            if s2 >= n_sessions:
                continue
            ia = np.where(sess_of == s)[0]
            ib = np.where(sess_of == s2)[0]
            d = np.linalg.norm(centers[ia, None] - centers[None, ib], axis=-1)
            k = np.unravel_index(np.argmin(d), d.shape)
            if d[k] < 2.0:
                add_edge(int(ia[k[0]]), int(ib[k[1]]))
                n_cross += 1

    # drifted initialization: noise accumulates along each session's chain,
    # and each session after the first starts misaligned (merge offset)
    R0 = np.empty_like(Rg)
    t0 = np.empty_like(tg)
    s0 = np.ones(K, np.float32)
    for s in range(n_sessions):
        base = s * poses_per
        off = np.zeros(7, np.float32)
        if s > 0:
            off[:3] = rng.normal(0, 0.3, 3)
            off[3:6] = rng.normal(0, 0.05, 3)
        acc = off
        for k in range(poses_per):
            xi = np.zeros(7, np.float32)
            xi[:3] = rng.normal(0, drift, 3)
            xi[3:6] = rng.normal(0, drift * 0.5, 3)
            acc = acc + xi
            dR, dt, ds = lie.sim3_exp(_t(acc))
            Rk, tk, sk = lie.sim3_compose(dR, dt, ds, _t(Rg[base + k]),
                                          _t(tg[base + k]), _t(sg[base + k]))
            R0[base + k] = Rk.numpy()
            t0[base + k] = tk.numpy()
            s0[base + k] = float(sk)

    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (R0, t0, s0, np.asarray(ei), np.asarray(ej),
            np.stack(Rm), np.stack(tm), np.asarray(sm, np.float32),
            fixed, Rg, tg, n_cross)


def pad_edges(n_shards: int, ei, ej, Rm, tm, sm):
    """The edge arrays padded with invalid identity edges to a multiple of
    n_shards (the script's lines 181-188). Returns (ei, ej, Rm, tm, sm,
    valid)."""
    E = len(ei)
    pad = (-E) % n_shards
    valid = np.asarray([True] * E + [False] * pad)
    return (np.concatenate([ei, np.zeros(pad, ei.dtype)]),
            np.concatenate([ej, np.zeros(pad, ej.dtype)]),
            np.concatenate([Rm, np.tile(np.eye(3, dtype=np.float32),
                                        (pad, 1, 1))]),
            np.concatenate([tm, np.zeros((pad, 3), np.float32)]),
            np.concatenate([sm, np.ones(pad, np.float32)]), valid)


def centers_rmse(R, t, Rg, tg) -> float:
    c = np.einsum("kij,kj->ki", -np.transpose(np.asarray(R), (0, 2, 1)),
                  np.asarray(t))
    cg = np.einsum("kij,kj->ki", -np.transpose(Rg, (0, 2, 1)), tg)
    return float(np.sqrt(np.mean(np.sum((c - cg) ** 2, axis=-1))))


def ba_window(n_poses: int = 48, n_landmarks: int = 16384
              ) -> ba_mod.BAProblem:
    """The script's distributed-BA window as a CPU BAProblem (intrinsics
    `BA_CAMERA`)."""
    Kb, L = n_poses, n_landmarks
    rng = np.random.default_rng(0)
    sc = synthetic.make_scene(n_frames=Kb, n_points=min(L, 512),
                              noise_px=0.5, seed=1)
    reps = L // sc.X.shape[0] + 1
    X = np.tile(sc.X, (reps, 1))[:L] + rng.normal(0, 0.05, (L, 3))
    Rb = sc.R_cw.copy()
    tb = sc.t_cw + rng.normal(0, 0.02, sc.t_cw.shape)
    uv = np.tile(sc.uv, (1, reps, 1))[:, :L]
    w = np.tile(sc.vis, (1, reps))[:, :L].astype(np.float32)
    fixedb = np.zeros(Kb, bool)
    fixedb[0] = True
    return ba_mod.BAProblem(
        R=_t(Rb), t=_t(tb), X=_t(X), uv=_t(uv), w=_t(w),
        fixed=torch.from_numpy(fixedb),
        point_valid=torch.ones(L, dtype=torch.bool))
