"""Continuously-operating distributed SLAM session.

Port of `orb_slam3_ros2_tpu/parallel/live_session.py`. Where
`parallel/distributed_session.py` gathers whole maps once at the end, this
is the operating mode with keyframes and map blocks held by N >= 2
processes:

* **Periodic delta exchange**: every `exchange_every` frames (a lockstep
  boundary, so the collective is SPMD-safe) each process all-gathers only
  its NEW keyframes since the last exchange: pose + top-T BoW words +
  feature uv/descriptors + observed-landmark positions. Fixed shapes,
  never the map.
* **Incremental weld during tracking**: each process holds a sparse BoW
  database over its own keyframes (`loop/hvocab.SparseBowDB`) and queries
  it with every peer delta keyframe. A hit is verified descriptor-wise,
  seeded with a RANSAC 3D-3D Sim3 (`loop/sim3.solve_sim3`) and refined by
  robust PnP of the peer keyframe against the local landmarks; tracking
  continues on the next frame.
* **Block residency**: a process stores only its own landmarks; a weld
  gives an inter-host Sim3 and a cross-host pose-graph EDGE, not a merged
  map.
* **Distributed refinement**: at the end the processes all-gather POSES
  ONLY + weld edges, build one global Sim3 pose graph (odometry chains +
  weld edges), solve it with the edge-sharded optimizer over the global
  shard mesh (`parallel/sharded_pose_graph`), and each process applies
  its own block's correction locally (`loop/closing._apply_correction`),
  then re-optimizes its block with a global BA.
* **Mature-map re-weld**: each exchange also republishes ONE refresh
  record, an already-welded anchor keyframe re-extracted from the current
  map, and receivers re-run the verify/Sim3/PnP chain on it, replacing
  their oldest edge for that peer; finalize keeps the newest few edges per
  host pair.

Weld edges key their anchor keyframes by TIMESTAMP, not slot id: the
engine compacts keyframe slots mid-run, and the session subscribes to
`System.kf_remap_listeners` to keep its per-keyframe records aligned. The
anchor timestamps stay float64 in `edge_times` beside the float32 edge
rows: the JAX module stores them in its float32 rows (its :345), where a
timestamp at epoch scale (~1.7e9 s, ulp 128 s) no longer resolves to its
keyframe; the port does not carry that over.

Run one process per host:

    python -m orb_slam3_ros2_tpu_torch.parallel.live_session \\
        --process-id 0 --num-processes 4 \\
        --coordinator 127.0.0.1:9903 --out report.json

(`--device cpu --local-devices 2` on the CPU; `--coordinator` may be a
file:// path.)
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List

import numpy as np
import torch

RING = 6        # max keyframes published per exchange
T_WORDS = 64    # top BoW words carried per published keyframe
MAX_EDGES = 16  # weld-edge capacity per host
MIN_BOW = 0.12  # min BoW cosine for a cross-host candidate
MIN_PAIRS = 15  # min verified landmark pairs for a weld
SLOT_TIME_TOL = 1e-3  # s: a weld anchor's timestamp against its keyframe's


def slot_of(times: np.ndarray, t_key: float) -> int:
    """Resolve a keyframe TIMESTAMP to its slot among a host's keyframe
    times (slots move under compaction; timestamps don't); -1 if no
    keyframe lies within SLOT_TIME_TOL."""
    tt = np.asarray(times, np.float64)
    if tt.size == 0:
        return -1
    i = int(np.argmin(np.abs(tt - t_key)))
    return i if abs(float(tt[i]) - t_key) < SLOT_TIME_TOL else -1


class LiveSession:
    """One host's session: a full System + the delta-exchange/weld protocol."""

    def __init__(self, process_id: int, num_processes: int, settings: str,
                 map_cfg=None, exchange_every: int = 10, device=None,
                 local_devices: int = 0):
        from orb_slam3_ros2_tpu_torch.loop import hvocab as hv
        from orb_slam3_ros2_tpu_torch.runtime.system import Sensor, System

        self.pid = process_id
        self.nproc = num_processes
        self.exchange_every = exchange_every
        self.local_devices = local_devices
        self.sys = System(None, settings, Sensor.MONOCULAR, map_cfg=map_cfg,
                          device=device)
        self.device = self.sys.device
        self.W = self.sys.vocab.n_words
        self.NF = self.sys.map_cfg.n_feat
        self.MAXK = self.sys.map_cfg.max_kf
        self._hv = hv
        self.db = hv.empty_sparse_db(self.MAXK, self.W, top_t=T_WORDS,
                                     device=self.device)
        self._published = 0          # keyframes already exchanged
        self._kf_words: List[np.ndarray] = []   # per-KF word ids
        self._kf_feats: List = []               # per-KF Features
        self.frame_idx = 0
        # weld edges found by THIS host: columns
        # [a_local_kf, peer, b_peer_kf, R(9), t(3), s, (unused 16, 17),
        #  frame_idx(18), n_inl(19)] = 25, the JAX layout; the anchor
        # keyframes' timestamps (stable across slot compaction on either
        # host; finalize re-resolves slots) in float64 beside them
        self.edges = np.zeros((MAX_EDGES, 25), np.float32)
        self.edge_times = np.zeros((MAX_EDGES, 2), np.float64)  # t_a, t_b
        self.n_edges = 0
        self.aligned_peers: dict = {}  # peer -> (R, t, s): x_me = sRx_p + t
        self.weld_frames: List[int] = []
        self._refresh_cursor = 0  # cycles over edges for mature re-welds
        self.sys.kf_remap_listeners.append(self._on_kf_remap)

    def _words(self, w: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(w, dtype=torch.int32, device=self.device)

    def _on_kf_remap(self, remap: np.ndarray, old_n_kf: int):
        """Keyframe slots were compacted by the engine: realign the per-KF
        records, rebuild the sparse BoW DB, and remap edge anchor slots."""
        kept = [k for k in range(old_n_kf) if remap[k] >= 0]
        self._kf_words = [self._kf_words[k] for k in kept
                          if k < len(self._kf_words)]
        self._kf_feats = [self._kf_feats[k] for k in kept
                          if k < len(self._kf_feats)]
        self.db = self._hv.empty_sparse_db(self.MAXK, self.W, top_t=T_WORDS,
                                           device=self.device)
        for w in self._kf_words:
            self.db = self._hv.add_entry(self.db, self._words(w), self.W)
        self._published = sum(1 for k in kept if k < self._published)
        keep_rows = []
        for i in range(self.n_edges):
            a = int(self.edges[i, 0])
            if 0 <= a < old_n_kf and remap[a] >= 0:
                self.edges[i, 0] = float(remap[a])
                keep_rows.append(i)
            # anchor culled: drop the edge (its timestamp key would still
            # resolve on the peer side, but the local landmarks are gone)
        self.edges[: len(keep_rows)] = self.edges[keep_rows]
        self.edge_times[: len(keep_rows)] = self.edge_times[keep_rows]
        self.n_edges = len(keep_rows)

    # ---------------------------------------------------------------- track

    def track(self, img, timestamp: float):
        self.sys.track_monocular(img, timestamp)
        # new keyframe? (host-side counter, no device fetch)
        while len(self._kf_words) < len(self.sys.kf_times):
            self._on_new_keyframe()
        self.frame_idx += 1
        if self.frame_idx % self.exchange_every == 0:
            self._exchange()

    def _on_new_keyframe(self):
        from orb_slam3_ros2_tpu_torch.loop import vocab as vocab_mod

        feats = self.sys.last_frame_feats
        words = vocab_mod.assign_words(self.sys.vocab, feats.signs,
                                       feats.mask).cpu().numpy()
        self._kf_words.append(words)
        self._kf_feats.append(feats)
        self.db = self._hv.add_entry(self.db, self._words(words), self.W)

    # ------------------------------------------------------------- exchange

    def _delta(self) -> dict:
        """Fixed-shape numpy record of the keyframes added since the last
        exchange (RING cap; oldest dropped, the pose graph's odometry chain
        covers them), plus ONE mature-refresh row: an already-welded anchor
        keyframe re-extracted from the current map, cycling over this
        host's edges."""
        m = self.sys.map
        n_kf = len(self.sys.kf_times)
        new = list(range(self._published, n_kf))[-RING:]
        rows = RING + 1
        d = dict(
            kf_id=np.full(rows, -1, np.int32),
            time=np.zeros(rows, np.float64),
            pose=np.zeros((rows, 12), np.float32),
            words=np.full((rows, T_WORDS), -1, np.int32),
            uv=np.zeros((rows, self.NF, 2), np.float32),
            bits=np.zeros((rows, self.NF, 8), np.uint32),
            feat_ok=np.zeros((rows, self.NF), bool),
            obs_X=np.zeros((rows, self.NF, 3), np.float32),
            obs_ok=np.zeros((rows, self.NF), bool),
        )
        slots = list(new)
        # refresh slot: the anchor of the next edge in the cycle (if any)
        refresh = -1
        if self.n_edges > 0:
            e = self.edges[self._refresh_cursor % self.n_edges]
            self._refresh_cursor += 1
            a = int(e[0])
            if 0 <= a < n_kf and a < len(self._kf_feats):
                refresh = a
        slots.append(refresh)
        if any(k >= 0 for k in slots):
            lm_X = m.lm_X.cpu().numpy()
            lm_ok = m.lm_valid.cpu().numpy()
            kf_R = m.kf_R.cpu().numpy()
            kf_t = m.kf_t.cpu().numpy()
            kf_obs = m.kf_obs_lm.cpu().numpy()
            for i, k in enumerate(slots):
                if k < 0 or k >= len(self._kf_feats):
                    continue
                d["kf_id"][i] = k
                d["time"][i] = self.sys.kf_times[k]
                d["pose"][i, :9] = kf_R[k].reshape(-1)
                d["pose"][i, 9:] = kf_t[k]
                w = self._kf_words[k][:T_WORDS]
                d["words"][i, :len(w)] = w
                f = self._kf_feats[k]
                d["uv"][i] = f.uv.cpu().numpy()
                d["bits"][i] = f.bits.cpu().numpy().view(np.uint32)
                d["feat_ok"][i] = f.mask.cpu().numpy()
                obs = kf_obs[k]
                safe = np.clip(obs, 0, lm_X.shape[0] - 1)
                d["obs_X"][i] = lm_X[safe]
                d["obs_ok"][i] = (obs >= 0) & lm_ok[safe] & d["feat_ok"][i]
        self._published = n_kf
        return d

    def _exchange(self):
        from orb_slam3_ros2_tpu_torch.parallel import mesh as mesh_mod

        gathered = mesh_mod.process_allgather(self._delta())
        for peer in range(self.nproc):
            if peer == self.pid:
                continue
            for i in range(RING + 1):
                if int(gathered["kf_id"][peer, i]) < 0:
                    continue
                rec = {k: np.asarray(v[peer, i])
                       for k, v in gathered.items()}
                self._try_weld(peer, rec)

    # ----------------------------------------------------------------- weld

    def _try_weld(self, peer: int, rec: dict):
        """BoW candidate -> descriptor match -> Sim3 RANSAC -> PnP refine.
        On success, records an inter-host alignment + a pose-graph edge."""
        from orb_slam3_ros2_tpu_torch.backend import pose_opt
        from orb_slam3_ros2_tpu_torch.loop import sim3 as sim3_mod
        from orb_slam3_ros2_tpu_torch.ops import matcher
        from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as desc_ops

        if len(self.sys.kf_times) < 2:
            return
        dev = self.device
        # replacement policy: at most 2 edges per peer; a NEW weld for a
        # peer at capacity overwrites that peer's OLDEST edge (mature
        # re-welds age the immature early edges out), and the global cap
        # overwrites the globally oldest edge as a last resort
        peer_rows = [i for i in range(self.n_edges)
                     if int(self.edges[i, 1]) == peer]
        write_row = None
        if len(peer_rows) >= 2:
            write_row = min(peer_rows, key=lambda i: self.edges[i, 18])
        elif self.n_edges >= MAX_EDGES:
            write_row = int(np.argmin(self.edges[: self.n_edges, 18]))
        scores, ids = self._hv.query_sparse(
            self.db, self._words(rec["words"]), self.W, top_k=1)
        score = float(scores[0])
        a = int(ids[0])
        if score < MIN_BOW or a < 0:
            return
        m = self.sys.map

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        obs_a = m.kf_obs_lm[a].cpu().numpy()
        valid_a = m.kf_feat_valid[a].cpu().numpy() & (obs_a >= 0)
        signs_a = desc_ops.signs_from_bits(m.kf_bits[a])
        signs_b = desc_ops.signs_from_bits(
            t(rec["bits"].view(np.int32), torch.int32))
        res = matcher.match(signs_a, t(valid_a, torch.bool), signs_b,
                            t(rec["obs_ok"], torch.bool), max_dist=50.0,
                            ratio=0.8, mutual=True)
        idx = res.idx.cpu().numpy()
        lm_X = m.lm_X.cpu().numpy()
        sel = np.where((idx >= 0) & valid_a)[0]
        if len(sel) < MIN_PAIRS:
            return
        X_me = lm_X[obs_a[sel]]
        X_pe = rec["obs_X"][idx[sel]]
        uv_pe = rec["uv"][idx[sel]]
        gen = torch.Generator(device=dev).manual_seed(11 + self.pid * 131
                                                      + peer)
        N = len(sel)
        r3 = sim3_mod.solve_sim3(gen, t(X_me), t(X_pe),
                                 torch.ones(N, dtype=torch.bool, device=dev),
                                 min_inliers=MIN_PAIRS)
        if not bool(r3.ok):
            return
        # seed: x_me = s R x_peer + t
        R_w = r3.R.cpu().numpy()
        t_w = r3.t.cpu().numpy()
        s_w = float(r3.s)
        R_b = rec["pose"][:9].reshape(3, 3)
        t_b = rec["pose"][9:]
        # PnP: peer keyframe pose against MY landmarks (pixel-accurate)
        R0 = R_b @ R_w.T
        t0 = s_w * t_b - R0 @ t_w
        cam = self.sys.cam
        ones = torch.ones(N, device=dev)
        mask = torch.ones(N, dtype=torch.bool, device=dev)
        res1 = pose_opt.optimize_pose(
            t(R0), t(t0), t(X_me), t(uv_pe), ones, mask,
            cam.fx, cam.fy, cam.cx, cam.cy,
            n_rounds=2, iters_per_round=8, chi2_th=1e9)
        res2 = pose_opt.optimize_pose(
            res1.R, res1.t, t(X_me), t(uv_pe), ones, mask,
            cam.fx, cam.fy, cam.cx, cam.cy, n_rounds=3, iters_per_round=5)
        if int(res2.n_inliers) < MIN_PAIRS:
            return
        R_a = res2.R.cpu().numpy()
        t_a = res2.t.cpu().numpy()
        inl = res2.inliers.cpu().numpy()
        z_me = X_me[inl] @ R_a.T[:, 2] + t_a[2]
        z_pe = X_pe[inl] @ R_b.T[:, 2] + t_b[2]
        okz = (z_me > 0.1) & (z_pe > 0.1)
        if okz.sum() >= MIN_PAIRS:
            s_w = float(np.median(z_me[okz] / z_pe[okz]))
        R_w = R_a.T @ R_b
        t_w = R_a.T @ (s_w * t_b - t_a)
        # record: x_me = s_w R_w x_peer + t_w
        if write_row is None:
            write_row = self.n_edges
            self.n_edges += 1
        e = self.edges[write_row]
        e[0] = a
        e[1] = peer
        e[2] = rec["kf_id"]
        e[3:12] = R_w.reshape(-1)
        e[12:15] = t_w
        e[15] = s_w
        # maturity metadata (finalize keeps the newest edges per host pair)
        e[16:18] = 0.0
        e[18] = self.frame_idx
        e[19] = int(res2.n_inliers)
        # the anchors' stable keys, float64 (finalize re-resolves slots)
        self.edge_times[write_row] = (self.sys.kf_times[a],
                                      float(rec["time"]))
        # latest weld wins: later welds see more mature maps
        self.aligned_peers[peer] = (R_w, t_w, s_w)
        self.weld_frames.append(self.frame_idx)

    # ------------------------------------------------------------- finalize

    def finalize(self):
        """Global distributed pose-graph refinement over POSES ONLY, then
        apply this host's block correction locally. Returns the report."""
        from orb_slam3_ros2_tpu_torch.frontend import tracking as trk
        from orb_slam3_ros2_tpu_torch.geom import lie
        from orb_slam3_ros2_tpu_torch.loop import closing as closing_mod
        from orb_slam3_ros2_tpu_torch.parallel import mesh as mesh_mod
        from orb_slam3_ros2_tpu_torch.parallel import multiproc
        from orb_slam3_ros2_tpu_torch.parallel import sharded_pose_graph as spg

        # flush remaining keyframes into one more exchange so late welds
        # are found, and REPUBLISH each host's trailing keyframes: a late
        # re-weld against the BA-refined maps gives the pose graph far
        # tighter cross-host edges than the mid-run welds
        self._exchange()
        self._published = max(0, len(self.sys.kf_times) - RING)
        self._exchange()

        m = self.sys.map
        n_kf = len(self.sys.kf_times)
        poses = np.zeros((self.MAXK, 12), np.float32)
        kf_R = m.kf_R[:n_kf].cpu().numpy()
        kf_t = m.kf_t[:n_kf].cpu().numpy()
        poses[:n_kf, :9] = kf_R.reshape(n_kf, -1)
        poses[:n_kf, 9:] = kf_t
        times = np.zeros((self.MAXK,), np.float64)
        times[:n_kf] = np.asarray(self.sys.kf_times[:n_kf])
        payload = dict(
            poses=poses, times=times, n_kf=np.asarray(n_kf, np.int32),
            edges=self.edges.copy(), edge_times=self.edge_times.copy(),
            n_edges=np.asarray(self.n_edges, np.int32),
        )
        g = mesh_mod.process_allgather(payload)
        P, MAXK = self.nproc, self.MAXK
        n_kf_all = [int(g["n_kf"][p]) for p in range(P)]

        def _slot_of(host: int, t_key: float) -> int:
            return slot_of(g["times"][host][: n_kf_all[host]], t_key)

        # ---- host alignment A_h (host world -> host-0 world) via BFS ----
        # weld (me=p, peer=q): x_p = W x_q  =>  A_q = A_p o W. Edge
        # anchors re-resolved by timestamp; per unordered host pair only
        # the NEWEST few edges survive (mature re-welds supersede the
        # immature first-contact welds)
        by_pair: dict = {}
        for p in range(P):
            ne = int(g["n_edges"][p])
            for e, (ta, tb) in zip(np.asarray(g["edges"][p])[:ne],
                                   np.asarray(g["edge_times"][p])[:ne]):
                q = int(e[1])
                a = _slot_of(p, float(ta))
                b = _slot_of(q, float(tb))
                if a < 0 or b < 0:
                    continue
                e = e.copy()
                e[0] = a
                e[2] = b
                by_pair.setdefault((min(p, q), max(p, q)), []).append(
                    (float(e[18]), p, e))
        all_edges = []
        for pair, lst in by_pair.items():
            lst.sort(key=lambda x: -x[0])
            all_edges.extend((p, e) for _, p, e in lst[:3])
        align = {0: (np.eye(3), np.zeros(3), 1.0)}
        changed = True
        while changed:
            changed = False
            for p, e in all_edges:
                q = int(e[1])
                Rw = e[3:12].reshape(3, 3)
                tw = e[12:15]
                sw = float(e[15])
                if p in align and q not in align:
                    Ra, ta, sa = align[p]
                    align[q] = (Ra @ Rw, sa * (Ra @ tw) + ta, sa * sw)
                    changed = True
                if q in align and p not in align:
                    Ra, ta, sa = align[q]
                    Ri, ti, si = (Rw.T, -Rw.T @ tw / sw, 1.0 / sw)
                    align[p] = (Ra @ Ri, sa * (Ra @ ti) + ta, sa * si)
                    changed = True
        n_connected = len(align)
        for p in range(P):
            align.setdefault(p, (np.eye(3), np.zeros(3), 1.0))

        # ---- global Sim3 pose graph ----
        K = P * MAXK
        Rg = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        tg = np.zeros((K, 3), np.float32)
        sg = np.ones((K,), np.float32)
        valid = np.zeros(K, bool)
        for p in range(P):
            Ra, ta, sa = align[p]
            # S_glob = S_loc o A_h^{-1};  A_h^{-1} = (Ra^T, -Ra^T ta/sa, 1/sa)
            Ri, ti, si = Ra.T, -Ra.T @ ta / sa, 1.0 / sa
            for k in range(n_kf_all[p]):
                R_l = g["poses"][p, k, :9].reshape(3, 3)
                t_l = g["poses"][p, k, 9:]
                Rg[p * MAXK + k] = R_l @ Ri
                tg[p * MAXK + k] = R_l @ ti + t_l
                sg[p * MAXK + k] = float(si)
                valid[p * MAXK + k] = True

        def s3(R, t_, s):
            f32 = torch.float32
            return (torch.as_tensor(np.asarray(R), dtype=f32),
                    torch.as_tensor(np.asarray(t_), dtype=f32),
                    torch.as_tensor(float(s), dtype=f32))

        ei, ej, Rm, tm, sm, wts = [], [], [], [], [], []
        for p in range(P):
            for k in range(n_kf_all[p] - 1):  # odometry chain
                i, j = p * MAXK + k, p * MAXK + k + 1
                Si = s3(g["poses"][p, k, :9].reshape(3, 3),
                        g["poses"][p, k, 9:], 1.0)
                Sj = s3(g["poses"][p, k + 1, :9].reshape(3, 3),
                        g["poses"][p, k + 1, 9:], 1.0)
                Rr, tr, sr = lie.sim3_compose(*Si, *lie.sim3_inverse(*Sj))
                ei.append(i)
                ej.append(j)
                Rm.append(Rr.numpy())
                tm.append(tr.numpy())
                sm.append(float(sr))
                wts.append(1.0)
        for p, e in all_edges:  # weld edges
            a, q, b = int(e[0]), int(e[1]), int(e[2])
            if a >= n_kf_all[p] or b >= n_kf_all[q]:
                continue
            Sw = s3(e[3:12].reshape(3, 3), e[12:15], float(e[15]))
            Sa = s3(g["poses"][p, a, :9].reshape(3, 3), g["poses"][p, a, 9:],
                    1.0)
            # peer keyframe's CURRENT pose (finalize-time gather): welds
            # stay consistent even if the peer refined the pose since
            Sb = s3(g["poses"][q, b, :9].reshape(3, 3), g["poses"][q, b, 9:],
                    1.0)
            # S_ab = S_a_loc o W o S_b_loc^-1 (in host-p's metric)
            Rr, tr, sr = lie.sim3_compose(
                *Sa, *lie.sim3_compose(*Sw, *lie.sim3_inverse(*Sb)))
            ei.append(p * MAXK + a)
            ej.append(q * MAXK + b)
            Rm.append(Rr.numpy())
            tm.append(tr.numpy())
            sm.append(float(sr))
            wts.append(1.0)

        mesh = mesh_mod.make_mesh(
            devices=multiproc.shard_devices(self.device, self.local_devices))
        n_dev = mesh.size
        E = max(len(ei), 1)
        E_pad = -(-E // n_dev) * n_dev
        pad = E_pad - len(ei)
        dev = self.device

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        R_meas = np.stack(Rm + [np.eye(3)] * pad).astype(np.float32)
        t_meas = np.stack(tm + [np.zeros(3)] * pad).astype(np.float32)
        w_e = np.asarray(wts + [0.0] * pad, np.float32)
        fixed = ~valid
        fixed[0] = True  # gauge: host-0 first keyframe
        opt = spg.make_sharded_pose_graph(mesh, K, n_iters=12)
        pg_res = opt(
            t(Rg), t(tg), t(sg), t(ei + [0] * pad, torch.int32),
            t(ej + [0] * pad, torch.int32), t(R_meas), t(t_meas),
            t(sm + [1.0] * pad), edge_valid=t(w_e > 0, torch.bool),
            fixed=t(fixed, torch.bool), edge_weight=t(w_e))

        # ---- apply THIS host's block correction locally ----
        my = slice(self.pid * MAXK, (self.pid + 1) * MAXK)
        # the local map in the global frame first: its poses are then the
        # SE3 form of the pose graph's initial Sim3 nodes (t_se3 = t_sim3 /
        # s), which _apply_correction expects for the landmark transport
        Ra, ta, sa = align[self.pid]
        m2 = _transform_map(m, Ra, ta, sa)
        m2 = closing_mod._apply_correction(
            m2, m2.kf_R, m2.kf_t, pg_res.R[my].to(dev), pg_res.t[my].to(dev),
            pg_res.s[my].to(dev))
        # block-resident repair: re-optimize THIS host's own block against
        # its own observations (the pose graph moved keyframes rigidly;
        # landmark transport is approximate): local work, no traffic
        cam = self.sys.cam
        if n_kf >= 2:
            m2 = trk.global_ba(m2, n_kf, cam.fx, cam.fy, cam.cx, cam.cy,
                               n_iters=8)
        self.sys.map = m2
        self.sys._mark_frame_ref_dirty()
        return dict(
            n_kf=n_kf, n_lm_local=int(m.lm_valid.sum()),
            n_edges=self.n_edges, weld_frames=self.weld_frames,
            n_connected_hosts=n_connected, global_shards=n_dev,
            pose_graph_cost=float(pg_res.cost.reshape(-1)[-1]),
        )


def _transform_map(m, R_A, t_A, s_A):
    """Apply x' = s R x + t to a MapState (landmarks + poses), the
    merge_maps pose-transport formulas."""
    dev = m.lm_X.device
    R_A = torch.as_tensor(np.asarray(R_A), dtype=torch.float32, device=dev)
    t_A = torch.as_tensor(np.asarray(t_A), dtype=torch.float32, device=dev)
    s = float(s_A)
    lm_X = s * torch.einsum("ij,lj->li", R_A, m.lm_X) + t_A
    kf_R = m.kf_R @ R_A.T[None]
    kf_t = s * m.kf_t - torch.einsum("kij,j->ki", kf_R, t_A)
    return m._replace(lm_X=lm_X, kf_R=kf_R, kf_t=kf_t)


# --------------------------------------------------------------------------
# worker entry point (one process per host)
# --------------------------------------------------------------------------

def run_worker(process_id: int, num_processes: int, coordinator: str,
               local_devices: int, out_path: str, n_frames: int = 100,
               overlap: int = 12, device=None, backend=None) -> dict:
    import torch.distributed as dist

    from orb_slam3_ros2_tpu_torch.parallel import multiproc

    device = torch.device("cuda" if device is None else device)
    backend = multiproc.join_group(process_id, num_processes, coordinator,
                                   device, backend)
    try:
        return _session(process_id, num_processes, local_devices, out_path,
                        n_frames, overlap, device, backend)
    finally:
        dist.destroy_process_group()


def _session(process_id, num_processes, local_devices, out_path, n_frames,
             overlap, device, backend) -> dict:
    from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
    from orb_slam3_ros2_tpu_torch.io import synthetic
    from orb_slam3_ros2_tpu_torch.parallel import distributed_session
    from orb_slam3_ros2_tpu_torch.parallel import mesh as mesh_mod

    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    settings = os.path.join(repo, "tests", "data", "synth_cam.yaml")
    cfg = ms.MapConfig(max_kf=32, max_lm=2048, n_feat=600)

    # shared scene; host p tracks segment [p*seg - overlap, (p+1)*seg)
    images, R_gt, t_gt, ts = synthetic.render_room_sequence(
        n_frames=n_frames, width=320, height=240, fx=260.0, fy=260.0,
        fps=10.0, seed=1, traj_scale=1.3,
    )
    seg = n_frames // num_processes
    lo = max(process_id * seg - (overlap if process_id else 0), 0)
    hi = min((process_id + 1) * seg, n_frames)
    frames = list(range(lo, hi))
    # lockstep: every host steps the same NUMBER of frames (the exchanges
    # are collectives); pad short segments by repeating the last frame
    steps = max(seg + overlap, len(frames))
    while len(frames) < steps:
        frames.append(frames[-1])

    sess = LiveSession(process_id, num_processes, settings, map_cfg=cfg,
                       exchange_every=10, device=device,
                       local_devices=local_devices)
    t0 = time.perf_counter()
    for k in frames:
        sess.track(images[k], float(ts[k]))
    track_wall = time.perf_counter() - t0

    rep = sess.finalize()

    # global-frame keyframe ATE across ALL hosts: all-gather centres
    m = sess.sys.map
    n_kf = rep["n_kf"]
    kf_R = m.kf_R[:n_kf].cpu().numpy()
    kf_t = m.kf_t[:n_kf].cpu().numpy()
    cbuf = np.zeros((cfg.max_kf, 3), np.float32)
    cbuf[:n_kf] = -np.einsum("kji,kj->ki", kf_R, kf_t)
    tbuf = np.zeros((cfg.max_kf,), np.float64)
    tbuf[:n_kf] = sess.sys.kf_times[:n_kf]
    gc = mesh_mod.process_allgather(dict(c=cbuf, t=tbuf,
                                         n=np.asarray(n_kf, np.int32)))
    est, gt, owner = [], [], []
    for p in range(num_processes):
        for k in range(int(gc["n"][p])):
            est.append(gc["c"][p, k])
            idx = int(np.argmin(np.abs(ts - float(gc["t"][p, k]))))
            gt.append(-R_gt[idx].T @ t_gt[idx])
            owner.append(p)
    est, gt, owner = np.asarray(est), np.asarray(gt), np.asarray(owner)
    ate = float(synthetic.ate_rmse(est, gt))
    # per-host internal quality: each host's block aligned independently;
    # the gap between this and the joint ATE is the cross-host weld error
    per_host = []
    for p in range(num_processes):
        sel = owner == p
        per_host.append(round(float(synthetic.ate_rmse(est[sel], gt[sel])),
                              4) if sel.sum() >= 4 else None)

    report = dict(
        process_id=process_id, processes=num_processes,
        global_devices=rep["global_shards"], backend=backend,
        device=str(device),
        frames_tracked=len(frames), track_wall_s=round(track_wall, 1),
        track_ms_per_frame=round(1e3 * track_wall / len(frames), 3),
        weld_frames=rep["weld_frames"], n_edges=rep["n_edges"],
        n_connected_hosts=rep["n_connected_hosts"],
        n_kf_local=rep["n_kf"], n_lm_local=rep["n_lm_local"],
        global_kf_ate_m=round(ate, 4),
        per_host_kf_ate_m=per_host,
        pose_graph_cost=rep["pose_graph_cost"],
        launches=distributed_session.kernel_launches(),
    )
    if process_id == 0:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", default="127.0.0.1:9903",
                    help="host:port, or a file:// path for a file store")
    ap.add_argument("--out", required=True)
    ap.add_argument("--local-devices", type=int, default=0)
    ap.add_argument("--n-frames", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    run_worker(args.process_id, args.num_processes, args.coordinator,
               args.local_devices, args.out, n_frames=args.n_frames,
               device=args.device, backend=args.backend)


if __name__ == "__main__":
    main()
