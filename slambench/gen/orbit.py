"""The `orbit` traffic: a live camera (and IMU) flying laps of one closed
orbit through the textured room, fed to the System one frame at a time
(closed loop: the next frame is handed over when the call returns).

Set-up renders the clean lap once on the card, draws a pool of noisy laps
from the seed (sensor noise, exposure drift, 8-bit quantization) and keeps
them in host memory as a camera would deliver them, builds the lap's IMU,
and flies the set-up that the configuration's sensor asks for (laps, or
keyframe intervals). The window then measures every `track_monocular`
call. Probes on the timed path keep a seeded sample of its outputs
(features and poses of tracked frames, local BA solves, preintegrated
intervals) for the comparison with the plain references once the window
has closed.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from slambench import harness, scene
from slambench.reference import ba as ref_ba
from slambench.reference import extract as ref_ex
from slambench.reference import pose as ref_pose
from slambench.reference import preint as ref_pre
from slambench.reference.precision import precision


class Workload:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 trace: bool):
        self.cfg, self.traffic = config, traffic
        self.seed, self.device, self.trace = int(seed), device, trace
        self.rng = np.random.default_rng(self.seed)
        self.slice = harness.Slice()

    # ------------------------------------------------------------ set-up

    def setup(self):
        from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
        from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
        from orb_slam3_ros2_tpu_torch.runtime import system as sysm

        self.sysm = sysm
        tr, cfg = self.traffic, self.cfg
        with tempfile.TemporaryDirectory() as tmp:
            yaml = harness.write_settings(cfg["settings"],
                                          Path(tmp) / "settings.yaml")
            st = cfg["settings"]
            ex_cfg = ex.ExtractorConfig(
                n_features=int(st["ORBextractor.nFeatures"]),
                n_levels=int(st["ORBextractor.nLevels"]),
                scale_factor=float(st["ORBextractor.scaleFactor"]))
            map_cfg = ms.MapConfig(cfg["map"]["max_kf"], cfg["map"]["max_lm"],
                                   ex.total_capacity(ex_cfg))
            self.slam = sysm.System(
                str(harness.ROOT / cfg["vocabulary"]), yaml,
                sysm.Sensor[cfg["sensor"]], map_cfg=map_cfg,
                pipelined=bool(cfg["pipelined"]), device=self.device)
        slam = self.slam
        self.extract = ex.make_extractor(slam.ex_cfg)
        self.undistort = sysm.undistort
        self.inertial = slam.sensor == sysm.Sensor.IMU_MONOCULAR
        cam = slam.cam
        self.cam = cam
        self.fps = float(tr["fps"])
        self.n_lap = int(tr["lap_frames"])
        orbit = scene.Orbit.from_params(tr["orbit"])
        self.orbit = orbit
        # the clean lap and the pool of noisy laps (host memory, uint8)
        dev = self.device
        rays = scene.pinhole_rays(cam.params, cam.width, cam.height, dev)
        planes = scene.room_planes(tr["room_seed"], dev)
        clean = scene.render_lap(planes, rays, orbit, self.n_lap, self.fps)
        vig = scene.vignette_of(rays)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        ph = tr["photometric"]
        self.pool = []
        for _ in range(int(tr["noise_pool"])):
            gains = torch.as_tensor(scene.periodic_gains(
                self.n_lap, ph["exposure_drift"], self.rng),
                dtype=torch.float32, device=dev)
            self.pool.append(scene.photometric(
                clean, vig, gains, ph["noise_dn"], gen,
                ph["defocus_sigma"]).cpu().numpy())
        del clean, planes, rays
        self.lap_order = self.rng.permutation(len(self.pool))
        if self.inertial:
            self._setup_imu(st)
        self._install_probes()
        # set-up: fly until the configuration's sensor is in its steady
        # state (every kernel and shape of the window built and run)
        rule = tr["setup"][cfg["sensor"]]
        self.f = 0
        if "laps" in rule or "frames" in rule:
            n = rule.get("frames", int(rule.get("laps", 0)) * self.n_lap)
            for _ in range(int(n)):
                self._feed()
        else:
            while not (slam.is_imu_initialized()
                       and len(slam.kf_preints) >= int(rule["intervals"])):
                if self.f >= 4 * self.n_lap:
                    raise RuntimeError(
                        f"set-up did not reach interval {rule['intervals']} "
                        f"in 4 laps: {len(slam.kf_preints)} intervals, IMU "
                        f"initialized {slam.is_imu_initialized()}")
                self._feed()
        harness.sync()
        if self.trace:
            harness.warm_profiler()
        self.setup_frames = self.f
        self.setup_intervals = (len(slam.kf_preints) if self.inertial
                                else None)

    def _setup_imu(self, st: dict):
        """The lap's IMU at the settings' rate: the orbit's body motion,
        a pool of noise draws with the settings' densities (white noise
        and bias walks), the traffic's true biases."""
        rate = float(st["IMU.Frequency"])
        T = np.asarray(st["IMU.T_b_c1"]["data"], np.float64).reshape(4, 4)
        body = scene.BodyTrajectory(self.orbit, T)
        n = int(round(self.orbit.lap_s * rate))
        self.imu_rate, self.imu_lap = rate, n
        t_local = np.arange(1, n + 1) / rate
        bg = np.asarray(self.traffic["imu"]["true_gyro_bias"], np.float64)
        bacc = np.asarray(self.traffic["imu"]["true_acc_bias"], np.float64)
        self.imu_pool = []
        for _ in range(len(self.pool)):
            gz, az = scene.make_imu(
                body, t_local,
                gyro_noise=float(st["IMU.NoiseGyro"]) * np.sqrt(rate),
                acc_noise=float(st["IMU.NoiseAcc"]) * np.sqrt(rate),
                gyro_walk=float(st["IMU.GyroWalk"]),
                acc_walk=float(st["IMU.AccWalk"]), rng=self.rng)
            self.imu_pool.append((gz + bg, az + bacc))

    def imu_samples(self, m0: int, m1: int):
        """Global samples m0 < m <= m1: (t, gyro, acc); sample m is at m /
        rate and lies in lap (m - 1) // samples_per_lap."""
        m = np.arange(m0 + 1, m1 + 1)
        lap = (m - 1) // self.imu_lap
        i = (m - 1) % self.imu_lap
        gy = np.empty((m.size, 3))
        ac = np.empty((m.size, 3))
        for j in np.unique(lap):
            sel = lap == j
            g, a = self.imu_pool[self.lap_order[j % len(self.pool)]]
            gy[sel], ac[sel] = g[i[sel]], a[i[sel]]
        return m / self.imu_rate, gy, ac

    def frame(self, f: int):
        """(image, timestamp, IMU points) of global frame f."""
        lap, i = divmod(f, self.n_lap)
        img = self.pool[self.lap_order[lap % len(self.pool)]][i]
        ts = f / self.fps
        imu = ()
        if self.inertial:
            per = int(round(self.imu_rate / self.fps))
            t, gy, ac = self.imu_samples((f - 1) * per if f else 0, f * per)
            P = self.sysm.ImuPoint
            imu = [P(ac[k], gy[k], t[k]) for k in range(t.size)]
        return img, ts, imu

    def _feed(self):
        img, ts, imu = self.frame(self.f)
        self.cur_image = img
        self.slam.track_monocular(img, ts, imu)
        self.f += 1

    # ------------------------------------------------------------ probes

    def _install_probes(self):
        """Wrap the tracking step, the local BA and the preintegration as
        the System calls them, keeping a seeded sample of the window's
        calls: inputs as the call saw them, outputs as it returned them."""
        from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused
        from orb_slam3_ros2_tpu_torch.frontend import tracking as trk
        from orb_slam3_ros2_tpu_torch.imu import preintegration as pre_mod

        chk = self.traffic["check"]
        self.recording = False
        self.s_frames = harness.Reservoir(int(chk["frames"]), self.rng)
        self.s_ba = harness.Reservoir(int(chk["insertions"]), self.rng)
        self.s_pre = harness.Reservoir(int(chk["intervals"]), self.rng)
        wl = self

        def track_frame(orig):
            def wrapped(m, feat_uv, feat_bits, feat_mask, feat_level, R_pred,
                        t_pred, *a, **k):
                wl.pose_calls = []
                out = orig(m, feat_uv, feat_bits, feat_mask, feat_level,
                           R_pred, t_pred, *a, **k)
                if wl.recording:
                    j = wl.s_frames.offer()
                    if j is not None:
                        wl.s_frames.items[j] = dict(
                            image=wl.cur_image, uv=feat_uv, bits=feat_bits,
                            mask=feat_mask, level=feat_level,
                            poses=wl.pose_calls)
                return out
            return wrapped

        def optimize_pose(orig):
            def wrapped(R0, t0, X, uv, inv_s2, mask, *a, **k):
                res = orig(R0, t0, X, uv, inv_s2, mask, *a, **k)
                if wl.recording:
                    wl.pose_calls.append(dict(R0=R0, t0=t0, X=X, uv=uv,
                                              inv_s2=inv_s2, mask=mask,
                                              R=res.R, t=res.t))
                return res
            return wrapped

        def local_ba(orig):
            def wrapped(m, window_ids, fix, fx, fy, cx, cy, n_iters=8):
                wl.ba_costs.start()
                out = orig(m, window_ids, fix, fx, fy, cx, cy,
                           n_iters=n_iters)
                costs = wl.ba_costs.record()
                if wl.recording:
                    j = wl.s_ba.offer()
                    if j is not None:
                        wl.s_ba.items[j] = dict(
                            before=type(m)(*(v.clone() for v in m)),
                            ids=window_ids.clone(), fix=fix.clone(),
                            n_iters=n_iters, cam=(fx, fy, cx, cy),
                            R=out.kf_R.clone(), t=out.kf_t.clone(),
                            X=out.lm_X.clone(), costs=costs)
                return out
            return wrapped

        def preintegrate(orig):
            def wrapped(gyro, acc, dts, mask, bg=None, ba=None, **k):
                out = orig(gyro, acc, dts, mask, bg, ba, **k)
                if wl.recording:
                    j = wl.s_pre.offer()
                    if j is not None:
                        kt = wl.slam.kf_times
                        wl.s_pre.items[j] = dict(
                            t_a=kt[-2], t_b=kt[-1], n=int(gyro.shape[0]),
                            bg=bg.clone(), ba=ba.clone(),
                            dR=out.dR.clone(), dv=out.dv.clone(),
                            dp=out.dp.clone())
                return out
            return wrapped

        self.ba_costs = harness.BACosts()
        harness.patch(trk, "track_frame", track_frame)
        harness.patch(pose_opt_fused, "optimize_pose_fused", optimize_pose)
        self.local_ba = harness.patch(trk, "local_ba", local_ba)
        harness.patch(pre_mod, "preintegrate", preintegrate)

    # ------------------------------------------------------------ window

    def window(self, seconds: float) -> dict:
        slam = self.slam
        ok = self.sysm.TrackingState.OK
        slam.tracer.reset()
        self.recording = True
        self.stage_from = 0
        frame_ms, lost = [], 0
        trace_frames = int(self.traffic["trace_frames"])
        t0 = time.perf_counter()
        t_end = t0 + seconds
        self.stage_t0 = t0
        if self.trace:
            self.slice.start()
        while True:
            img, ts, imu = self.frame(self.f)
            self.cur_image = img
            c0 = time.perf_counter()
            if self.slice.active:
                with torch.profiler.record_function("frame"):
                    slam.track_monocular(img, ts, imu)
            else:
                slam.track_monocular(img, ts, imu)
            c1 = time.perf_counter()
            self.f += 1
            if c1 > t_end:
                break
            frame_ms.append((c1 - c0) * 1e3)
            lost += slam.get_tracking_state() != ok
            if self.slice.active and len(frame_ms) >= trace_frames:
                self.slice.stop(len(frame_ms))
                # the stages are read over the rest of the window, which
                # runs without the profiler
                slam.tracer.reset()
                self.stage_from = len(frame_ms)
                self.stage_t0 = time.perf_counter()
        if self.slice.active:
            self.slice.stop(len(frame_ms))
        self.recording = False
        self.window_s = seconds
        self.stage_s = t_end - self.stage_t0
        self.frame_ms = frame_ms
        self.lost = lost
        self.stages = {k: list(v) for k, v in slam.tracer._samples.items()}
        n = len(frame_ms)
        return {"frames_per_s": n / seconds,
                "frame_ms_p95": float(np.percentile(frame_ms, 95,
                                                    method="linear"))}

    def readings(self) -> dict:
        """What the per-layer metrics read."""
        from slambench import roofline

        st = self.cfg["settings"]
        return dict(kind="frames",
                    n_frames=len(self.frame_ms) - self.stage_from,
                    stage_s=self.stage_s,
                    window_s=self.window_s, frame_ms=self.frame_ms,
                    stages=self.stages, slice=self.slice,
                    n_insertions=len(self.stages.get("insert_kf", [])),
                    frontend=roofline.frontend_cost(
                        self.cam.height, self.cam.width,
                        int(st["ORBextractor.nLevels"]),
                        float(st["ORBextractor.scaleFactor"])))

    def attempted_failed(self):
        return len(self.frame_ms), self.lost

    def release(self):
        """Free the program's state (the sampled outputs stay)."""
        if self.inertial:
            print(f"info window keyframe intervals {self.setup_intervals} "
                  f"to {len(self.slam.kf_preints)}", file=sys.stderr)
        del self.slam
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ checks

    def check(self, control: bool = False) -> list:
        """[(name, value, control)] of the compared numbers; with
        `control` the control's readings of the same numbers: the
        program's extraction and local BA with TF32 on (its own lower
        precision), the reference pose refinement and preintegration in
        bfloat16 (the program's pose LM and preintegration are elementwise
        float32, which TF32 leaves as they are)."""
        st = self.cfg["settings"]
        cam = self.cam
        params = cam.params
        n_feat = int(st["ORBextractor.nFeatures"])
        n_lv = int(st["ORBextractor.nLevels"])
        sf = float(st["ORBextractor.scaleFactor"])
        ini, mn = (float(st["ORBextractor.iniThFAST"]),
                   float(st["ORBextractor.minThFAST"]))
        dev = self.device
        frames = [x for x in self.s_frames.items if x is not None]
        out = []
        # extraction: every sampled frame's features against the plain
        # extractor on the same image
        bad = tot = cbad = ctot = 0
        for fr in frames:
            img = torch.as_tensor(np.asarray(fr["image"], np.float32),
                                  device=dev)
            with precision("f32"):
                ref = ref_ex.extract(img, n_feat, n_lv, sf, ini, mn, params)
            prog = dict(uv=fr["uv"], level=fr["level"], bits=fr["bits"],
                        mask=fr["mask"])
            b, t = ref_ex.mismatch(prog, ref)
            bad, tot = bad + b, tot + t
            if control:
                with precision("tf32"):
                    f = self.extract(img)
                ctl = dict(uv=self.undistort(self.cam, f.uv), level=f.level,
                           bits=f.bits, mask=f.mask)
                b, t = ref_ex.mismatch(ctl, ref)
                cbad, ctot = cbad + b, ctot + t
        # no sampled frame is no reading (None), which is not correct
        out.append(("extract_mismatch", bad / tot if tot else None,
                    cbad / ctot if ctot else None))
        # tracking: each pose solve of every sampled frame against the
        # plain robust solve from the same start on the same matches
        worst = cworst = 0.0
        fxy = (cam.fx, cam.fy, cam.cx, cam.cy)
        for fr in frames:
            for c in fr["poses"]:
                args = (c["R0"], c["t0"], c["X"], c["uv"], c["inv_s2"],
                        c["mask"], fxy)
                Rr, tr_, _ = ref_pose.optimize(*args)
                z = (c["X"].double() @ Rr.T + tr_)[:, 2][c["mask"].bool()]
                depth = float(z.median()) if z.numel() else 1.0
                worst = max(worst, ref_pose.gap(c["R"], c["t"], Rr, tr_,
                                                depth))
                if control:
                    Rc, tc, _ = ref_pose.optimize(*args, dtype=torch.bfloat16)
                    cworst = max(cworst, ref_pose.gap(Rc, tc, Rr, tr_,
                                                      depth))
        n_pose = sum(len(fr["poses"]) for fr in frames)
        out.append(("pose_gap", worst if n_pose else None,
                    cworst if control and n_pose else None))
        # mapping: each sampled local BA against the plain BA of the same
        # window of the map it started from
        sols = [x for x in self.s_ba.items if x is not None]
        g = {"pinned_cost": 0.0, "step": 0.0, "cost": 0.0, "pose": 0.0,
             "point": 0.0}
        cg = dict(g)
        for s in sols:
            p, act, moved = local_problem(s)
            ref = ref_ba.bundle_adjust(p, s["cam"], s["n_iters"],
                                       **harness.replay(*s["costs"]))
            ids = s["ids"].long()
            prog = (s["R"][ids], s["t"][ids], s["X"])
            r = ref_ba.gaps(p, s["cam"], prog, ref, moved, act)
            r["step_gap"] = ref_ba.step_gap(s["costs"][1], ref[5])
            for k in g:
                g[k] = max(g[k], r[k + "_gap"])
            if control:
                self.ba_costs.start()
                with precision("tf32"):
                    o = self.local_ba(s["before"], s["ids"], s["fix"],
                                      *s["cam"], n_iters=s["n_iters"])
                rec = self.ba_costs.record()
                ref_c = ref_ba.bundle_adjust(
                    p, s["cam"], s["n_iters"], **harness.replay(*rec))
                r = ref_ba.gaps(p, s["cam"], (o.kf_R[ids], o.kf_t[ids],
                                              o.lm_X), ref_c, moved, act)
                r["step_gap"] = ref_ba.step_gap(rec[1], ref_c[5])
                for k in cg:
                    cg[k] = max(cg[k], r[k + "_gap"])
        # compared, with no limit set yet: the program's landmark guard
        # decides in float32 for nearly degenerate landmarks, so some
        # windows part from the float64 reference by more than TF32 moves
        # them, and no limit separates the two (PERF.md, section 7)
        for k in ("cost", "point"):
            out.append((f"local_ba_{k}_gap", g[k] if sols else None,
                        cg[k] if control and sols else None))
        print("info local_ba " + " ".join(
            f"{k}_gap {g[k]!r} control {cg[k]!r}" for k in g),
            file=sys.stderr)
        # inertial: each sampled interval's deltas against the plain
        # preintegration of the benchmark's own samples
        pres = [x for x in self.s_pre.items if x is not None]
        if pres:
            cap = 4 * max(int(4.0 * self.imu_rate / self.fps), 16)
            worst = cworst = 0.0
            for s in pres:
                per = self.imu_rate
                # the samples delivered up to the keyframe's frame
                t, gy, ac = self.imu_samples(
                    max(int(np.floor(s["t_a"] * per)) - 1, 0),
                    int(np.floor(s["t_b"] * per + 1e-6)))
                g, a, d = ref_pre.interval_samples(t, gy, ac, s["t_a"],
                                                   s["t_b"], cap)
                bg, ba = s["bg"].cpu().numpy(), s["ba"].cpu().numpy()
                ref = ref_pre.preintegrate(g, a, d, bg, ba, device=dev)
                worst = max(worst, ref_pre.gap(
                    (s["dR"], s["dv"], s["dp"]), ref))
                if control:
                    c = ref_pre.preintegrate(g, a, d, bg, ba,
                                             dtype=torch.bfloat16, device=dev)
                    cworst = max(cworst, ref_pre.gap(c, ref))
            out.append(("preint_gap", worst, cworst if control else None))
        if self.inertial:
            # the VI local BA (`System._vi_ba`) is not probed yet, so its
            # poses, velocities and biases have no reading (PERF.md,
            # section 7)
            out.append(("vi_ba_gap", None, None))
        out.append(("lost_frames", float(self.lost), None))
        return out


def local_problem(s: dict):
    """The plain BA problem of a sampled local BA: the window's keyframes
    (a repeated id counts once, at its first slot; an invalid keyframe
    takes no part), each holding one observation per landmark (its lowest
    feature index), landmarks valid; fixed slots and the inactive ones
    pinned. Returns (problem, active slots, landmarks observed)."""
    b = s["before"]._asdict()
    ids = s["ids"].long()
    W = ids.shape[0]
    L = b["lm_X"].shape[0]
    dev = ids.device
    first = torch.ones(W, dtype=torch.bool, device=dev)
    for i in range(W):
        first[i] = not bool((ids[:i] == ids[i]).any())
    active = first & b["kf_valid"][ids]
    obs = b["kf_obs_lm"][ids].long()  # (W, N)
    has = ((obs >= 0) & b["kf_feat_valid"][ids] & active[:, None])
    has &= b["lm_valid"][obs.clamp(min=0)]
    slot, feat = torch.nonzero(has, as_tuple=True)
    lm = obs[slot, feat]
    # one observation per (slot, landmark): the lowest feature index
    key = slot * L + lm
    order = torch.argsort(key * (feat.max() + 1) + feat)
    key_s = key[order]
    keep = torch.ones_like(key_s, dtype=torch.bool)
    keep[1:] = key_s[1:] != key_s[:-1]
    sel = order[keep]
    slot, feat, lm = slot[sel], feat[sel], lm[sel]
    p = ref_ba.Problem(
        R=b["kf_R"][ids], t=b["kf_t"][ids], X=b["lm_X"], k=slot, l=lm,
        uv=b["kf_uv"][ids][slot, feat], fixed=s["fix"] | ~active)
    moved = torch.zeros(L, dtype=torch.bool, device=dev)
    moved[lm] = True
    return p, active, moved
