"""The `vi_gba_map` traffic: an inertial map at the System's capacity, made
from the seed, refined by the program's inertial global BA (ORB-SLAM3's
FullInertialBA after a loop closure) solve after solve.

Keyframes lie every `kf_dt_s` seconds along the `orbit` traffic's path
(its file, named by `orbit_from`), over as many laps as they span;
landmarks on the room's surfaces as in `gba_map`, each keyframe observing
up to the extractor's feature capacity of those that project inside its
image, with pixel noise. The IMU is the orbit's body motion (the settings'
`IMU.T_b_c1`) at the settings' rate, with their noise densities and bias
walks on the traffic's true biases. Poses (all but keyframe 0) and points
are perturbed as a loop correction leaves them; the velocities restart
from backward differences of the perturbed keyframe centres, as the
System's `_velocity_guess` does; the gyro bias starts off the true one by
`bias_start_sigma`, the accelerometer bias at zero. The program takes the
map through `atlas.map_state.from_numpy` and each interval's samples
through its own preintegration (in set-up, at the starting biases, as the
System preintegrates at keyframe insertion).

The solve is `runtime/system.vi_ba2`, as `System._run_inertial_gba` calls
it: window 0..K-1, keyframe 0 fixed, every interval inertial, gravity
held. Every solve of the window starts from the same state (the solve
returns a new map state and leaves its input as it was) and ends in a
synchronize.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from slambench import harness, roofline_vi, scene, vi_costs, vi_spans
from slambench.gen.gba_map import camera_of
from slambench.reference import ba as ref_ba
from slambench.reference import extract as ref_ex
from slambench.reference import preint as ref_pre
from slambench.reference import vi_ba as ref_vi
from slambench.reference.precision import precision


def keyframe_times(tr: dict) -> np.ndarray:
    return np.arange(int(tr["keyframes"])) * float(tr["kf_dt_s"])


def make_map(cfg: dict, tr: dict, seed: int, device, times):
    """(fields for `from_numpy`, the observations as a `reference.ba.
    Problem`, the camera): `gba_map.make_map`'s map with its keyframes at
    `times` along the orbit."""
    st = cfg["settings"]
    fx, fy, cx, cy, W, H = camera_of(st)
    K, L = len(times), int(tr["landmarks"])
    n_lv = int(st["ORBextractor.nLevels"])
    budgets = ref_ex.features_per_level(int(st["ORBextractor.nFeatures"]),
                                        n_lv,
                                        float(st["ORBextractor.scaleFactor"]))
    N = sum(budgets)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    f64 = dict(dtype=torch.float64, device=device)
    R_np, t_np = orbit_of(tr).pose_cw(times)
    R = torch.as_tensor(R_np, **f64)
    t = torch.as_tensor(t_np, **f64)
    surf = scene.room_surfaces()
    areas = [np.linalg.norm(np.cross(U, V)) for _, U, V in surf]
    C = int(tr["candidates"])
    which = torch.multinomial(torch.as_tensor(areas, **f64), C,
                              replacement=True, generator=gen)
    ab = torch.rand((C, 2), generator=gen, **f64)
    X = torch.zeros((C, 3), **f64)
    for i, (o, U, V) in enumerate(surf):
        sel = which == i
        X[sel] = (torch.as_tensor(o, **f64) + ab[sel, :1]
                  * torch.as_tensor(U, **f64)
                  + ab[sel, 1:] * torch.as_tensor(V, **f64))
    xc = torch.einsum("kij,cj->kci", R, X) + t[:, None]
    z = xc[..., 2]
    u = fx * xc[..., 0] / z + cx
    v = fy * xc[..., 1] / z + cy
    vis = (z > 0.1) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    keep = torch.nonzero(vis.sum(0) >= int(tr["min_observers"]))[:, 0]
    if keep.numel() < L:
        raise RuntimeError(f"only {keep.numel()} candidate points are seen "
                           f"by {tr['min_observers']} keyframes")
    keep = keep[:L]
    X, vis, u, v = X[keep], vis[:, keep], u[:, keep], v[:, keep]
    prio = torch.rand((K, L), generator=gen, **f64)
    prio = torch.where(vis, prio, -1.0)
    top_v, top_i = torch.topk(torch.nn.functional.pad(
        prio, (0, max(N - L, 0)), value=-1.0), N, dim=1)
    top_i = top_i.clamp(max=L - 1)
    obs_ok = top_v >= 0
    n_obs = torch.zeros(L, dtype=torch.long, device=device).index_add_(
        0, top_i[obs_ok], torch.ones_like(top_i[obs_ok]))
    lm_ok = n_obs >= 2
    obs_ok &= lm_ok[top_i]
    obs_lm = torch.where(obs_ok, top_i, -1)
    noise = float(tr["obs_noise_px"]) * torch.randn((K, N, 2),
                                                     generator=gen, **f64)
    kf_uv = torch.stack([u.gather(1, top_i), v.gather(1, top_i)], -1) + noise
    kf_uv = torch.where(obs_ok[..., None], kf_uv, 0.0)
    level = torch.multinomial(torch.as_tensor(budgets, **f64), K * N,
                              replacement=True, generator=gen).reshape(K, N)
    dphi = float(tr["pose_perturb_rad"]) * torch.randn((K, 3),
                                                        generator=gen, **f64)
    dpos = float(tr["pose_perturb_m"]) * torch.randn((K, 3), generator=gen,
                                                      **f64)
    dphi[0] = 0.0
    dpos[0] = 0.0
    dR, _ = ref_ba.so3_exp_and_jl(dphi)
    X0 = X + float(tr["point_perturb_m"]) * torch.randn(
        (L, 3), generator=gen, **f64)
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (K, N, 8), generator=gen,
                         device=device, dtype=torch.int64).to(torch.int32)
    lm_bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (L, 8), generator=gen,
                            device=device,
                            dtype=torch.int64).to(torch.int32)
    first_kf = torch.where(vis, torch.arange(K, device=device)[:, None],
                           K).amin(0)
    np_ = lambda x: x.cpu().numpy()
    fields = dict(
        kf_R=np_(dR @ R).astype(np.float32),
        kf_t=np_(t + dpos).astype(np.float32),
        kf_valid=np.ones(K, bool), kf_time=times.astype(np.float32),
        kf_uv=np_(kf_uv).astype(np.float32),
        kf_level=np_(level).astype(np.int32), kf_bits=np_(bits),
        kf_feat_valid=np_(obs_ok), kf_obs_lm=np_(obs_lm).astype(np.int32),
        lm_X=np_(X0).astype(np.float32), lm_valid=np_(lm_ok),
        lm_bits=np_(lm_bits), lm_ref_kf=np_(first_kf).astype(np.int32),
        lm_n_obs=np_(n_obs).astype(np.int32),
        lm_found=np.ones(L, np.int32), lm_visible=np.ones(L, np.int32),
        n_kf=np.int32(K), n_lm=np.int32(L))
    k_idx, f_idx = torch.nonzero(obs_ok, as_tuple=True)
    prob = ref_ba.Problem(
        R=torch.as_tensor(fields["kf_R"], device=device),
        t=torch.as_tensor(fields["kf_t"], device=device),
        X=torch.as_tensor(fields["lm_X"], device=device),
        k=k_idx, l=obs_lm[k_idx, f_idx].long(),
        uv=torch.as_tensor(fields["kf_uv"], device=device)[k_idx, f_idx],
        fixed=torch.arange(K, device=device) == 0)
    return fields, prob, (fx, fy, cx, cy)


def orbit_of(tr: dict) -> scene.Orbit:
    return scene.Orbit.from_params(harness.load_json(
        harness.ROOT / "slambench" / "traffic"
        / f"{tr['orbit_from']}.json")["orbit"])


def make_imu(cfg: dict, tr: dict, t_end: float, rng):
    """(times (N,), gyro, acc (N, 3)) of the samples in (0, t_end], numpy
    float64: the orbit's body motion, the settings' noise densities and
    bias walks, the traffic's true biases."""
    st = cfg["settings"]
    rate = float(st["IMU.Frequency"])
    T = np.asarray(st["IMU.T_b_c1"]["data"], np.float64).reshape(4, 4)
    body = scene.BodyTrajectory(orbit_of(tr), T)
    t = np.arange(1, int(round(t_end * rate)) + 1) / rate
    gyro, acc = scene.make_imu(
        body, t, gyro_noise=float(st["IMU.NoiseGyro"]) * np.sqrt(rate),
        acc_noise=float(st["IMU.NoiseAcc"]) * np.sqrt(rate),
        gyro_walk=float(st["IMU.GyroWalk"]),
        acc_walk=float(st["IMU.AccWalk"]), rng=rng)
    imu = tr["imu"]
    return (t, gyro + np.asarray(imu["true_gyro_bias"], np.float64),
            acc + np.asarray(imu["true_acc_bias"], np.float64))


def interval_parts(imu, times):
    """Each interval's samples (gyro, acc, dts), as the System buffers
    them between keyframes (`reference.preint.interval_samples`; no
    interval holds more than the System's cap)."""
    t, gyro, acc = imu
    return [ref_pre.interval_samples(t, gyro, acc, float(a), float(b),
                                     t.shape[0])
            for a, b in zip(times[:-1], times[1:])]


def program_preint(parts, bg, ba, st: dict, device):
    """The program's preintegration of every interval (float32), stacked:
    one batched call where the intervals hold as many samples each."""
    from orb_slam3_ros2_tpu_torch.imu import preintegration as pre_mod

    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    kw = dict(noise_gyro=float(st["IMU.NoiseGyro"]),
              noise_acc=float(st["IMU.NoiseAcc"]))
    bg, ba = f32(bg), f32(ba)
    sizes = {d.shape[0] for _, _, d in parts}
    if len(sizes) == 1:
        (m,) = sizes
        mask = torch.ones(m, dtype=torch.bool, device=device)
        return torch.func.vmap(
            lambda g, a, d: pre_mod.preintegrate(g, a, d, mask, bg, ba,
                                                 **kw))(
            f32(np.stack([g for g, _, _ in parts])),
            f32(np.stack([a for _, a, _ in parts])),
            f32(np.stack([d for _, _, d in parts])))
    return pre_mod.stack([pre_mod.preintegrate(
        f32(g), f32(a), f32(d),
        torch.ones(d.shape[0], dtype=torch.bool, device=device), bg, ba,
        **kw) for g, a, d in parts])


def velocity_guess(R, t, times) -> np.ndarray:
    """Backward differences of the keyframe centres (keyframe 0: zero),
    as `System._velocity_guess`."""
    c = -np.einsum("kji,kj->ki", R, t)
    v = np.zeros_like(c)
    dt = np.maximum(np.diff(times), 1e-3)
    v[1:] = (c[1:] - c[:-1]) / dt[:, None]
    return v


@contextlib.contextmanager
def stepped_down():
    """The program's precisions a step down, for the control: its float64
    linearization (`backend/vi_ba.py` `LIN`) in float32, its float32
    matrix products in TF32. With TF32 alone the control reads as the
    program does (S = V Vᵀ is the only float32 product, and the float64
    gradient fixes where the LM ends). A program without `LIN` (the
    float32 BA before it) gets TF32 alone."""
    from orb_slam3_ros2_tpu_torch.backend import vi_ba

    lin = getattr(vi_ba, "LIN", None)
    if lin is not None:
        vi_ba.LIN = torch.float32
    try:
        with precision("tf32"):
            yield
    finally:
        if lin is not None:
            vi_ba.LIN = lin


class Workload:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 trace: bool):
        self.cfg, self.traffic = config, traffic
        self.seed, self.device, self.trace = int(seed), device, trace
        self.rng = np.random.default_rng(self.seed)
        self.slice = vi_spans.Slice()

    def setup(self):
        from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
        from orb_slam3_ros2_tpu_torch.runtime import system as sysm

        self.sysm = sysm
        tr, st = self.traffic, self.cfg["settings"]
        self.times = keyframe_times(tr)
        fields, self.prob, self.cam = make_map(self.cfg, tr, self.seed,
                                               self.device, self.times)
        self.fields = fields
        self.imu = make_imu(self.cfg, tr, float(self.times[-1]), self.rng)
        self.parts = interval_parts(self.imu, self.times)
        K = len(self.times)
        self.bg0 = (np.asarray(tr["imu"]["true_gyro_bias"], np.float64)
                    + float(tr["bias_start_sigma"])
                    * self.rng.standard_normal(3))
        self.ba0 = np.zeros(3)
        self.v0 = velocity_guess(fields["kf_R"].astype(np.float64),
                                 fields["kf_t"].astype(np.float64),
                                 self.times)
        T = np.asarray(st["IMU.T_b_c1"]["data"], np.float64).reshape(4, 4)
        self.T_bc = T
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                        device=self.device)
        self.args = dict(
            window_ids=torch.arange(K, dtype=torch.int32, device=self.device),
            fixed_mask=torch.arange(K, device=self.device) == 0,
            pres=program_preint(self.parts, self.bg0, self.ba0, st,
                                self.device),
            v0=f32(self.v0), bg=f32(self.bg0), ba=f32(self.ba0),
            R_bc=f32(T[:3, :3]), t_bc=f32(T[:3, 3]))
        self.map = ms.from_numpy(fields, device=self.device)
        self.n_iters = int(tr["n_iters"])
        self.costs = vi_costs.VICosts()
        self.costs.start()
        self.sample = self.solve()  # the untimed first solve
        self.sample_costs = self.costs.record()
        harness.sync()
        if self.trace:
            harness.warm_profiler()

    def solve(self):
        """One inertial global BA; (R, t, X, v, bg, ba) of its result."""
        fx, fy, cx, cy = self.cam
        a = self.args
        m, v, bg, ba, _, _ = self.sysm.vi_ba2(
            self.map, a["window_ids"], a["fixed_mask"], a["pres"], a["v0"],
            a["bg"], a["ba"], fx, fy, cx, cy, a["R_bc"], a["t_bc"],
            n_iters=self.n_iters, opt_gravity=False)
        return (m.kf_R, m.kf_t, m.lm_X, v, bg, ba)

    def window(self, seconds: float) -> dict:
        """Solve after solve until the window closes; a seeded one of the
        solves that completed in it is kept for the check. With the trace
        on, the first `trace_solves` run under the profiler and the rest
        are timed apart (`free_solve_s`)."""
        pick = harness.Reservoir(1, self.rng)
        n = 0
        n_trace = int(self.traffic["trace_solves"])
        t0 = time.perf_counter()
        t_end = t0 + seconds
        t_free = n_free = None
        if self.trace:
            self.slice.start()
        while True:
            self.costs.start()
            if self.slice.active:
                with torch.profiler.record_function("solve"):
                    out = self.solve()
            else:
                out = self.solve()
            harness.sync()
            t_done = time.perf_counter()
            if t_done > t_end:
                break
            n += 1
            if pick.offer() is not None:
                self.sample = out
                self.sample_costs = self.costs.record()
            if self.slice.active and n >= n_trace:
                self.slice.stop(n)
                t_free, n_free = time.perf_counter(), n
                t_last = t_free
            elif t_free is not None:
                t_last = t_done
        if self.slice.active:
            self.slice.stop(n)
        self.free_solve_s = ((t_last - t_free) / (n - n_free)
                             if t_free is not None and n > n_free else None)
        self.n_solves = n
        self.window_s = seconds
        return {"gba_ms": seconds * 1e3 / max(n, 1)}

    def readings(self) -> dict:
        return dict(kind="solves", n_solves=self.n_solves,
                    n_iters=self.n_iters, window_s=self.window_s,
                    slice=self.slice, free_solve_s=self.free_solve_s,
                    vi=roofline_vi.vi_iter_cost(self.prob,
                                                len(self.times) - 1))

    def attempted_failed(self):
        finite = all(bool(torch.isfinite(x).all()) for x in self.sample)
        return self.n_solves, 0 if finite else 1

    def release(self):
        del self.map
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference_problem(self) -> ref_vi.Problem:
        """The plain VI BA's problem: the program's starting state, and
        the intervals preintegrated again from the IMU stream."""
        st, dev = self.cfg["settings"], self.device
        t, gyro, acc = self.imu
        pre = ref_vi.preintegrate(
            t, gyro, acc, self.times, t.shape[0], self.bg0, self.ba0,
            float(st["IMU.NoiseGyro"]), float(st["IMU.NoiseAcc"]), dev)
        f = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev)
        return ref_vi.Problem(
            vis=self.prob, pre=pre, v=f(np.float32(self.v0)),
            bg=f(np.float32(self.bg0)), ba=f(self.ba0),
            bg_c=f(np.float32(self.bg0)), ba_c=f(np.zeros(3)),
            prior_bg=1e2, prior_ba=1e6, R_bc=f(self.T_bc[:3, :3]),
            t_bc=f(self.T_bc[:3, 3]))

    def check(self, control: bool = False) -> list:
        """The sampled solve against the plain float64 VI BA of the same
        map and IMU stream; the control is the program's own solve a
        precision step down (`stepped_down`)."""
        prob = self.reference_problem()

        def held(sample, pairs):
            with precision("f64"):
                ref = ref_vi.bundle_adjust(prob, self.cam, self.n_iters,
                                           accepts=vi_costs.accepts(pairs))
                return ref_vi.gaps(prob, self.cam, sample, ref)

        r = held(self.sample, self.sample_costs)
        c = None
        if control:
            from orb_slam3_ros2_tpu_torch.atlas import map_state as ms

            self.map = ms.from_numpy(self.fields, device=self.device)
            self.costs.start()
            with stepped_down():
                out = self.solve()
            c = held(out, self.costs.record())
        print("info vi_gba " + " ".join(
            f"{k} {r[k]!r} control {c[k] if c else None!r}"
            for k in ("rot_gap", "bg_gap", "ba_gap", "cost_prog",
                      "cost_ref")), file=sys.stderr)
        return [("vi_" + k, r[k], c[k] if c else None)
                for k in ("cost_gap", "pose_gap", "velocity_gap")]
