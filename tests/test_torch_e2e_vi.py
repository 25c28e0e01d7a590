"""End-to-end visual-inertial SLAM through the port's `System`: copies of
the JAX package's `tests/test_e2e_vi.py`, `test_e2e_stereo_inertial.py`
and `test_e2e_rgbd_inertial.py` with the same clips, settings and bounds
(marked `slow`, as their originals are), and one quick test that runs
IMU_MONOCULAR on `test_e2e_vi.py`'s clip through its VI initialization
and holds the initializer's result to the JAX `vi_init` on the same
window.

The monocular runs draw each initialization attempt's RANSAC samples as
the JAX System does for the same frame (`PRNGKey(n)`), as
`tests/test_torch_e2e_mono.py` does: the map, and so the scale the IMU
recovers, depends on the draw in both packages."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.frontend import initializer as jinit
from orb_slam3_ros2_tpu.imu import preintegration as jpre
from orb_slam3_ros2_tpu.imu import vi_init as jvii
from orb_slam3_ros2_tpu_torch.frontend import initializer as tinit
from orb_slam3_ros2_tpu_torch.imu import preintegration as tpre
from orb_slam3_ros2_tpu_torch.imu import vi_init as tvii
from orb_slam3_ros2_tpu_torch.io import synthetic
from orb_slam3_ros2_tpu_torch.runtime.system import (ImuPoint, Sensor,
                                                     System, TrackingState)
from orb_slam3_ros2_tpu_torch.tools.system_run import imu_points

DATA = os.path.join(os.path.dirname(__file__), "data")
SETTINGS = os.path.join(DATA, "synth_cam.yaml")


@pytest.fixture
def jax_draws(monkeypatch):
    """Feed each monocular initialization attempt the JAX System's samples
    for its frame."""

    def initialize(gen, uv1, uv2, mask, *args, **kwargs):
        kh, kf = jax.random.split(jax.random.PRNGKey(gen.initial_seed()))
        m = jnp.asarray(mask.numpy())
        idx_h = np.array(jinit._sample_indices(kh, m, jinit.N_HYPO, 4))
        idx_f = np.array(jinit._sample_indices(kf, m, jinit.N_HYPO, 8))
        return tinit.initialize_from_samples(
            uv1, uv2, mask, torch.from_numpy(idx_h), torch.from_numpy(idx_f),
            *args, **kwargs)

    monkeypatch.setattr(tinit, "initialize", initialize)


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mono_clip():
    """tests/test_e2e_vi.py's clip: 80 frames at 320x240 and 10 fps, and
    the IMU of the same trajectory (body == camera) with a gyro bias."""
    images, R_gt, t_gt, ts = synthetic.render_sequence(
        n_frames=80, width=320, height=240, fx=260.0, fy=260.0, fps=10.0,
        seed=1, plane_depths=(6.0, 9.0), traj_scale=1.6)
    traj = synthetic.default_trajectory(seed=4, scale=1.6)
    true_bg = np.array([0.01, -0.008, 0.012])
    imu = synthetic.make_imu(traj, -0.02, ts[-1] + 0.01, rate=200.0,
                             gyro_noise=2e-4, acc_noise=2e-3,
                             gyro_bias=true_bg, seed=3)
    return images, R_gt, t_gt, ts, imu, true_bg


def _centres(sys_, R_gt, t_gt, t_from=-np.inf):
    est, gt = [], []
    for k, (t, T) in enumerate(sys_.get_frame_trajectory()):
        if sys_.tracking_log[k]["state"] != int(TrackingState.OK):
            continue
        if t < t_from:
            continue
        est.append(-T[:3, :3].T @ T[:3, 3])
        gt.append(-R_gt[k].T @ t_gt[k])
    return np.asarray(est), np.asarray(gt)


def test_port_vi_init_on_the_e2e_clip_matches_jax_vi_init(
        jax_draws, two_threads, monkeypatch):
    """IMU_MONOCULAR from a blank map until the VI initialization is
    accepted (VI_INIT_KFS = 6, as the JAX test sets it): the stage gates
    (`is_imu_initialized`, `get_inertial_ba1/2`), the scale and
    observability gates, and the gyro bias within tests/test_e2e_vi.py's
    2e-2. The accepted `vi_init` call's window (its preintegrations and
    body poses) is carried to the JAX `vi_init` as numpy: scale, gravity
    rotation, biases and scale variance agree to 1e-4 of their size, as in
    tests/test_torch_imu.py."""
    images, _, _, ts, imu, true_bg = _mono_clip()
    calls = []

    def recorded(pres, R_wb, p_wb, **kw):
        out = vi_init(pres, R_wb, p_wb, **kw)
        calls.append((pres, R_wb, p_wb, kw, out))
        return out

    vi_init = tvii.vi_init
    monkeypatch.setattr(tvii, "vi_init", recorded)
    sys_ = System(None, SETTINGS, Sensor.IMU_MONOCULAR, device="cpu")
    sys_.VI_INIT_KFS = 6
    t_prev = -1.0
    for k in range(40):
        sys_.track_monocular(images[k], float(ts[k]),
                             imu_points(imu, t_prev, float(ts[k])))
        t_prev = float(ts[k])
        if sys_.is_imu_initialized():
            break
    assert sys_.is_imu_initialized(), "VI init never ran/accepted"
    assert sys_.get_inertial_ba1() and sys_.get_inertial_ba2()
    assert sys_.get_tracking_state() == TrackingState.OK
    assert len(sys_.kf_preints) >= sys_.VI_INIT_KFS - 1
    np.testing.assert_allclose(sys_.bg, true_bg, atol=2e-2)

    pres, R_wb, p_wb, kw, out = calls[-1]  # the accepted one
    assert kw == {"fix_scale": False}
    s = float(out.scale)
    assert 0.05 < s < 50.0 and float(out.scale_var) ** 0.5 <= 0.3
    pj = jpre.Preintegrated(**{k: jnp.asarray(v)
                               for k, v in tpre.to_numpy(pres).items()})
    oj = jvii.vi_init(pj, jnp.asarray(R_wb.numpy()),
                      jnp.asarray(p_wb.numpy()), fix_scale=False)
    for name in ("scale", "R_wg", "v", "bg", "scale_var"):
        ref = np.asarray(getattr(oj, name), np.float64)
        got = getattr(out, name).numpy().astype(np.float64)
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), name
    np.testing.assert_allclose(out.ba.numpy(), np.asarray(oj.ba), atol=1e-6)


@pytest.mark.slow
def test_port_e2e_vi_init_metric_scale(jax_draws, two_threads):
    """tests/test_e2e_vi.py through the port: after 80 frames the IMU is
    initialized, the gyro bias within 2e-2, and on the export surface
    after the VI init more than 20 frames, the Umeyama scale within 10%
    of metric and the unaligned length within 35%."""
    images, R_gt, t_gt, ts, imu, true_bg = _mono_clip()
    sys_ = System(None, SETTINGS, Sensor.IMU_MONOCULAR, device="cpu")
    sys_.VI_INIT_KFS = 6
    t_prev = -1.0
    for k in range(len(images)):
        sys_.track_monocular(images[k], float(ts[k]),
                             imu_points(imu, t_prev, float(ts[k])))
        t_prev = float(ts[k])
    assert sys_.get_tracking_state() == TrackingState.OK
    assert sys_.is_imu_initialized(), "VI init never ran/accepted"
    assert sys_.get_inertial_ba1()
    np.testing.assert_allclose(sys_.bg, true_bg, atol=2e-2)
    t_init = sys_.kf_times[min(len(sys_.kf_times) - 1, sys_.VI_INIT_KFS)]
    est, gt = _centres(sys_, R_gt, t_gt, t_from=t_init)
    assert len(est) > 20
    s_uma = synthetic.umeyama_scale(est, gt)
    assert abs(s_uma - 1.0) < 0.10, s_uma
    len_est = np.linalg.norm(np.diff(est, axis=0), axis=1).sum()
    len_gt = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert len_gt > 0.5
    assert abs(len_est - len_gt) / len_gt < 0.35, (len_est, len_gt)


def _rig_run(sensor):
    """The clip of tests/test_e2e_stereo_inertial.py (IMU_STEREO, a 0.12 m
    baseline) or tests/test_e2e_rgbd_inertial.py (IMU_RGBD) through the
    port: 60 frames at 320x240, 10 fps (`system_run.VI_RIGS`, the same
    renderer, IMU and settings)."""
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    rig = next(r for r in sr.VI_RIGS.values() if r.sensor == sensor)
    frames = sr.render_vi_rig(rig)
    sys_ = sr.make_vi_rig_system(rig, "cpu")
    for k in range(rig.n_frames):
        sr.track_vi_rig(sys_, rig, frames, k)
    return sys_, frames[2], frames[3], sr.VI_RIG_BG


@pytest.mark.slow
@pytest.mark.parametrize("sensor", [Sensor.IMU_STEREO, Sensor.IMU_RGBD],
                         ids=["stereo_inertial", "rgbd_inertial"])
def test_port_e2e_metric_inertial(sensor, two_threads):
    """tests/test_e2e_stereo_inertial.py / test_e2e_rgbd_inertial.py
    through the port: state OK, the IMU initialized (scale pinned), the
    gyro bias within 6e-3, more than 30 tracked frames, the unaligned
    length within 12% and the Sim3-aligned ATE under 0.1 m."""
    sys_, R_gt, t_gt, true_bg = _rig_run(sensor)
    assert sys_.get_tracking_state() == TrackingState.OK
    assert sys_.is_imu_initialized(), "VI init never ran/accepted"
    if sensor == Sensor.IMU_STEREO:
        assert sys_.get_inertial_ba1()
    assert np.linalg.norm(sys_.bg - true_bg) < 6e-3, sys_.bg
    est, gt = _centres(sys_, R_gt, t_gt)
    assert len(est) > 30
    len_est = np.linalg.norm(np.diff(est, axis=0), axis=1).sum()
    len_gt = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert len_gt > 0.3
    assert abs(len_est - len_gt) / len_gt < 0.12, (len_est, len_gt)
    ate = synthetic.ate_rmse(est, gt, align=True)
    assert ate < 0.1, f"{sensor.name} ATE {ate:.4f} m"


def test_keyframe_compaction_merges_preintegrations():
    """`_remap_host_kf_state` after culling keyframes: the intervals
    across a culled keyframe merge (MergePrevious), the rest keep their
    order, velocities follow their keyframes' new ids; the merged interval
    equals the JAX `merge` of the same two intervals to 1e-4 of each
    field's size (tests/test_torch_imu.py)."""
    rng = np.random.default_rng(3)
    traj = synthetic.default_trajectory(seed=7)
    pres_j = []
    for i in range(5):
        _, gyro, acc = synthetic.make_imu(traj, 0.3 * i, 0.3 * (i + 1),
                                          gyro_noise=1e-3, acc_noise=1e-2,
                                          seed=i)
        n = len(gyro)
        pres_j.append(jpre.preintegrate(
            jnp.asarray(gyro, jnp.float32), jnp.asarray(acc, jnp.float32),
            jnp.full((n,), 0.005, jnp.float32), jnp.ones(n, bool)))
    sys_ = System(None, SETTINGS, Sensor.IMU_MONOCULAR, device="cpu")
    # 7 keyframes; the 5 intervals end at keyframes 2..6
    sys_.kf_times = [0.1 * k for k in range(7)]
    sys_.kf_preints = [tpre.preintegrated_from_numpy(
        jax.tree_util.tree_map(np.asarray, p)) for p in pres_j]
    sys_.kf_velocities = {k: rng.normal(size=3) for k in range(7)}
    v5 = sys_.kf_velocities[5]
    remap = np.array([0, 1, 2, -1, 3, 4, 5] + [-1] * 249)  # cull keyframe 3
    sys_._remap_host_kf_state(remap, 7)
    assert len(sys_.kf_preints) == 4 and sys_.kf_times[3] == 0.4
    np.testing.assert_array_equal(sys_.kf_velocities[4], v5)
    assert 3 in sys_.kf_velocities and len(sys_.kf_velocities) == 6
    merged_j = jpre.merge(pres_j[1], pres_j[2])  # 2 -> 3 -> 4
    for k in tpre.Preintegrated._fields:
        ref = np.asarray(getattr(merged_j, k), np.float64)
        got = getattr(sys_.kf_preints[1], k).numpy().astype(np.float64)
        assert np.abs(got - ref).max() <= 1e-4 * max(np.abs(ref).max(),
                                                     1e-30), k
    for a, b in ((0, 0), (2, 3), (3, 4)):
        for x, y in zip(sys_.kf_preints[a],
                        tpre.preintegrated_from_numpy(
                            jax.tree_util.tree_map(np.asarray, pres_j[b]))):
            assert torch.equal(x, y)


@pytest.mark.slow
def test_port_inertial_gba_reconverges_perturbed_tail(jax_draws,
                                                      two_threads):
    """tests/test_vi_gba.py through the port: after a converged 70-frame
    VI session the trailing third of the keyframes is perturbed the way a
    pose-graph-only loop correction leaves them; `_run_inertial_gba`
    must recover most of the planted error."""
    from orb_slam3_ros2_tpu_torch.geom import lie

    images, R_gt, t_gt, ts, imu, _ = _mono_clip()
    sys_ = System(None, SETTINGS, Sensor.IMU_MONOCULAR, device="cpu")
    sys_.VI_INIT_KFS = 6
    t_prev = -1.0
    for k in range(70):
        sys_.track_monocular(images[k], float(ts[k]),
                             imu_points(imu, t_prev, float(ts[k])))
        t_prev = float(ts[k])
    assert sys_.get_tracking_state() == TrackingState.OK
    assert sys_.is_imu_initialized()

    def kf_ate():
        n_kf = int(sys_.map.n_kf)
        kR = sys_.map.kf_R[:n_kf].numpy()
        kt = sys_.map.kf_t[:n_kf].numpy()
        centres, gt = [], []
        for i in range(n_kf):
            k = int(np.argmin(np.abs(ts[:70] - sys_.kf_times[i])))
            centres.append(-kR[i].T @ kt[i])
            gt.append(-R_gt[k].T @ t_gt[k])
        return synthetic.ate_rmse(np.asarray(centres), np.asarray(gt))

    ate_clean = kf_ate()
    n_kf = int(sys_.map.n_kf)
    assert n_kf >= 9
    tail = np.arange(2 * n_kf // 3, n_kf)
    rng = np.random.default_rng(0)
    xi = np.zeros((n_kf, 6), np.float32)
    for j, k in enumerate(tail):
        mag = (j + 1) / len(tail)
        xi[k, :3] = 0.25 * mag * rng.standard_normal(3)
        xi[k, 3:] = 0.04 * mag * rng.standard_normal(3)
    R_p, t_p = lie.se3_retract(sys_.map.kf_R[:n_kf], sys_.map.kf_t[:n_kf],
                               torch.from_numpy(xi))
    kf_R, kf_t = sys_.map.kf_R.clone(), sys_.map.kf_t.clone()
    kf_R[:n_kf], kf_t[:n_kf] = R_p, t_p
    sys_.map = sys_.map._replace(kf_R=kf_R, kf_t=kf_t)
    ate_pert = kf_ate()
    assert ate_pert > 2.0 * ate_clean, (ate_pert, ate_clean)
    sys_._run_inertial_gba()
    ate_gba = kf_ate()
    assert ate_gba < 0.5 * ate_pert, (ate_gba, ate_pert)
    assert ate_gba < 1.3 * ate_clean, (ate_gba, ate_clean)
    assert sys_.v_cur is not None and np.isfinite(sys_.v_cur).all()


def test_interval_preintegration_counts_dropped_samples():
    """An interval integrates at most 4 * _pre_cap samples, as the JAX
    System's fixed batch does (`_finish_kf_preint`): 200 samples at 200 Hz
    over a 1 s keyframe gap at 20 fps keep the first 160, and the System
    counts the 40 it drops. The interval equals the JAX preintegration of
    the kept samples (the JAX batch's masked tail changes nothing), to
    1e-4 of each field's size."""
    st = os.path.join(os.path.dirname(__file__), "..", "config",
                      "Monocular-Inertial", "EuRoC.yaml")
    sys_ = System(None, st, Sensor.IMU_MONOCULAR, device="cpu")
    assert sys_._pre_cap == 40
    rng = np.random.default_rng(0)
    t = 0.005 * np.arange(1, 201)
    gyro = rng.normal(0, 0.2, (200, 3))
    acc = rng.normal(0, 0.5, (200, 3)) + [0.0, 0.0, 9.81]
    sys_.kf_times = [0.0, 1.0]
    sys_._kf_imu_buf = [ImuPoint(a, g, ti) for a, g, ti in zip(acc, gyro, t)]
    sys_._finish_kf_preint(1.0)
    assert sys_.dropped_imu_samples == 40 and sys_._kf_imu_buf == []
    pre = sys_.kf_preints[-1]
    assert abs(float(pre.dt) - 0.8) < 1e-5
    n = 160
    dts = np.full(n, 0.005, np.float32)
    pj = jpre.preintegrate(jnp.asarray(gyro[:n], jnp.float32),
                           jnp.asarray(acc[:n], jnp.float32),
                           jnp.asarray(dts), jnp.ones(n, bool),
                           noise_gyro=sys_.settings.noise_gyro,
                           noise_acc=sys_.settings.noise_acc)
    for k in tpre.Preintegrated._fields:
        ref = np.asarray(getattr(pj, k), np.float64)
        got = getattr(pre, k).numpy().astype(np.float64)
        assert np.abs(got - ref).max() <= 1e-4 * max(np.abs(ref).max(),
                                                     1e-30), k
