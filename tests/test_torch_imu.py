"""The port's IMU modules against the JAX package on the same inputs:
preintegration (`imu/preintegration.py`), the VI initializer
(`imu/vi_init.py`) and the Madgwick filter (`imu/madgwick.py`).

Inputs are made from a seed with numpy (`io/synthetic.make_imu` along the
JAX tests' analytic trajectories) and go through both packages in float32.
Tolerances are stated per comparison. Unless a line says otherwise they are
1e-4 of the largest magnitude of the compared quantity (the float32
rounding of a 200-step recursion, summed in another order by torch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.geom import lie as jlie
from orb_slam3_ros2_tpu.imu import madgwick as jmad
from orb_slam3_ros2_tpu.imu import preintegration as jpre
from orb_slam3_ros2_tpu.imu import vi_init as jvii
from orb_slam3_ros2_tpu.io import synthetic as jsyn
from orb_slam3_ros2_tpu_torch.imu import madgwick as tmad
from orb_slam3_ros2_tpu_torch.imu import preintegration as tpre
from orb_slam3_ros2_tpu_torch.imu import vi_init as tvii
from orb_slam3_ros2_tpu_torch.io import synthetic as tsyn

REL = 1e-4


def _close(got, ref, rel=REL, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: |diff| {err:.3g} > {rel} x {scale:.3g}"


def _samples(traj_seed, t0, t1, rate=200.0, **kw):
    traj = tsyn.default_trajectory(seed=traj_seed)
    t, gyro, acc = tsyn.make_imu(traj, t0, t1, rate=rate, **kw)
    return (gyro.astype(np.float32), acc.astype(np.float32),
            np.full(t.shape, 1.0 / rate, np.float32))


def _both(fn_j, fn_t, *arrays):
    """Call the JAX and the torch function on the same numpy arrays."""
    return (fn_j(*(jnp.asarray(a) for a in arrays)),
            fn_t(*(torch.from_numpy(np.asarray(a)) for a in arrays)))


def _pre_close(pj, pt, rel=REL):
    for k in tpre.Preintegrated._fields:
        _close(getattr(pt, k).numpy(), getattr(pj, k), rel, k)


def test_make_imu_is_the_jax_synthesis():
    """The copied sampler gives the JAX one's samples bit for bit."""
    traj = jsyn.default_trajectory(seed=5)
    kw = dict(rate=200.0, gyro_noise=2e-3, acc_noise=2e-2,
              gyro_bias=np.array([0.01, -0.02, 0.0]), gyro_walk=1.9e-5,
              acc_walk=3e-3, seed=4)
    for a, b in zip(jsyn.make_imu(traj, 0.1, 0.9, **kw),
                    tsyn.make_imu(tsyn.default_trajectory(seed=5), 0.1, 0.9,
                                  **kw)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jsyn.GRAVITY, tsyn.GRAVITY)


@pytest.mark.parametrize("masked_from", [None, 50])
def test_preintegrate_matches_jax(masked_from):
    """preintegrate at non-zero linearization biases, over a full batch
    and with the tail masked off: every field, the bias Jacobians
    (JRg, Jvg, Jva, Jpg, Jpa) and the covariance included."""
    gyro, acc, dts = _samples(5, 0.3, 0.8, gyro_noise=1e-3, acc_noise=1e-2,
                              seed=1)
    mask = np.ones(len(dts), bool)
    if masked_from is not None:
        mask[masked_from:] = False
    bg = np.array([0.01, -0.02, 0.005], np.float32)
    ba = np.array([0.05, 0.01, -0.03], np.float32)
    pj, pt = _both(lambda *a: jpre.preintegrate(*a, noise_gyro=1.7e-4,
                                                noise_acc=2e-3),
                   lambda *a: tpre.preintegrate(*a, noise_gyro=1.7e-4,
                                                noise_acc=2e-3),
                   gyro, acc, dts, mask, bg, ba)
    _pre_close(pj, pt)
    if masked_from is not None:
        # the mask stops integration exactly (tests/test_imu.py:41)
        short = tpre.preintegrate(*(torch.from_numpy(a[:masked_from])
                                    for a in (gyro, acc, dts, mask)),
                                  torch.from_numpy(bg), torch.from_numpy(ba))
        for a, b in zip(short, pt):
            assert torch.equal(a, b)


def test_integrate_continues_a_state():
    """integrate into a non-empty interval (the JAX scan carry)."""
    g1, a1, d1 = _samples(6, 0.0, 0.25, seed=2)
    g2, a2, d2 = _samples(6, 0.25, 0.5, seed=3)
    m1, m2 = np.ones(len(d1), bool), np.ones(len(d2), bool)
    pj = jpre.integrate(jpre.preintegrate(*map(jnp.asarray, (g1, a1, d1, m1))),
                        *map(jnp.asarray, (g2, a2, d2, m2)))
    pt = tpre.integrate(
        tpre.preintegrate(*map(torch.from_numpy, (g1, a1, d1, m1))),
        *map(torch.from_numpy, (g2, a2, d2, m2)))
    _pre_close(pj, pt)


def _two_intervals():
    out = []
    for seed, (t0, t1) in ((2, (0.0, 0.3)), (3, (0.3, 0.55))):
        g, a, d = _samples(7, t0, t1, gyro_noise=1e-3, acc_noise=1e-2,
                           seed=seed)
        m = np.ones(len(d), bool)
        bg = np.array([0.004, -0.003, 0.002], np.float32)
        pj = jpre.preintegrate(*map(jnp.asarray, (g, a, d, m)),
                               bg=jnp.asarray(bg))
        out.append((pj, tpre.preintegrated_from_numpy(
            jax.tree_util.tree_map(np.asarray, pj))))
    return out


def test_preintegrated_from_numpy_carries_every_field():
    (pj, pt), _ = _two_intervals()
    for k in tpre.Preintegrated._fields:
        np.testing.assert_array_equal(getattr(pt, k).numpy(),
                                      np.asarray(getattr(pj, k)))
        assert getattr(pt, k).dtype == torch.float32
    back = tpre.to_numpy(pt)
    np.testing.assert_array_equal(back["cov"], np.asarray(pj.cov))


def test_merge_matches_jax():
    (pj1, pt1), (pj2, pt2) = _two_intervals()
    _pre_close(jpre.merge(pj1, pj2), tpre.merge(pt1, pt2))
    # stacked: merge is batched in the port
    st = tpre.merge(tpre.stack([pt1, pt1]), tpre.stack([pt2, pt2]))
    _pre_close(jpre.merge(pj1, pj2), tpre.index(st, 1))


def test_bias_corrected_residual_information_match_jax():
    (pj, pt), _ = _two_intervals()
    bg = np.array([0.01, -0.005, 0.0], np.float32)
    ba = np.array([0.03, -0.02, 0.04], np.float32)
    for a, b, k in zip(jpre.bias_corrected(pj, jnp.asarray(bg),
                                           jnp.asarray(ba)),
                       tpre.bias_corrected(pt, torch.from_numpy(bg),
                                           torch.from_numpy(ba)),
                       ("dR", "dv", "dp")):
        _close(b.numpy(), a, REL, k)
    rng = np.random.default_rng(0)
    Ri, Rj = (np.array(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.3, 3),
                                                  jnp.float32)))
              for _ in range(2))
    pi, pj_, vi, vj = (rng.normal(0, 1.0, 3).astype(np.float32)
                       for _ in range(4))
    g_w = np.array([0.1, -0.2, -9.8], np.float32)
    args = (Ri, pi, vi, Rj, pj_, vj, bg, ba)
    rj = jpre.residual(pj, *map(jnp.asarray, args), scale=1.3,
                       g_w=jnp.asarray(g_w))
    rt = tpre.residual(pt, *map(torch.from_numpy, args), scale=1.3,
                       g_w=torch.from_numpy(g_w))
    _close(rt.numpy(), rj, REL, "residual")
    # information = (cov + 1e-8 I)^-1 of a covariance near 1e-9: the
    # inverse of the regularized matrix, to 1e-4 of its largest entry
    _close(tpre.information(pt).numpy(), jpre.information(pj), REL, "info")


def _vi_window(seed=9, K=10, true_scale=2.5, phi_w=(0.12, -0.2, 0.0)):
    """The window of tests/test_imu.py:109: ten keyframes 0.5 s apart, a
    gyro bias, the visual positions shrunk by the scale and the world
    rotated off gravity."""
    traj = jsyn.default_trajectory(seed=seed)
    kf_times = np.arange(K) * 0.5 + 0.1
    true_bg = np.array([0.02, -0.01, 0.015])
    pres = []
    for i in range(K - 1):
        _, gyro, acc = jsyn.make_imu(traj, kf_times[i], kf_times[i + 1],
                                     rate=200.0, gyro_bias=true_bg,
                                     gyro_noise=1e-4, acc_noise=1e-3, seed=i)
        n = len(gyro)
        pres.append(jpre.preintegrate(
            jnp.asarray(gyro, jnp.float32), jnp.asarray(acc, jnp.float32),
            jnp.full((n,), 1.0 / 200.0, jnp.float32), jnp.ones(n, bool)))
    pj = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *pres)
    R_pert = np.asarray(jlie.so3_exp(jnp.asarray(phi_w, jnp.float32)))
    R_wb, p_wb = traj.pose_wb(kf_times)
    R_vis = np.einsum("ij,kjl->kil", R_pert.T, R_wb).astype(np.float32)
    p_vis = (np.einsum("ij,kj->ki", R_pert.T, p_wb)
             / true_scale).astype(np.float32)
    pt = tpre.preintegrated_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                              pj))
    return pj, pt, R_vis, p_vis


@pytest.mark.parametrize("kw", [
    dict(), dict(fix_scale=True),
    dict(prior_bg=1e4, prior_ba=1e10, bg_center=(0.02, -0.01, 0.015))],
    ids=["mono", "fixed_scale", "refinement"])
def test_vi_init_matches_jax(kw):
    """vi_init on the window of tests/test_imu.py:109 (the monocular
    initialization, the stereo one with the scale pinned, and the scale
    refinement's priors): scale, gravity rotation, velocities, biases,
    cost and the scale's posterior variance."""
    pj, pt, R_vis, p_vis = _vi_window()
    kw_j, kw_t = dict(kw), dict(kw)
    if "bg_center" in kw:
        kw_j["bg_center"] = jnp.asarray(kw["bg_center"], jnp.float32)
        kw_t["bg_center"] = torch.tensor(kw["bg_center"])
    oj = jvii.vi_init(pj, jnp.asarray(R_vis), jnp.asarray(p_vis), **kw_j)
    ot = tvii.vi_init(pt, torch.from_numpy(R_vis), torch.from_numpy(p_vis),
                      **kw_t)
    for k in ("scale", "R_wg", "v", "bg", "cost", "scale_var"):
        _close(getattr(ot, k).numpy(), getattr(oj, k), REL, k)
    # ba sits at ~1e-8 under its 1e10 prior: absolute, 1e-4 of the bias
    # scale (0.01)
    np.testing.assert_allclose(ot.ba.numpy(), np.asarray(oj.ba), atol=1e-6)
    if not kw.get("fix_scale"):
        assert abs(float(ot.scale) - 2.5) / 2.5 < 0.03


def _madgwick_inputs(n=120, seed=1):
    rng = np.random.default_rng(seed)
    gyro = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    acc = (np.array([0.0, 0.0, 1.0])
           + rng.normal(size=(n, 3)) * 0.02).astype(np.float32)
    return gyro, acc, np.arange(n) * 0.005


@pytest.mark.parametrize("beta,masked", [(0.1, False), (0.5, True)])
def test_madgwick_filter_matches_jax(beta, masked):
    gyro, acc, _ = _madgwick_inputs()
    n = len(gyro)
    dts = np.full((n,), 0.005, np.float32)
    mask = np.ones(n, bool)
    if masked:
        mask[40:70] = False
    q0 = np.array(jmad.quat_from_accel(jnp.asarray(acc[0])))
    qj = jmad.madgwick_filter(jnp.asarray(gyro), jnp.asarray(acc),
                              jnp.asarray(dts), jnp.asarray(q0),
                              jnp.float32(beta), mask=jnp.asarray(mask))
    qt = tmad.madgwick_filter(torch.from_numpy(gyro), torch.from_numpy(acc),
                              torch.from_numpy(dts), torch.from_numpy(q0),
                              torch.tensor(beta), mask=torch.from_numpy(mask))
    # unit quaternions after 120 normalized steps: 1e-5 absolute
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-5)
    np.testing.assert_allclose(
        tmad.quat_to_rotmat(qt[-1]).numpy(),
        np.asarray(jmad.quat_to_rotmat(qj[-1])), atol=1e-5)


def test_madgwick_streaming_matches_jax(monkeypatch):
    """The streaming wrappers, fed the same four windows (the port's on
    the CPU; its default device is the card, and without one it
    raises)."""
    gyro, acc, t = _madgwick_inputs()
    fj = jmad.MadgwickFilter(beta=0.1)
    ft = tmad.MadgwickFilter(beta=0.1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tmad.MadgwickFilter(beta=0.1)
    for i in range(0, len(t), 30):
        sl = slice(i, i + 30)
        qj = fj.update(gyro[sl], acc[sl], t[sl])
        qt = ft.update(gyro[sl], acc[sl], t[sl])
        np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-5)
    np.testing.assert_allclose(ft.rotation.numpy(), np.asarray(fj.rotation),
                               atol=1e-5)


def test_quat_helpers_match_jax():
    rng = np.random.default_rng(2)
    p, q = (rng.normal(size=(5, 4)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        tmad.quat_mul(torch.from_numpy(p), torch.from_numpy(q)).numpy(),
        np.asarray(jmad.quat_mul(jnp.asarray(p), jnp.asarray(q))),
        rtol=1e-6, atol=1e-6)
    for acc in ([0.3, -0.2, 9.7], [0.0, 0.0, -9.81], [0.0, 0.0, 0.0]):
        a = np.asarray(acc, np.float32)
        np.testing.assert_allclose(
            tmad.quat_from_accel(torch.from_numpy(a)).numpy(),
            np.asarray(jmad.quat_from_accel(jnp.asarray(a))), atol=1e-6)
