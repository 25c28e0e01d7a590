"""The port's joint visual-inertial BA (`backend/vi_ba.py`) against the JAX
package on the same inputs: the inertial residuals and their forward-mode
Jacobians (at a zero tangent with a non-identity body-from-camera
extrinsic, and at a converged, near-identity state, where `so3_log` is
differentiated at its small-angle branch), the whole solve on the fixture
of `tests/test_vi_ba.py:14`, and the equivalence with visual BA when the
IMU carries no information (`tests/test_vi_ba.py:75`).

The whitened residuals are Σ^-1/2 r with whitening entries up to ~6.5e3:
the raw residuals are differences of O(1) quantities rounded in float32
(~6e-8), so the residual comparison is absolute, 1e-6 of the largest
whitening entry (~15 float32 roundings of the raw residual). Jacobians and
the BA's outputs: 1e-4 of the largest magnitude, as in
`tests/test_torch_imu.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.backend import ba as jba
from orb_slam3_ros2_tpu.backend import vi_ba as jvba
from orb_slam3_ros2_tpu.geom import lie as jlie
from orb_slam3_ros2_tpu.imu import preintegration as jpre
from orb_slam3_ros2_tpu.io import synthetic as jsyn
from orb_slam3_ros2_tpu_torch.backend import ba as tba
from orb_slam3_ros2_tpu_torch.backend import vi_ba as tvba
from orb_slam3_ros2_tpu_torch.imu import preintegration as tpre

REL = 1e-4


def _close(got, ref, rel=REL, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: |diff| {err:.3g} > {rel} x {scale:.3g}"


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _fixture(K=6, seed=11, n_points=120, imu_rate=200.0, noise=None):
    """tests/test_vi_ba.py's problem: a scene of K keyframes at 2 fps, the
    IMU along the analytic trajectory with a gyro bias, perturbed poses,
    points and velocities. Returns the JAX and the port's inputs."""
    sc = jsyn.make_scene(n_frames=K, n_points=n_points, noise_px=0.3,
                         seed=seed, fps=2.0)
    traj = jsyn.default_trajectory(seed=seed + 1)
    ts = sc.timestamps
    true_bg = np.array([0.015, -0.01, 0.02])
    pres = []
    for i in range(K - 1):
        if noise is None:
            _, gyro, acc = jsyn.make_imu(traj, ts[i], ts[i + 1],
                                         rate=imu_rate, gyro_bias=true_bg,
                                         gyro_noise=1e-4, acc_noise=1e-3,
                                         seed=i)
        else:
            _, gyro, acc = jsyn.make_imu(traj, ts[i], ts[i + 1],
                                         rate=imu_rate)
        n = len(gyro)
        kw = {} if noise is None else dict(noise_gyro=noise[0],
                                           noise_acc=noise[1])
        pres.append(jpre.preintegrate(
            jnp.asarray(gyro, jnp.float32), jnp.asarray(acc, jnp.float32),
            jnp.full((n,), 1.0 / imu_rate, jnp.float32), jnp.ones(n, bool),
            **kw))
    pj = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *pres)
    pt = tpre.preintegrated_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                              pj))
    h = 1e-4
    v_gt = np.stack([(traj.position(t + h) - traj.position(t - h)) / (2 * h)
                     for t in ts])
    return sc, pj, pt, v_gt, true_bg


def _problem(sc, rng, pose_sigma, X_sigma, n_fixed):
    xi = rng.normal(0, pose_sigma, (sc.R_cw.shape[0], 6)).astype(np.float32)
    xi[:n_fixed] = 0.0
    R0, t0 = jlie.se3_retract(jnp.asarray(sc.R_cw), jnp.asarray(sc.t_cw),
                              jnp.asarray(xi))
    X0 = (sc.X + rng.normal(0, X_sigma, sc.X.shape)).astype(np.float32)
    fixed = np.zeros(sc.R_cw.shape[0], bool)
    fixed[:n_fixed] = True
    arrays = dict(R=np.asarray(R0), t=np.asarray(t0), X=X0, uv=sc.uv,
                  w=sc.vis.astype(np.float32), fixed=fixed,
                  point_valid=np.ones(sc.X.shape[0], bool))
    pj = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
    pt = tba.BAProblem(**{k: torch.from_numpy(np.array(v))
                          for k, v in arrays.items()})
    return pj, pt


def _whiteners(pj):
    info = jax.vmap(jpre.information)(pj)
    L = jnp.linalg.cholesky(0.5 * (info + jnp.swapaxes(info, -1, -2))
                            + 1e-6 * jnp.eye(9)[None])
    return jnp.swapaxes(L, -1, -2)


def _extrinsic():
    """A body-from-camera extrinsic like `IMU.T_b_c1` of the published
    EuRoC file: ~90 deg about z and a few cm."""
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.03, 1.55],
                                            jnp.float32)))
    return R, np.array([-0.0216, -0.0647, 0.0098], np.float32)


def _terms_both(pj, pt, R, t, v, bg, ba, thg, R_bc, t_bc):
    Wj = _whiteners(pj)
    Wt = tvba._whiteners(pt)
    _close(Wt.numpy(), Wj, REL, "whitener")
    rj, Jj = jvba._inertial_terms(pj, *map(jnp.asarray, (R, t, v, bg, ba, thg)),
                                  Wj, jnp.asarray(R_bc), jnp.asarray(t_bc))
    rt, Jt = tvba._inertial_terms(pt, *map(_t, (R, t, v, bg, ba, thg)), Wt,
                                  _t(R_bc), _t(t_bc))
    return (np.asarray(rj), np.asarray(Jj), rt.numpy(), Jt.numpy(),
            float(np.abs(np.asarray(Wj)).max()))


def test_inertial_terms_at_a_zero_tangent():
    """Residuals and Jacobians at a perturbed state, the extrinsic not the
    identity and the gravity tangent non-zero."""
    sc, pj, pt, v_gt, _ = _fixture()
    rng = np.random.default_rng(0)
    p, _ = _problem(sc, rng, 0.015, 0.04, 1)
    v = (v_gt + rng.normal(0, 0.1, v_gt.shape)).astype(np.float32)
    R_bc, t_bc = _extrinsic()
    rj, Jj, rt, Jt, w = _terms_both(
        pj, pt, np.asarray(p.R), np.asarray(p.t), v,
        np.array([0.01, 0.0, 0.01]), np.array([0.02, 0.01, 0.0]),
        np.array([0.01, -0.02]), R_bc, t_bc)
    assert Jt.shape == (5, 9, tvba.N_TAN) and np.isfinite(Jt).all()
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-6 * w)
    _close(Jt, Jj, REL, "J")


def test_inertial_terms_at_a_converged_state():
    """At the JAX solve's optimum the rotation residuals sit near the
    identity: so3_log is differentiated at its small-angle branch. The
    Jacobians must be finite and equal JAX's."""
    sc, pj, pt, v_gt, _ = _fixture()
    rng = np.random.default_rng(0)
    p, _ = _problem(sc, rng, 0.015, 0.04, 1)
    v = (v_gt + rng.normal(0, 0.1, v_gt.shape)).astype(np.float32)
    out = jvba.vi_bundle_adjust(p, pj, jnp.asarray(v), jnp.zeros(3),
                                jnp.zeros(3), sc.fx, sc.fy, sc.cx, sc.cy,
                                n_iters=10, prior_bg=1e1, prior_ba=1e0)
    rj, Jj, rt, Jt, w = _terms_both(
        pj, pt, np.asarray(out.R), np.asarray(out.t), np.asarray(out.v),
        np.asarray(out.bg), np.asarray(out.ba), np.asarray(out.thg),
        np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    # near the identity: every rotation residual under 1e-3 rad whitened
    assert np.abs(rj[:, :3]).max() < 1.0
    assert np.isfinite(Jt).all()
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-6 * w)
    _close(Jt, Jj, REL, "J")


@pytest.mark.parametrize("n_inertial,opt_gravity", [(None, True), (3, False)],
                         ids=["full", "anchored_window"])
def test_vi_bundle_adjust_matches_jax(n_inertial, opt_gravity):
    """The solve on tests/test_vi_ba.py's fixture, as there (10 iterations,
    bias priors 1e1 / 1e0), and as the local window runs it: the last two
    keyframes fixed visual-only anchors, gravity pinned."""
    sc, pj, pt, v_gt, true_bg = _fixture()
    rng = np.random.default_rng(0)
    p_j, p_t = _problem(sc, rng, 0.015, 0.04, 1)
    if n_inertial is not None:
        anchors = np.arange(sc.R_cw.shape[0]) > n_inertial
        p_j = p_j._replace(fixed=p_j.fixed | jnp.asarray(anchors))
        p_t = p_t._replace(fixed=p_t.fixed | torch.from_numpy(anchors))
    v = (v_gt + rng.normal(0, 0.1, v_gt.shape)).astype(np.float32)
    kw = dict(n_iters=10, prior_bg=1e1, prior_ba=1e0, opt_gravity=opt_gravity,
              n_inertial=n_inertial)
    oj = jvba.vi_bundle_adjust(p_j, pj, jnp.asarray(v), jnp.zeros(3),
                               jnp.zeros(3), sc.fx, sc.fy, sc.cx, sc.cy, **kw)
    ot = tvba.vi_bundle_adjust(p_t, pt, _t(v), torch.zeros(3),
                               torch.zeros(3), sc.fx, sc.fy, sc.cx, sc.cy,
                               **kw)
    for k in ("R", "t", "X", "v", "bg", "cost"):
        _close(getattr(ot, k).numpy(), getattr(oj, k), REL, k)
    # the gravity tangent is a small angle (5.6e-3 rad; ~1e-11 when
    # pinned) read off O(1) rotation entries: absolute, 1e-5 rad
    np.testing.assert_allclose(ot.thg.numpy(), np.asarray(oj.thg), rtol=0,
                               atol=1e-5)
    # ba is the weakest state (prior 1e0, a 2.5 s window): rounding in the
    # solve moves it by up to ~4e-4 of its size, 2e-5 m/s², a thousandth
    # of the accelerometer's per-sample noise here
    _close(ot.ba.numpy(), oj.ba, 1e-3, "ba")
    if n_inertial is None:
        # the JAX test's own bars hold for the port
        assert np.linalg.norm(ot.t.numpy() - sc.t_cw, axis=-1).mean() < 2e-2
        assert np.linalg.norm(ot.v.numpy() - v_gt, axis=-1).mean() < 5e-2
        np.testing.assert_allclose(ot.bg.numpy(), true_bg, atol=4e-3)


def test_vi_ba_pure_visual_equivalence_when_imu_weightless():
    """With near-zero IMU information the port's VI BA matches the port's
    visual BA (tests/test_vi_ba.py:75)."""
    sc, pj, pt, _, _ = _fixture(K=5, seed=12, n_points=100, imu_rate=50.0,
                                noise=(10.0, 100.0))
    rng = np.random.default_rng(1)
    _, p = _problem(sc, rng, 0.01, 0.03, 2)
    out_vi = tvba.vi_bundle_adjust(p, pt, torch.zeros((5, 3)), torch.zeros(3),
                                   torch.zeros(3), sc.fx, sc.fy, sc.cx, sc.cy,
                                   n_iters=8)
    out_v = tba.bundle_adjust(p, sc.fx, sc.fy, sc.cx, sc.cy, n_iters=8,
                              reclassify_every=1000)
    err_vi = np.linalg.norm(out_vi.t.numpy() - sc.t_cw, axis=-1).mean()
    err_v = np.linalg.norm(out_v.t.numpy() - sc.t_cw, axis=-1).mean()
    assert abs(err_vi - err_v) < 3e-3, (err_vi, err_v)
