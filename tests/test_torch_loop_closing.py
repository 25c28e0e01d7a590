"""Loop closing in the port (`loop/sim3.py`, `loop/pose_graph.py`,
`loop/closing.py`, `System._try_close_loop`) against the JAX modules, and
port copies of the four cases of `tests/test_loop_closing_e2e.py`.

Tolerances: the Sim3 solve on JAX's RANSAC samples: R, t and s within
1e-4, the inlier set exact; edge residuals and Jacobians within 1e-5;
the pose graph's poses within 1e-4 on a consistent graph; the essential
graph's edge lists exact; `close_loop` on the same map and candidate:
keyframe poses and landmarks within 1e-3 (twelve f32 LM solves of a
(7B)² system with 1e12 gauge priors, summed in another order)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.atlas import map_state as jms
from orb_slam3_ros2_tpu.geom import lie as jlie
from orb_slam3_ros2_tpu.loop import closing as jclosing
from orb_slam3_ros2_tpu.loop import pose_graph as jpg
from orb_slam3_ros2_tpu.loop import sim3 as jsim3
from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
from orb_slam3_ros2_tpu_torch.frontend import tracking as trk
from orb_slam3_ros2_tpu_torch.geom import lie
from orb_slam3_ros2_tpu_torch.loop import closing
from orb_slam3_ros2_tpu_torch.loop import pose_graph as pg
from orb_slam3_ros2_tpu_torch.loop import sim3
from orb_slam3_ros2_tpu_torch.runtime.system import Sensor, System
from orb_slam3_ros2_tpu_torch.tools import system_run

SETTINGS = os.path.join(os.path.dirname(__file__), "data", "synth_cam.yaml")


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_samples(key, mask):
    """The (N_HYPO, 3) indices `jsim3.solve_sim3` draws from `key`."""
    logits = jnp.where(jnp.asarray(mask), 0.0, -1e9)
    keys = jax.random.split(key, jsim3.N_HYPO)
    return np.array(jax.vmap(
        lambda k: jax.random.categorical(k, logits, shape=(3,)))(keys))


def _sim3_case(seed, n=120, outliers=0.3, noise=0.01):
    rng = np.random.default_rng(seed)
    X2 = (rng.normal(0, 2, (n, 3)) + [0, 0, 5]).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.4, 3))))
    t = rng.normal(0, 1, 3)
    s = 1.7
    X1 = (s * X2 @ R.T + t + rng.normal(0, noise, (n, 3))).astype(np.float32)
    bad = rng.random(n) < outliers
    X1[bad] += rng.normal(0, 2, (bad.sum(), 3)).astype(np.float32)
    mask = rng.random(n) < 0.9
    return X1, X2, mask, (R, t, s)


@pytest.mark.parametrize("seed,fix_scale", [(0, False), (1, False),
                                            (2, True)])
def test_solve_sim3_on_jax_samples(seed, fix_scale):
    X1, X2, mask, _ = _sim3_case(seed)
    key = jax.random.PRNGKey(seed + 10)
    ref = jsim3.solve_sim3(key, jnp.asarray(X1), jnp.asarray(X2),
                           jnp.asarray(mask), fix_scale=fix_scale)
    got = sim3.solve_sim3_from_samples(
        _t(jax_samples(key, mask)), _t(X1), _t(X2), _t(mask),
        fix_scale=fix_scale)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)
    assert abs(float(got.s) - float(ref.s)) <= 1e-4
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers)
    assert bool(got.ok) == bool(ref.ok)


def test_solve_sim3_own_draw_recovers_the_transform():
    X1, X2, mask, (R, t, s) = _sim3_case(3)
    gen = torch.Generator().manual_seed(5)
    got = sim3.solve_sim3(gen, _t(X1), _t(X2), _t(mask))
    assert bool(got.ok) and got.n_inliers.dtype == torch.int32
    np.testing.assert_allclose(got.R.numpy(), R, atol=2e-2)
    assert abs(float(got.s) - s) < 2e-2
    idx = sim3.sample_triples(torch.Generator().manual_seed(1), _t(mask))
    assert idx.shape == (sim3.N_HYPO, 3) and mask[idx.numpy()].all()


def _graph(seed, K=8, noise=0.02):
    """A chain of K Sim3 poses with covisibility and loop edges measured
    from the true poses plus noise."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 0.3, (K, 7)).astype(np.float32)
    xi[:, 6] *= 0.2
    R, t, s = (np.asarray(a) for a in jlie.sim3_exp(jnp.asarray(xi)))
    ei = np.array(list(range(1, K)) + [5, 7, 6], np.int32)
    ej = np.array(list(range(0, K - 1)) + [2, 1, 0], np.int32)
    Rm, tm, sm = jlie.sim3_compose(
        *(jnp.asarray(a[ei]) for a in (R, t, s)),
        *jlie.sim3_inverse(*(jnp.asarray(a[ej]) for a in (R, t, s))))
    dR, dt, ds = jlie.sim3_exp(jnp.asarray(
        rng.normal(0, noise, (len(ei), 7)).astype(np.float32)))
    Rm, tm, sm = (np.asarray(a) for a in jlie.sim3_compose(dR, dt, ds, Rm,
                                                           tm, sm))
    # start from perturbed poses
    dR, dt, ds = jlie.sim3_exp(jnp.asarray(
        rng.normal(0, 0.05, (K, 7)).astype(np.float32)))
    R0, t0, s0 = (np.asarray(a) for a in jlie.sim3_compose(
        dR, dt, ds, jnp.asarray(R), jnp.asarray(t), jnp.asarray(s)))
    return R0, t0, s0, ei, ej, Rm, tm, sm


def test_edge_terms_and_sim3_lie_match_jax():
    R, t, s, ei, ej, Rm, tm, sm = _graph(0, noise=0.2)
    got = pg.edge_terms(*(_t(a) for a in (R, t, s, ei, ej, Rm, tm, sm)))
    ref = jax.jit(jpg.edge_terms)(*(jnp.asarray(a) for a in (
        R, t, s, ei, ej, Rm, tm, sm)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    xi = np.random.default_rng(1).normal(0, 0.5, (6, 7)).astype(np.float32)
    xi[0] = 0.0  # the small-angle and small-scale branches
    for a, b in zip(lie.sim3_exp(_t(xi)), jlie.sim3_exp(jnp.asarray(xi))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_allclose(
        lie.sim3_log(_t(R), _t(t), _t(s)).numpy(),
        np.asarray(jlie.sim3_log(jnp.asarray(R), jnp.asarray(t),
                                 jnp.asarray(s))), atol=1e-5)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_pose_graph_matches_jax(fix_scale):
    R, t, s, ei, ej, Rm, tm, sm = _graph(2)
    K = R.shape[0]
    valid = np.ones(len(ei), bool)
    valid[-1] = False  # one unused edge slot
    fixed = np.zeros(K, bool)
    fixed[0] = True
    w = np.ones(len(ei), np.float32)
    w[-2] = 7.0
    args = (R, t, s, ei, ej, Rm, tm, sm, valid, fixed)
    got = pg.optimize_pose_graph(*(_t(a) for a in args), edge_weight=_t(w),
                                 fix_scale=fix_scale)
    ref = jpg.optimize_pose_graph(*(jnp.asarray(a) for a in args),
                                  edge_weight=jnp.asarray(w),
                                  fix_scale=fix_scale)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    assert abs(float(got.cost) - float(ref.cost)) <= 1e-4 * max(
        1.0, float(ref.cost))
    assert float(got.cost) < float(pg.optimize_pose_graph(
        *(_t(a) for a in args), edge_weight=_t(w), n_iters=0).cost)


def test_essential_graph_edges_match_jax():
    rng = np.random.default_rng(0)
    C = rng.integers(0, 60, (16, 16))
    C = np.triu(C, 1) + np.triu(C, 1).T
    for n_kf, cap in ((12, None), (16, 8), (5, 2)):
        got = closing.essential_graph_edges(C, n_kf, max_covis_edges=cap)
        ref = jclosing.essential_graph_edges(C, n_kf, max_covis_edges=cap)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


# -------------------------------- the aliased corridor of the JAX e2e test

def _build_aliased_system(n_kf=18, aliased_kfs=(17,), seed=0):
    """The port copy of the JAX test's `_build_aliased_system`
    (`system_run.aliased_corridor`, which chip_smoke.py's phase 9b runs on
    the card)."""
    sys_ = System(None, SETTINGS, Sensor.MONOCULAR, device="cpu")
    return sys_, system_run.aliased_corridor(sys_, n_kf, aliased_kfs, seed)


def _centre(m, k):
    return -m.kf_R[k].numpy().T @ m.kf_t[k].numpy()


def test_single_shot_accept_welds_aliased_rooms():
    sys_, feats = _build_aliased_system()
    sys_.LOOP_CONSISTENCY_TH = 1
    sys_._try_close_loop(17, feats[17])
    assert sys_.n_loops_closed == 1  # wrongly welded
    assert np.linalg.norm(_centre(sys_.map, 17) - _centre(sys_.map, 2)) < 4.0


def test_temporal_consistency_rejects_single_aliased_hit():
    sys_, feats = _build_aliased_system()
    assert sys_.LOOP_CONSISTENCY_TH >= 2
    sys_._try_close_loop(17, feats[17])
    assert sys_.n_loops_closed == 0
    assert len(sys_._loop_consistency) >= 1


def test_consistent_redetection_closes_loop():
    """Through `system_run.run_corridor_loop` (chip_smoke.py's phase 9b):
    keyframe 17 starts the consistency, keyframe 18 closes the loop; the
    corrected map is finite and keyframe 18 lands in keyframe 2's room."""
    r, sys_ = system_run.run_corridor_loop("cpu")
    assert r["loops_closed_after"] == [0, 1]
    assert sys_.last_loop_kf == 18
    assert np.isfinite(sys_.map.kf_t.numpy()).all()
    assert np.isfinite(sys_.map.lm_X.numpy()).all()
    assert r["finite"]
    c = r["centres"]
    assert np.linalg.norm(np.subtract(c[18], c[2])) < 4.0


def test_loop_exclusion_skips_covisible_candidates():
    sys_, feats = _build_aliased_system()
    m = sys_.map
    obs = m.kf_obs_lm.clone()
    obs[17, 0] = obs[2, 0]  # kf 17 now shares a landmark with kf 2
    sys_.map = m._replace(kf_obs_lm=obs)
    sys_.LOOP_CONSISTENCY_TH = 1
    sys_._try_close_loop(17, feats[17])
    assert sys_.n_loops_closed == 0


def test_close_loop_matches_jax():
    """`matched_landmark_pairs`, the Sim3 verification on JAX's samples and
    `close_loop` on the JAX test's corridor map, against the JAX
    functions on the same map."""
    sys_, feats = _build_aliased_system()
    m = sys_.map
    mj = jms.MapState(**{k: jnp.asarray(v) for k, v in
                         ms.to_numpy(m).items()})
    pa, pb, mask = closing.matched_landmark_pairs(m, 17, 2)
    pa_j, pb_j, mask_j = jclosing.matched_landmark_pairs(mj, 17, 2)
    np.testing.assert_array_equal(mask, mask_j)
    np.testing.assert_array_equal(pa, pa_j)
    np.testing.assert_array_equal(pb, pb_j)
    assert mask.sum() >= 20
    key = jax.random.PRNGKey(3)
    cand_j = jclosing.detect_and_verify(mj, 17, 2, key)
    cand = closing.verify_from_samples(pa, pb, mask, jax_samples(key, mask),
                                       2, False, 20, "cpu")
    assert cand is not None and cand_j is not None
    np.testing.assert_allclose(cand.R, cand_j.R, atol=1e-4)
    np.testing.assert_allclose(cand.t, cand_j.t, atol=1e-4)
    assert abs(cand.s - cand_j.s) <= 1e-4
    assert cand.n_inliers == cand_j.n_inliers
    covis = ms.covisibility_matrix(m).numpy()
    got = closing.close_loop(m, 17, cand_j, covis=covis)
    ref = jclosing.close_loop(mj, 17, cand_j, covis=covis)
    n_kf = int(m.n_kf)
    for name in ("kf_R", "kf_t"):
        np.testing.assert_allclose(getattr(got, name).numpy()[:n_kf],
                                   np.asarray(getattr(ref, name))[:n_kf],
                                   atol=1e-3, err_msg=name)
    v = m.lm_valid.numpy()
    np.testing.assert_allclose(got.lm_X.numpy()[v], np.asarray(ref.lm_X)[v],
                               atol=1e-3)
    # the weld moved kf 17 onto kf 2's room
    assert np.linalg.norm(_centre(got, 17) - _centre(got, 2)) < 4.0


def test_global_ba_matches_the_live_window():
    """A BA over every keyframe slot (the JAX `global_ba`) and
    `System._run_global_ba` over the live keyframes padded to a power of 2
    (`tracking.global_ba_window`) give the same map."""
    sys_, _ = _build_aliased_system(n_kf=6)
    cam = sys_.cam
    m = sys_.map
    X = m.lm_X.clone()
    X[:, 2] += 0.05  # pull the landmarks off their observations
    sys_.map = m._replace(lm_X=X)
    ids = torch.arange(m.kf_valid.shape[0], dtype=torch.int32)
    ids_w, fix_w = trk.global_ba_window(6, m.kf_valid.shape[0], "cpu")
    assert ids_w.tolist() == [0, 1, 2, 3, 4, 5, 5, 5]
    assert fix_w.tolist() == [True] + [False] * 7
    full = trk.local_ba(sys_.map, ids, ids == 0, cam.fx, cam.fy, cam.cx,
                        cam.cy, n_iters=8)
    sys_._run_global_ba(n_iters=8)
    for name in ("kf_R", "kf_t", "lm_X"):
        np.testing.assert_allclose(getattr(sys_.map, name).numpy(),
                                   getattr(full, name).numpy(), atol=1e-4,
                                   err_msg=name)
    err0 = np.abs(X.numpy() - m.lm_X.numpy())[m.lm_valid.numpy()].max()
    err1 = np.abs(full.lm_X.numpy() - m.lm_X.numpy())[
        m.lm_valid.numpy()].max()
    assert err1 < err0


def test_loop_clip_matches_jax(tmp_path):
    """The port's copy of the synth_loopy clip (`render_room_sequence`
    along `_loop_trajectory`) renders the JAX package's frames exactly (at
    160x120 here), and `system_run.loopy_settings` gives the evaluation's
    camera with the loop-closing switch."""
    from orb_slam3_ros2_tpu.io import synthetic as jsynthetic
    from orb_slam3_ros2_tpu.runtime import bench_eval
    from orb_slam3_ros2_tpu_torch.io import settings as settings_mod
    from orb_slam3_ros2_tpu_torch.io import synthetic
    from orb_slam3_ros2_tpu_torch.tools import system_run

    ts = np.linspace(0.0, 28.0, 57)
    for a, b in zip(synthetic._loop_trajectory(280, 10.0).pose_wb(ts),
                    bench_eval._loop_trajectory(280, 10.0).pose_wb(ts)):
        np.testing.assert_array_equal(a, b)
    kw = dict(n_frames=3, width=160, height=120, fx=112.5, fy=112.5,
              fps=10.0, seed=3)
    got = synthetic.render_room_sequence(
        traj=synthetic._loop_trajectory(280, 10.0), **kw)
    ref = jsynthetic.render_room_sequence(
        traj=bench_eval._loop_trajectory(280, 10.0), **kw)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    for on in (True, False):
        path = tmp_path / f"loopy_{on}.yaml"
        path.write_text(system_run.loopy_settings(on))
        st = settings_mod.load_settings(str(path))
        assert st.loop_closing == on
        assert (st.camera.width, st.camera.height, st.camera.fx,
                st.n_features, st.n_levels) == (640, 480, 450.0, 1000, 8)
