"""Parity of the port's tracking slice with the JAX package on the CPU:
`match_to_map` / `track_frame` on identical features against a map carried
across with `map_state.from_numpy`, and `frame_step` from raw images against
the JAX System's own per-frame program.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_ros2_tpu.atlas import map_state as ms
from orb_slam3_ros2_tpu.frontend import extractor as ex
from orb_slam3_ros2_tpu.frontend import tracking as trk
from orb_slam3_ros2_tpu.io.synthetic import _texture, render_sequence
from orb_slam3_ros2_tpu_torch.atlas import map_state as tms
from orb_slam3_ros2_tpu_torch.frontend import extractor as tex
from orb_slam3_ros2_tpu_torch.frontend import tracking as ttrk
from orb_slam3_ros2_tpu_torch.models import cameras as tcam
from orb_slam3_ros2_tpu_torch.runtime import system as tsys

H, W = 240, 320
FX = FY = 260.0
CX, CY = W / 2.0, H / 2.0


def _to_np(x):
    return np.asarray(x)


def _map_np(m):
    return {k: _to_np(v) for k, v in m._asdict().items()}


@pytest.fixture(scope="module")
def setup():
    """JAX features of one image and a JAX map of their back-projections."""
    cfg = ex.ExtractorConfig(n_features=512, n_levels=4, height=H, width=W)
    feats = ex.make_extractor(cfg)(
        jnp.asarray(_texture(H, W, seed=5).astype(np.float32)))
    rng = np.random.default_rng(3)
    uv0 = np.array(feats.uv)
    valid = np.array(feats.mask)
    z = rng.uniform(3.0, 8.0, uv0.shape[0]).astype(np.float32)
    X = np.stack([(uv0[:, 0] - CX) / FX * z, (uv0[:, 1] - CY) / FY * z, z],
                 axis=-1).astype(np.float32)
    mcfg = ms.MapConfig(max_kf=8, max_lm=1024, n_feat=ex.total_capacity(cfg))
    L = min(int(valid.sum()), mcfg.max_lm)
    idx = np.flatnonzero(valid)[:L]
    m = ms.empty_map(mcfg)
    m = m._replace(
        lm_X=m.lm_X.at[:L].set(jnp.asarray(X[idx])),
        lm_valid=m.lm_valid.at[:L].set(True),
        lm_bits=m.lm_bits.at[:L].set(jnp.asarray(_to_np(feats.bits)[idx])),
    )
    tfeat = dict(uv=torch.from_numpy(uv0),
                 bits=torch.from_numpy(np.array(feats.bits).view(np.int32)),
                 mask=torch.from_numpy(valid),
                 level=torch.from_numpy(np.array(feats.level)))
    return m, feats, tms.from_numpy(_map_np(m)), tfeat


def test_from_numpy_carries_every_field(setup):
    m, _, tm, _ = setup
    for name in ms.MapState._fields:
        a = _to_np(getattr(m, name))
        b = getattr(tm, name).numpy()
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("t0", [(0.0, 0.0, 0.0), (0.05, -0.03, 0.02)])
def test_project_and_match_to_map(setup, t0):
    m, feats, tm, tf = setup
    R = np.eye(3, dtype=np.float32)
    t = np.asarray(t0, np.float32)
    uv_j, vis_j = trk.project_map(m, jnp.asarray(R), jnp.asarray(t), FX, FY,
                                  CX, CY, W, H)
    uv_t, vis_t = ttrk.project_map(tm, torch.from_numpy(R),
                                   torch.from_numpy(t), FX, FY, CX, CY, W, H)
    np.testing.assert_allclose(uv_t.numpy(), _to_np(uv_j), atol=1e-3)
    np.testing.assert_array_equal(vis_t.numpy(), _to_np(vis_j))
    for cap in (None, 256):
        got = ttrk.match_to_map(tm, tf["uv"], tf["bits"], tf["mask"],
                                torch.from_numpy(R), torch.from_numpy(t),
                                FX, FY, CX, CY, W, H, cap_visible=cap)
        ref = trk.match_to_map(m, feats.uv, feats.signs, feats.mask,
                               jnp.asarray(R), jnp.asarray(t), FX, FY, CX,
                               CY, W, H, cap_visible=cap)
        np.testing.assert_array_equal(got.obs_lm.numpy(), _to_np(ref.obs_lm))
        assert int(got.n_matches) == int(ref.n_matches) > 50
        np.testing.assert_array_equal(got.lm_found_inc.numpy(),
                                      _to_np(ref.lm_found_inc))
        np.testing.assert_array_equal(got.lm_visible_inc.numpy(),
                                      _to_np(ref.lm_visible_inc))


@pytest.mark.parametrize("perturb", [0.0, 0.02, 0.35])
def test_track_frame_matches_jax(setup, perturb):
    """Identical features and map: summary R atol 1e-4, t atol 1e-3, equal
    match and inlier counts (0.35 m forces the widened 30 px retry)."""
    m, feats, tm, tf = setup
    rng = np.random.default_rng(11)
    t0 = (rng.normal(0, perturb, 3) if perturb < 0.1
          else np.array([perturb, 0.0, 0.0])).astype(np.float32)
    R0 = np.eye(3, dtype=np.float32)
    _, res_j, obs_j, s_j = trk.track_frame(
        m, feats.uv, feats.signs, feats.mask, feats.level, jnp.asarray(R0),
        jnp.asarray(t0), FX, FY, CX, CY, W, H, min_matches=15)
    _, res_t, obs_t, s_t = ttrk.track_frame(
        tm, tf["uv"], tf["bits"], tf["mask"], tf["level"],
        torch.from_numpy(R0), torch.from_numpy(t0), FX, FY, CX, CY, W, H,
        min_matches=15)
    s_j, s_t = _to_np(s_j), s_t.numpy()
    assert s_t.shape == (16,)
    np.testing.assert_allclose(s_t[:9], s_j[:9], atol=1e-4)
    np.testing.assert_allclose(s_t[9:12], s_j[9:12], atol=1e-3)
    assert s_t[12] == s_j[12] and s_t[13] == s_j[13] and s_t[14] == s_j[14]
    np.testing.assert_allclose(s_t[15], s_j[15], rtol=1e-4)
    assert s_t[13] >= 15
    np.testing.assert_array_equal(obs_t.numpy(), _to_np(obs_j))


def test_map_mutations_match_jax():
    """insert_keyframe + add_landmarks on the same inputs give the same map."""
    rng = np.random.default_rng(2)
    cfg = ms.MapConfig(max_kf=4, max_lm=64, n_feat=40)
    N = cfg.n_feat
    uv = rng.uniform(0, 300, (N, 2)).astype(np.float32)
    lvl = rng.integers(0, 4, N).astype(np.int32)
    bits = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32)
    fv = rng.random(N) > 0.2
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.1, 0.2, 0.3], np.float32)
    X = rng.normal(size=(N, 3)).astype(np.float32)
    acc = rng.random(N) > 0.4
    feat = np.arange(N, dtype=np.int32)

    mj = ms.empty_map(cfg)
    mt = tms.empty_map(tms.MapConfig(4, 64, 40))
    for k in range(2):
        obs = np.full(N, -1, np.int32)
        mj = ms.insert_keyframe(mj, jnp.asarray(R), jnp.asarray(t + k), 0.5 * k,
                                jnp.asarray(uv), jnp.asarray(lvl),
                                jnp.asarray(bits), jnp.asarray(fv),
                                jnp.asarray(obs))
        mt = tms.insert_keyframe(mt, torch.from_numpy(R),
                                 torch.from_numpy(t + k), 0.5 * k,
                                 torch.from_numpy(uv), torch.from_numpy(lvl),
                                 torch.from_numpy(bits.view(np.int32)),
                                 torch.from_numpy(fv), torch.from_numpy(obs))
    mj = ms.add_landmarks(mj, jnp.asarray(X), jnp.asarray(bits),
                          jnp.asarray(acc), 1, 1, jnp.asarray(feat), 0,
                          jnp.asarray(feat))
    mt = tms.add_landmarks(mt, torch.from_numpy(X),
                           torch.from_numpy(bits.view(np.int32)),
                           torch.from_numpy(acc), 1, 1,
                           torch.from_numpy(feat), 0, torch.from_numpy(feat))
    want = tms.from_numpy(_map_np(mj))
    for name in ms.MapState._fields:
        np.testing.assert_array_equal(getattr(mt, name).numpy(),
                                      getattr(want, name).numpy(),
                                      err_msg=name)


@pytest.fixture(scope="module")
def frames():
    """Four rendered frames with depth, camera and a depth-seeded map built
    from frame 0 by the JAX package."""
    fx = fy = 260.0
    imgs, depths, R_gt, t_gt, _ = render_sequence(
        n_frames=4, width=W, height=H, fx=fx, fy=fy, seed=1,
        return_depth=True)
    return imgs, depths, R_gt, t_gt


def _seed_map_jax(extract, img, depth, R, t, cfg, fx, fy, cx, cy):
    f = extract(jnp.asarray(img))
    uv = _to_np(f.uv)
    mask = _to_np(f.mask)
    xi = np.clip(np.round(uv[:, 0]).astype(int), 0, img.shape[1] - 1)
    yi = np.clip(np.round(uv[:, 1]).astype(int), 0, img.shape[0] - 1)
    z = depth[yi, xi]
    ok = mask & (z > 0.1)
    Xc = np.stack([(uv[:, 0] - cx) / fx * z, (uv[:, 1] - cy) / fy * z, z], -1)
    Xw = ((Xc - t) @ R).astype(np.float32)  # R^T (x_c - t)
    m = ms.empty_map(cfg)
    obs = np.full(uv.shape[0], -1, np.int32)
    m = ms.insert_keyframe(m, jnp.asarray(R), jnp.asarray(t), 0.0, f.uv,
                           f.level, f.bits, f.mask, jnp.asarray(obs))
    feat = jnp.arange(uv.shape[0], dtype=jnp.int32)
    return ms.add_landmarks(m, jnp.asarray(Xw), f.bits, jnp.asarray(ok), 0,
                            0, feat, 0, feat)


def test_frame_step_matches_jax_system(frames, tmp_path):
    """`frame_step` from raw images tracks like the JAX System's own
    per-frame program: per frame |t| within 5e-3 m, R within 1e-3, inlier
    counts within 5% (pyramid levels differ by ~1e-3 gray levels between the
    two resize implementations, so descriptors of coarse levels may flip),
    and both within 0.05 m of ground truth."""
    from orb_slam3_ros2_tpu.runtime.system import System

    imgs, depths, R_gt, t_gt = frames
    fx = fy = 260.0
    settings = tmp_path / "cam.yaml"
    settings.write_text(
        "%YAML:1.0\nCamera.type: \"PinHole\"\n"
        f"Camera1.fx: {fx}\nCamera1.fy: {fy}\nCamera1.cx: {CX}\n"
        f"Camera1.cy: {CY}\nCamera1.k1: 0.0\nCamera1.k2: 0.0\n"
        "Camera1.p1: 0.0\nCamera1.p2: 0.0\n"
        f"Camera.width: {W}\nCamera.height: {H}\nCamera.fps: 20\n"
        "ORBextractor.nFeatures: 500\nORBextractor.scaleFactor: 1.2\n"
        "ORBextractor.nLevels: 4\nORBextractor.iniThFAST: 20\n"
        "ORBextractor.minThFAST: 7\n")
    sysj = System(None, str(settings),
                  map_cfg=ms.MapConfig(max_kf=8, max_lm=1024, n_feat=500))
    m = _seed_map_jax(sysj._extract, imgs[0], depths[0], R_gt[0], t_gt[0],
                      sysj.map_cfg, fx, fy, CX, CY)
    cam = tcam.make_camera("PinHole", fx, fy, CX, CY, (0.0,) * 4, W, H)
    ex_cfg = tex.ExtractorConfig(n_features=500, n_levels=4, height=H,
                                 width=W)
    mt = tms.from_numpy(_map_np(m))

    pj = [(jnp.asarray(R_gt[0]), jnp.asarray(t_gt[0]))] * 2
    pt = [(torch.from_numpy(R_gt[0]), torch.from_numpy(t_gt[0]))] * 2
    for k in range(1, imgs.shape[0]):
        m, _, _, Rj, tj, sj = sysj._frame_step(
            m, *pj[-1], *pj[-2], jnp.asarray(imgs[k]))
        mt, f_u, _, Rt, tt, st = tsys.frame_step(
            mt, *pt[-1], *pt[-2], torch.from_numpy(imgs[k]), cam, ex_cfg)
        pj.append((Rj, tj))
        pt.append((Rt, tt))
        sj, st = _to_np(sj), st.numpy()
        assert st[13] >= 15
        assert abs(st[13] - sj[13]) <= 0.05 * sj[13]
        np.testing.assert_allclose(Rt.numpy(), _to_np(Rj), atol=1e-3)
        np.testing.assert_allclose(tt.numpy(), _to_np(tj), atol=5e-3)
        assert np.abs(tt.numpy() - t_gt[k]).max() < 0.05
        assert f_u.uv.shape == (500, 2) and torch.isfinite(f_u.uv).all()
