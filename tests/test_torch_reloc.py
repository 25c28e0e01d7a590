"""Relocalization, the Atlas and its file through the port's System: port
copies of the two cases of `tests/test_atlas_reloc.py` and the four System
cases of `tests/test_system_atlas.py` (not the session checkpoint), on the
same rendered 320x240 clip, plus the BoW slot of each keyframe.

The monocular initializer draws its RANSAC samples from the JAX System's
keys (as `test_torch_e2e_mono.py` does): on this clip the frame the
initializer accepts depends on the draw, and the JAX cases re-show frame
10 and need a map of `MIN_KFS_KEEP_MAP` keyframes after 36 frames, which
the JAX draw gives (initialized at frame 2, 7 keyframes at 30 frames, 9 at
36). One run of 36 frames is shared: each case takes a copy of the System
as it stood after 14, 20, 30 or 36 frames."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.frontend import initializer as jinit
from orb_slam3_ros2_tpu.loop import vocab as jvocab
from orb_slam3_ros2_tpu_torch.frontend import initializer as tinit
from orb_slam3_ros2_tpu_torch.io import synthetic
from orb_slam3_ros2_tpu_torch.loop import vocab as vocab_mod
from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as desc_ops
from orb_slam3_ros2_tpu_torch.runtime.system import (Sensor, System,
                                                     TrackingState)

SETTINGS = os.path.join(os.path.dirname(__file__), "data", "synth_cam.yaml")
SNAPSHOTS = (14, 20, 30, 36)


def _jax_initialize(gen, uv1, uv2, mask, *args, **kwargs):
    kh, kf = jax.random.split(jax.random.PRNGKey(gen.initial_seed()))
    m = jnp.asarray(mask.numpy())
    idx_h = np.array(jinit._sample_indices(kh, m, jinit.N_HYPO, 4))
    idx_f = np.array(jinit._sample_indices(kf, m, jinit.N_HYPO, 8))
    return tinit.initialize_from_samples(
        uv1, uv2, mask, torch.from_numpy(idx_h), torch.from_numpy(idx_f),
        *args, **kwargs)


@pytest.fixture(scope="module")
def rendered():
    return synthetic.render_sequence(
        n_frames=36, width=320, height=240, fx=260.0, fy=260.0, fps=10.0,
        seed=1, plane_depths=(6.0, 9.0), traj_scale=1.6)


@pytest.fixture(scope="module")
def snapshots(rendered):
    """{n: a copy of the System after its first n frames} of one run with
    loop closing on (the settings file leaves `loopClosing` at 1)."""
    images, _, _, ts = rendered
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tinit, "initialize", _jax_initialize)
        sys_ = System(None, SETTINGS, Sensor.MONOCULAR, device="cpu")
        assert sys_.settings.loop_closing
        for k in range(images.shape[0]):
            sys_.track_monocular(images[k], float(ts[k]))
            if k + 1 in SNAPSHOTS:
                out[k + 1] = copy.deepcopy(sys_)
    torch.set_num_threads(n_threads)
    return out


def _system(snapshots, n):
    sys_ = copy.deepcopy(snapshots[n])
    assert sys_.get_tracking_state() == TrackingState.OK
    return sys_


def _blackout(sys_):
    """Tracking dies and a junk map spawns (as the JAX cases force it)."""
    sys_.state = TrackingState.LOST
    sys_.atlas.create_new_map()
    sys_._spawn_state_reset()
    sys_.state = TrackingState.LOST


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def test_reloc_into_first_map_discards_junk_map(rendered, snapshots):
    images, _, _, ts = rendered
    sys_ = _system(snapshots, 30)
    pose_at_10 = [T for t, T in sys_.get_trajectory()
                  if abs(t - float(ts[10])) < 1e-9]
    assert len(pose_at_10) == 1
    assert sys_.tracking_log[10]["state"] == int(TrackingState.OK)
    _blackout(sys_)
    assert sys_.atlas.n_maps() == 2 and sys_.atlas.active == 1
    T = sys_.track_monocular(images[10], float(ts[-1]) + 1.0)
    assert sys_.get_tracking_state() == TrackingState.OK
    assert sys_.atlas.active == 0
    assert sys_.atlas.n_maps() == 1  # the empty junk map is dropped
    assert np.linalg.norm(_centre(T) - _centre(pose_at_10[0])) < 0.1
    assert sys_._map_protected  # a resumed map is frozen, not discarded
    assert len(sys_.kf_times) == int(sys_.map.n_kf)


def test_reloc_stays_lost_on_unseen_scene(rendered, snapshots):
    images, _, _, ts = rendered
    sys_ = _system(snapshots, 20)
    _blackout(sys_)
    sys_.track_monocular(np.zeros_like(images[0]), float(ts[-1]) + 2.0)
    assert sys_.get_tracking_state() == TrackingState.LOST
    assert sys_.atlas.n_maps() == 2
    assert sys_.frames_lost == 1


def test_atlas_save_load_resume_and_relocalize(rendered, snapshots,
                                               tmp_path):
    images, _, _, ts = rendered
    sys_ = _system(snapshots, 36)
    n_kf = int(sys_.map.n_kf)
    assert n_kf >= 4
    path = str(tmp_path / "atlas.npz")
    assert sys_.save_atlas(path) == path and os.path.isfile(path)
    cfg2 = tmp_path / "resume.yaml"
    cfg2.write_text(open(SETTINGS).read()
                    + f'\nSystem.LoadAtlasFromFile: "{path}"\n')
    sys2 = System(None, str(cfg2), Sensor.MONOCULAR, map_cfg=sys_.map_cfg,
                  device="cpu")
    assert sys2.get_tracking_state() == TrackingState.LOST
    assert int(sys2.map.n_kf) == n_kf
    assert sys2.atlas.n_maps() == sys_.atlas.n_maps()
    assert sys2.kf_times == pytest.approx(sys_.kf_times)
    # the rows rebuilt from the keyframes on load are the rows saved
    for db, db2 in zip(sys_.atlas.bow_dbs, sys2.atlas.bow_dbs):
        np.testing.assert_allclose(db2.vecs.numpy(), db.vecs.numpy(),
                                   atol=1e-6, rtol=0)
        assert torch.equal(db2.valid, db.valid)
        assert torch.equal(db2.doc_freq, db.doc_freq)
        assert int(db2.n) == int(db.n)
    for k in range(10):
        sys2.track_monocular(images[k], float(ts[k]) + 100.0)
        if sys2.get_tracking_state() == TrackingState.OK:
            break
    assert sys2.get_tracking_state() == TrackingState.OK
    assert int(sys2.map.n_kf) >= n_kf  # the loaded map, not a new one


def test_missing_atlas_file_starts_fresh(tmp_path):
    cfg = tmp_path / "fresh.yaml"
    cfg.write_text(open(SETTINGS).read()
                   + '\nSystem.LoadAtlasFromFile: "/nonexistent/a.npz"\n')
    sys_ = System(None, str(cfg), Sensor.MONOCULAR, device="cpu")
    assert sys_.get_tracking_state() == TrackingState.NOT_INITIALIZED
    assert sys_.atlas.n_maps() == 1


def test_new_map_spawn_on_persistent_loss(rendered, snapshots):
    images, _, _, ts = rendered
    sys_ = _system(snapshots, 36)
    assert int(sys_.map.n_kf) >= sys_.MIN_KFS_KEEP_MAP
    assert sys_.atlas.n_maps() == 1
    rng = np.random.default_rng(0)
    t = float(ts[-1])
    for _ in range(sys_.LOST_FRAMES_NEW_MAP + 8):
        t += 0.1
        sys_.track_monocular(
            rng.uniform(0, 255, images[0].shape).astype(np.float32), t)
        if sys_.atlas.n_maps() > 1:
            break
    assert sys_.atlas.n_maps() == 2, "lost tracking must spawn a new map"
    assert sys_.get_tracking_state() == TrackingState.NOT_INITIALIZED
    assert int(sys_.map.n_kf) == 0 and int(sys_.bow_db.n) == 0
    assert int(sys_.atlas.maps[0].n_kf) >= sys_.MIN_KFS_KEEP_MAP


def test_loaded_map_never_discarded_on_loss(snapshots, tmp_path):
    sys_ = _system(snapshots, 14)
    n_kf = int(sys_.map.n_kf)
    assert 1 <= n_kf < sys_.MIN_KFS_KEEP_MAP
    path = str(tmp_path / "small_atlas.npz")
    sys_.save_atlas(path)
    sys2 = System(None, SETTINGS, Sensor.MONOCULAR, map_cfg=sys_.map_cfg,
                  load_atlas=path, device="cpu")
    assert int(sys2.map.n_kf) == n_kf
    other, _, _, ts2 = synthetic.render_sequence(
        n_frames=sys2.LOST_FRAMES_NEW_MAP + 5, width=320, height=240,
        fx=260.0, fy=260.0, fps=10.0, seed=9, traj_scale=1.6)
    for k in range(other.shape[0]):
        sys2.track_monocular(other[k], 500.0 + float(ts2[k]))
    assert sys2.atlas.n_maps() == 2  # the frozen loaded map + a fresh one
    assert int(sys2.atlas.maps[0].n_kf) == n_kf


def test_bow_rows_follow_keyframe_ids(snapshots):
    """Keyframe k's BoW row is slot k in the port (the initializer's two
    keyframes have theirs), so querying keyframe k's own features returns
    k. The JAX System writes rows only after the initializer, at slot
    `db.n`: the same rows through its writer put keyframe k at slot k - 2
    (JAX on this clip: 7 keyframes, 5 rows)."""
    sys_ = _system(snapshots, 30)
    m, db = sys_.map, sys_.bow_db
    n_kf = int(m.n_kf)
    assert n_kf == 7 and int(db.n) == n_kf
    K = m.kf_R.shape[0]
    none = torch.zeros((K,), dtype=torch.bool)
    db_j = jvocab.empty_database(K)
    for k in range(n_kf):
        signs = desc_ops.signs_from_bits(m.kf_bits[k])
        mask = m.kf_feat_valid[k]
        _, ids = vocab_mod.query(db, sys_.vocab, signs, mask, none)
        assert int(ids[0]) == k
        if k >= 2:
            db_j = jvocab.add_keyframe(db_j, jnp.asarray(signs.numpy()),
                                       jnp.asarray(mask.numpy()))
    assert int(db_j.n) == n_kf - 2
    for k in range(2, n_kf):
        signs = desc_ops.signs_from_bits(m.kf_bits[k]).numpy()
        _, ids = jvocab.query(db_j, jnp.asarray(signs),
                              jnp.asarray(m.kf_feat_valid[k].numpy()),
                              jnp.zeros((K,), bool))
        assert int(ids[0]) == k - 2


def test_stock_euroc_settings_construct_and_track():
    """`config/Monocular/EuRoC.yaml` as published (radtan distortion,
    `loopClosing` absent, so on) constructs on the CPU and tracks the first
    frames of phase 8's clip, rendered through that distortion; each
    frame leaves a finite pose."""
    from orb_slam3_ros2_tpu_torch.tools import system_run

    sys_ = System(None, str(system_run.REPO / system_run.EUROC),
                  Sensor.MONOCULAR, device="cpu")
    assert sys_.settings.loop_closing and sys_.cam.width == 752
    imgs, _, _, ts = system_run.render_euroc_distorted()
    assert imgs.shape == (system_run.N_FRAMES, 480, 752)
    for k in range(4):
        T = sys_.track_monocular(imgs[k], float(ts[k]))
        assert np.isfinite(T).all()
    assert sys_.get_tracking_state() == TrackingState.OK
    assert int(sys_.bow_db.n) == int(sys_.map.n_kf) == 2
