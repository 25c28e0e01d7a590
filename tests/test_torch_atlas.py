"""The port's Atlas (`atlas/atlas.py`) and its `.npz` file against the JAX
Atlas: the save/load round trip (a copy of `tests/test_atlas_io.py`'s
atlas case), a JAX-saved atlas loaded by the port and a port-saved atlas
loaded by the JAX package, with every map leaf and every BoW leaf equal
(exact: the file carries the arrays as they are)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.atlas import atlas as jatlas
from orb_slam3_ros2_tpu.atlas import map_state as jms
from orb_slam3_ros2_tpu.loop import vocab as jvocab
from orb_slam3_ros2_tpu_torch.atlas import atlas as atlas_mod
from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
from orb_slam3_ros2_tpu_torch.loop import vocab

CFG = dict(max_kf=8, max_lm=64, n_feat=32)


def _random_inputs(rng, k):
    """One keyframe's inputs and its landmarks, as numpy arrays."""
    N = CFG["n_feat"]
    return dict(
        R=np.eye(3, dtype=np.float32),
        t=rng.normal(0, 1, 3).astype(np.float32),
        time=np.float32(0.5 * k + 0.25),
        uv=rng.uniform(0, 300, (N, 2)).astype(np.float32),
        level=rng.integers(0, 4, N).astype(np.int32),
        bits=rng.integers(0, 2**32, (N, 8), dtype=np.uint32),
        fv=rng.random(N) < 0.9, obs=np.full((N,), -1, np.int32),
        X=rng.normal(0, 2, (N, 3)).astype(np.float32),
        accept=rng.random(N) < 0.5,
        signs=np.where(rng.random((N, 256)) < 0.5, 1.0, -1.0).astype(
            np.float32))


def _jax_atlas(seed=0):
    """A JAX Atlas of two maps: map 0 with three keyframes, their
    landmarks and BoW rows; map 1 (active) with one keyframe."""
    rng = np.random.default_rng(seed)
    at = jatlas.Atlas(jms.MapConfig(**CFG))
    ids = jnp.arange(CFG["n_feat"], dtype=jnp.int32)
    for mi, n_kf in ((0, 3), (1, 1)):
        if mi:
            at.create_new_map()
        m, db = at.current_map, at.current_bow
        for k in range(n_kf):
            d = _random_inputs(rng, k)
            m = jms.insert_keyframe(
                m, jnp.asarray(d["R"]), jnp.asarray(d["t"]),
                jnp.asarray(d["time"]), jnp.asarray(d["uv"]),
                jnp.asarray(d["level"]), jnp.asarray(d["bits"]),
                jnp.asarray(d["fv"]), jnp.asarray(d["obs"]))
            m = jms.add_landmarks(
                m, jnp.asarray(d["X"]), jnp.asarray(d["bits"]),
                jnp.asarray(d["accept"]), jnp.asarray(k, jnp.int32),
                jnp.asarray(k, jnp.int32), ids,
                jnp.asarray(max(k - 1, 0), jnp.int32), ids)
            db = jvocab.add_keyframe(db, jnp.asarray(d["signs"]),
                                     jnp.asarray(d["fv"]))
        at.current_map, at.current_bow = m, db
    return at


def _assert_same(port_at, jax_at):
    assert port_at.n_maps() == jax_at.n_maps()
    assert port_at.active == jax_at.active
    assert (port_at.cfg.max_kf, port_at.cfg.max_lm, port_at.cfg.n_feat) == (
        jax_at.cfg.max_kf, jax_at.cfg.max_lm, jax_at.cfg.n_feat)
    for m, m_j, db, db_j in zip(port_at.maps, jax_at.maps, port_at.bow_dbs,
                                jax_at.bow_dbs):
        got = ms.to_numpy(m)
        for name in ms.MapState._fields:
            want = np.asarray(getattr(m_j, name))
            assert got[name].dtype == want.dtype, name
            np.testing.assert_array_equal(got[name], want, err_msg=name)
        for name, a, b in zip(vocab.BowDatabase._fields, db, db_j):
            b = np.asarray(b)
            assert a.cpu().numpy().dtype == b.dtype, name
            np.testing.assert_array_equal(a.cpu().numpy(), b, err_msg=name)


def test_jax_saved_atlas_loads_in_port(tmp_path):
    at_j = _jax_atlas()
    p = str(tmp_path / "jax_atlas.npz")
    at_j.save(p)
    at = atlas_mod.Atlas.load(p)
    assert at.n_words == vocab.N_WORDS
    _assert_same(at, at_j)
    assert int(at.maps[0].n_kf) == 3 and int(at.maps[0].lm_valid.sum()) > 0


def test_port_saved_atlas_loads_in_jax(tmp_path):
    at_j = _jax_atlas(seed=1)
    p = str(tmp_path / "a.npz")
    at_j.save(p)
    at = atlas_mod.Atlas.load(p)
    at.create_new_map()  # a third, empty map, active
    q = str(tmp_path / "port_atlas")
    at.save(q + ".npz")
    back_j = jatlas.Atlas.load(q)
    assert back_j.n_maps() == 3 and back_j.active == 2
    _assert_same(at, back_j)


def test_atlas_save_load_roundtrip(tmp_path):
    """The port copy of `tests/test_atlas_io.py::test_atlas_save_load_
    roundtrip`."""
    cfg = ms.MapConfig(**CFG)
    at = atlas_mod.Atlas(cfg)
    m = ms.insert_keyframe(
        at.current_map, torch.eye(3), torch.tensor([1.0, 2.0, 3.0]), 0.5,
        torch.zeros((32, 2)), torch.zeros((32,), dtype=torch.int32),
        torch.zeros((32, 8), dtype=torch.int32),
        torch.ones((32,), dtype=torch.bool),
        torch.full((32,), -1, dtype=torch.int32))
    at.current_map = m
    rng = np.random.default_rng(0)
    signs = torch.from_numpy(
        np.where(rng.random((32, 256)) < 0.5, 1.0, -1.0).astype(np.float32))
    at.current_bow = vocab.add_keyframe(
        at.current_bow, vocab.Vocabulary(), signs,
        torch.ones(32, dtype=torch.bool), slot=0)
    at.create_new_map()
    assert at.n_maps() == 2 and at.active == 1
    p = str(tmp_path / "atlas.npz")
    at.save(p)
    back = atlas_mod.Atlas.load(p)
    assert back.n_maps() == 2 and back.active == 1
    np.testing.assert_allclose(back.maps[0].kf_t[0].numpy(), [1.0, 2.0, 3.0])
    assert int(back.maps[0].n_kf) == 1 and int(back.bow_dbs[0].n) == 1
    np.testing.assert_array_equal(back.bow_dbs[0].vecs.numpy(),
                                  at.bow_dbs[0].vecs.numpy())
    assert back.total_landmarks() == at.total_landmarks() == 0


def test_atlas_rejects_another_format(tmp_path):
    at = atlas_mod.Atlas(ms.MapConfig(**CFG))
    p = str(tmp_path / "a.npz")
    at.save(p)
    blob = dict(np.load(p))
    blob["__version__"] = np.asarray(2)
    np.savez_compressed(p, **blob)
    with pytest.raises(ValueError, match="format 2"):
        atlas_mod.Atlas.load(p)


def test_jax_system_atlas_loads_with_a_row_per_keyframe(tmp_path):
    """An Atlas saved by the JAX System after 30 frames of the clip of
    `tests/test_atlas_reloc.py` holds no BoW rows for the initializer's two
    keyframes, and its slot s describes keyframe s + 2 (ROADMAP.md §3).
    The port's `System.LoadAtlasFromFile` brings the rows to slot =
    keyframe id: the map leaves stay as saved, JAX's row of keyframe k
    (k >= 2) reappears at slot k (atol 1e-6), querying keyframe k's own
    features returns k, and the loaded System relocalizes on frame 10."""
    import os

    from orb_slam3_ros2_tpu.runtime.system import Sensor as JSensor
    from orb_slam3_ros2_tpu.runtime.system import System as JSystem
    from orb_slam3_ros2_tpu_torch.io import synthetic
    from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as desc_ops
    from orb_slam3_ros2_tpu_torch.runtime.system import (Sensor, System,
                                                         TrackingState)

    settings = os.path.join(os.path.dirname(__file__), "data",
                            "synth_cam.yaml")
    images, _, _, ts = synthetic.render_sequence(
        n_frames=30, width=320, height=240, fx=260.0, fy=260.0, fps=10.0,
        seed=1, plane_depths=(6.0, 9.0), traj_scale=1.6)
    jsys = JSystem(None, settings, JSensor.MONOCULAR)
    for k in range(images.shape[0]):
        jsys.track_monocular(images[k], float(ts[k]))
    n_kf = int(jsys.map.n_kf)
    db_j = jsys.bow_db
    assert n_kf >= 4 and int(db_j.n) == n_kf - 2  # the JAX offset
    path = jsys.save_atlas(str(tmp_path / "jax_atlas.npz"))

    sys_ = System(None, settings, Sensor.MONOCULAR, device="cpu",
                  load_atlas=path)
    assert sys_.get_tracking_state() == TrackingState.LOST
    m, db = sys_.map, sys_.bow_db
    for name, a in ms.to_numpy(m).items():
        np.testing.assert_array_equal(
            a, np.asarray(getattr(jsys.map, name)), err_msg=name)
    assert int(db.n) == n_kf
    assert db.valid.numpy().nonzero()[0].tolist() == list(range(n_kf))
    np.testing.assert_allclose(db.vecs[2:n_kf].numpy(),
                               np.asarray(db_j.vecs)[:n_kf - 2], atol=1e-6,
                               rtol=0)
    none = torch.zeros((m.kf_R.shape[0],), dtype=torch.bool)
    for k in range(n_kf):
        _, ids = vocab.query(db, sys_.vocab,
                             desc_ops.signs_from_bits(m.kf_bits[k]),
                             m.kf_feat_valid[k], none)
        assert int(ids[0]) == k
    sys_.track_monocular(images[10], float(ts[-1]) + 1.0)
    assert sys_.get_tracking_state() == TrackingState.OK
    assert sys_.atlas.n_maps() == 1
