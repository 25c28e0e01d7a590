"""The port's place-recognition vocabulary (`loop/vocab.py`, `hvocab.py`,
`dbow2.py`) against the JAX modules on the same numpy inputs, and port
copies of `test_vocab_training.py`, `test_hvocab.py` and
`test_dbow2_vocab.py`.

Tolerances: word ids, the sparse entries' word ids, document counts, slot
counts and every numpy path (training, file formats) exact; BoW vectors
within 1e-6; query scores within 1e-5, and query ids equal wherever the
JAX scores of neighbouring ranks differ by more than 1e-5 (the two
products sum in different orders)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.loop import dbow2 as jdbow2
from orb_slam3_ros2_tpu.loop import hvocab as jhv
from orb_slam3_ros2_tpu.loop import vocab as jvocab
from orb_slam3_ros2_tpu_torch.loop import dbow2
from orb_slam3_ros2_tpu_torch.loop import hvocab as hv
from orb_slam3_ros2_tpu_torch.loop import vocab as vocab_mod
from orb_slam3_ros2_tpu_torch.runtime.system import Sensor, System

SETTINGS = os.path.join(os.path.dirname(__file__), "data", "synth_cam.yaml")


@pytest.fixture
def jax_vocab():
    """Installs a vocabulary in the JAX module for one test and restores
    the default codebook after it (the JAX module keeps it global)."""
    yield jvocab.set_vocabulary
    jvocab._ACTIVE_ANCHORS = None
    jvocab._ACTIVE_TREE = None
    jax.clear_caches()


def _signs(rng, n):
    return np.where(rng.random((n, 256)) < 0.5, -1.0, 1.0).astype(np.float32)


def _frames(rng, protos, n_frames, n_feat, flip=0.05):
    out = []
    for _ in range(n_frames):
        reps = protos[rng.integers(0, len(protos), n_feat)]
        out.append(np.where(rng.random(reps.shape) < flip, -reps, reps)
                   .astype(np.float32))
    return out


@pytest.fixture(scope="module")
def small_tree():
    rng = np.random.default_rng(0)
    protos = _signs(rng, 64)
    reps = np.repeat(protos, 40, axis=0)
    S = np.where(rng.random(reps.shape) < 0.05, -reps, reps)
    tree = hv.train_hierarchical(S, k=4, depth=3, iters=5, seed=1)
    return tree, protos, S


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------ parity

@pytest.mark.parametrize("seed", [0, 1])
def test_assign_words_and_bow_vector_match_jax(seed):
    rng = np.random.default_rng(seed)
    S = _signs(rng, 300)
    # near-duplicates of anchors make exact ties between words frequent
    S[:40] = vocab_mod._anchors_np()[rng.integers(0, 1024, 40)]
    S[:40, :8] *= -1
    mask = rng.random(300) < 0.8
    voc = vocab_mod.Vocabulary()
    w = vocab_mod.assign_words(voc, _t(S), _t(mask)).numpy()
    w_j = np.asarray(jvocab.assign_words(jnp.asarray(S), jnp.asarray(mask)))
    np.testing.assert_array_equal(w, w_j)
    assert w.dtype == np.int32 and (w[~mask] == -1).all()
    idf = rng.uniform(0.1, 3.0, 1024).astype(np.float32)
    for idf_ in (None, idf):
        v = vocab_mod.bow_vector(voc, _t(S), _t(mask),
                                 None if idf_ is None else _t(idf_)).numpy()
        v_j = np.asarray(jvocab.bow_vector(
            jnp.asarray(S), jnp.asarray(mask),
            None if idf_ is None else jnp.asarray(idf_)))
        np.testing.assert_allclose(v, v_j, atol=1e-6, rtol=0)


def _both_dbs(frames, max_kf, voc, jax_add):
    db = vocab_mod.empty_database(max_kf, voc.n_words)
    db_j = jvocab.empty_database(max_kf)
    # the JAX writer's slot db.n, for rows added in order
    for i, f in enumerate(frames):
        m = np.ones(len(f), bool)
        db = vocab_mod.add_keyframe(db, voc, _t(f), _t(m), slot=i)
        db_j = jax_add(db_j, jnp.asarray(f), jnp.asarray(m))
    return db, db_j


def _assert_db_equal(db, db_j):
    np.testing.assert_allclose(db.vecs.numpy(), np.asarray(db_j.vecs),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(db.valid.numpy(), np.asarray(db_j.valid))
    np.testing.assert_array_equal(db.doc_freq.numpy(),
                                  np.asarray(db_j.doc_freq))
    assert int(db.n) == int(db_j.n) and db.n.dtype == torch.int32


def _assert_query_equal(got, ref):
    s, i = (x.numpy() for x in got)
    s_j, i_j = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(s, s_j, atol=1e-5, rtol=0)
    gap = np.minimum(np.abs(np.diff(s_j, prepend=np.inf)),
                     np.abs(np.diff(s_j, append=-np.inf)))
    clear = gap > 1e-5
    assert clear.sum() >= 2
    np.testing.assert_array_equal(i[clear], i_j[clear])


def test_database_add_and_query_match_jax():
    rng = np.random.default_rng(3)
    protos = _signs(rng, 80)
    frames = _frames(rng, protos, 7, 120)
    voc = vocab_mod.Vocabulary()
    # 7 frames into 6 slots: the last one overflows and writes nothing
    db, db_j = _both_dbs(frames, 6, voc, jvocab.add_keyframe)
    _assert_db_equal(db, db_j)
    assert int(db.n) == 6
    for q, excl in ((frames[2], np.zeros(6, bool)),
                    (frames[4], np.array([0, 0, 0, 0, 1, 0], bool)),
                    (_frames(rng, protos, 1, 100)[0], np.zeros(6, bool))):
        m = np.ones(len(q), bool)
        got = vocab_mod.query(db, voc, _t(q), _t(m), _t(excl), top_k=5)
        ref = jvocab.query(db_j, jnp.asarray(q), jnp.asarray(m),
                           jnp.asarray(excl), top_k=5)
        _assert_query_equal(got, ref)
        if not excl.any() and q is frames[2]:
            assert int(got[1][0]) == 2
        assert not excl[got[1].numpy()[got[0].numpy() > -1]].any()


def test_add_keyframe_at_a_slot():
    """The port writes keyframe k's row at slot k: rows out of order count
    once each, and rewriting a slot replaces its document counts."""
    rng = np.random.default_rng(5)
    frames = _frames(rng, _signs(rng, 40), 3, 60)
    voc = vocab_mod.Vocabulary()
    m = torch.ones(60, dtype=torch.bool)
    db = vocab_mod.empty_database(8, voc.n_words)
    db = vocab_mod.add_keyframe(db, voc, _t(frames[0]), m, slot=3)
    db = vocab_mod.add_keyframe(db, voc, _t(frames[1]), m,
                                slot=torch.tensor(1))
    assert int(db.n) == 2
    assert db.valid.numpy().nonzero()[0].tolist() == [1, 3]
    db = vocab_mod.add_keyframe(db, voc, _t(frames[2]), m, slot=3)
    assert int(db.n) == 2
    v1 = vocab_mod.bow_vector(voc, _t(frames[1]), m)
    v2 = vocab_mod.bow_vector(voc, _t(frames[2]), m)
    np.testing.assert_array_equal(db.vecs[3].numpy(), v2.numpy())
    np.testing.assert_array_equal(
        db.doc_freq.numpy(), ((v1 > 0).float() + (v2 > 0).float()).numpy())
    db = vocab_mod.add_keyframe(db, voc, _t(frames[0]), m, slot=8)  # past K
    assert int(db.n) == 2


def test_exclude_window_matches_jax():
    for lo, hi in ((0, 3), (5, 20), (12, 11)):
        np.testing.assert_array_equal(
            vocab_mod.exclude_window(16, lo, hi).numpy(),
            np.asarray(jvocab.exclude_window(16, lo, hi)))


def test_tree_assignment_and_tree_database_match_jax(small_tree, jax_vocab):
    tree, protos, S = small_tree
    tree_j = jhv.train_hierarchical(S, k=4, depth=3, iters=5, seed=1)
    for a, b in zip(tree.levels, tree_j.levels):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(4)
    q = _frames(rng, protos, 1, 100)[0]
    mask = rng.random(100) < 0.9
    w = hv.assign_words_tree(tree, _t(q), _t(mask)).numpy()
    np.testing.assert_array_equal(w, np.asarray(jhv.assign_words_tree(
        tree_j, jnp.asarray(q), jnp.asarray(mask))))
    # the tree installed as the System's vocabulary: the dense pipeline
    voc = vocab_mod.Vocabulary(tree)
    jax_vocab(tree_j)
    assert voc.n_words == jvocab.n_words() == 64
    np.testing.assert_array_equal(
        vocab_mod.assign_words(voc, _t(q), _t(mask)).numpy(), w)
    frames = _frames(rng, protos, 5, 80)
    db, db_j = _both_dbs(frames, 8, voc, jvocab.add_keyframe)
    _assert_db_equal(db, db_j)
    m = np.ones(80, bool)
    _assert_query_equal(
        vocab_mod.query(db, voc, _t(frames[1]), _t(m),
                        torch.zeros(8, dtype=torch.bool)),
        jvocab.query(db_j, jnp.asarray(frames[1]), jnp.asarray(m),
                     jnp.zeros(8, bool)))


@pytest.mark.parametrize("top_t", [128, 16, 80])
def test_sparse_database_matches_jax(small_tree, top_t):
    tree, protos, _ = small_tree
    rng = np.random.default_rng(5)
    W = tree.n_words
    ones = torch.ones(80, dtype=torch.bool)
    words = [hv.assign_words_tree(tree, _t(f), ones)
             for f in _frames(rng, protos, 6, 80)]
    db = hv.empty_sparse_db(5, W, top_t=top_t)
    db_j = jhv.empty_sparse_db(5, W, top_t=top_t)
    for w in words:  # 6 into 5 slots
        db = hv.add_entry(db, w, W)
        db_j = jhv.add_entry(db_j, jnp.asarray(w.numpy()), W)
    np.testing.assert_array_equal(db.word_ids.numpy(),
                                  np.asarray(db_j.word_ids))
    np.testing.assert_allclose(db.tf.numpy(), np.asarray(db_j.tf), atol=1e-6)
    np.testing.assert_array_equal(db.doc_freq.numpy(),
                                  np.asarray(db_j.doc_freq))
    np.testing.assert_array_equal(db.valid.numpy(), np.asarray(db_j.valid))
    assert int(db.n) == int(db_j.n) == 5
    excl = np.array([0, 0, 1, 0, 0], bool)
    for e in (None, excl):
        got = hv.query_sparse(db, words[3], W, None if e is None else _t(e),
                              top_k=4)
        ref = jhv.query_sparse(db_j, jnp.asarray(words[3].numpy()), W,
                               None if e is None else jnp.asarray(e), top_k=4)
        _assert_query_equal(got, ref)


def test_training_and_file_formats_match_jax(small_tree, tmp_path):
    """Training, the npz codebook, the hierarchical npz and the DBoW2 text
    reader/writer are numpy in both packages: identical results, and each
    package reads the other's files."""
    rng = np.random.default_rng(6)
    S = _signs(rng, 1100)
    A = vocab_mod.train_vocabulary(S, iters=2, seed=3)
    np.testing.assert_array_equal(A, jvocab.train_vocabulary(S, iters=2,
                                                             seed=3))
    p = vocab_mod.save_vocabulary(str(tmp_path / "flat"), A)
    np.testing.assert_array_equal(jvocab.load_vocabulary(p), A)
    np.testing.assert_array_equal(dbow2.load_vocabulary_any(p), A)
    tree = small_tree[0]
    ph = jhv.save_hvocab(str(tmp_path / "tree"), tree)
    back = dbow2.load_vocabulary_any(ph)
    assert isinstance(back, hv.HierVocab) and back.k == 4 and back.depth == 3
    for a, b in zip(back.levels, tree.levels):
        np.testing.assert_array_equal(a, b)
    pt = str(tmp_path / "voc.txt")
    hv.export_dbow2_text(tree, pt)
    pt_j = str(tmp_path / "voc_j.txt")
    jhv.export_dbow2_text(tree, pt_j)
    assert open(pt).read() == open(pt_j).read()
    for n_words in (64, 1024):
        np.testing.assert_array_equal(
            dbow2.load_dbow2_text(pt, n_words=n_words),
            jdbow2.load_dbow2_text(pt, n_words=n_words))
    pf = str(tmp_path / "flat.txt")
    dbow2.save_dbow2_text(pf, A)
    np.testing.assert_array_equal(jdbow2.load_dbow2_text(pf), A)


# ------------------------------------- port copies of the JAX vocab tests

def _clustered_signs(n_clusters=64, per=40, flip=0.08, seed=2):
    rng = np.random.default_rng(seed)
    centers = np.where(rng.random((n_clusters, 256)) < 0.5, -1.0, 1.0)
    signs, labels = [], []
    for c in range(n_clusters):
        flips = rng.random((per, 256)) < flip
        signs.append(np.where(flips, -centers[c], centers[c]))
        labels.append(np.full(per, c))
    return (np.concatenate(signs).astype(np.float32),
            np.concatenate(labels), centers)


def _purity(word_of, labels):
    agree = total = 0
    for c in np.unique(labels):
        counts = np.bincount(word_of[labels == c])
        agree += (counts * (counts - 1)).sum() / 2
        total += (labels == c).sum() * ((labels == c).sum() - 1) / 2
    return agree / total


def test_trained_vocab_beats_random_codebook():
    signs, labels, _ = _clustered_signs(n_clusters=1500, per=3)
    A = vocab_mod.train_vocabulary(signs, iters=6, seed=0)
    assert A.shape == (vocab_mod.N_WORDS, 256) and np.all(np.abs(A) == 1.0)
    m = torch.ones(len(signs), dtype=torch.bool)
    w_rand = vocab_mod.assign_words(vocab_mod.Vocabulary(), _t(signs), m)
    w_train = vocab_mod.assign_words(vocab_mod.Vocabulary(A), _t(signs), m)
    p_rand = _purity(w_rand.numpy(), labels)
    p_train = _purity(w_train.numpy(), labels)
    assert p_train > p_rand + 0.1, (p_rand, p_train)


def test_system_ctor_loads_vocab(tmp_path):
    signs, _, _ = _clustered_signs(n_clusters=1200, per=2)
    A = vocab_mod.train_vocabulary(signs, iters=2, seed=3)
    path = vocab_mod.save_vocabulary(str(tmp_path / "voc"), A)
    sys_ = System(path, SETTINGS, Sensor.MONOCULAR, device="cpu")
    np.testing.assert_array_equal(sys_.vocab.anchors.numpy(), A)
    with pytest.raises(ValueError):
        vocab_mod.Vocabulary(np.ones((3, 3), np.float32))
    with pytest.raises(ValueError):
        vocab_mod.Vocabulary(np.full((4, 256), 0.5, np.float32))


def test_tree_shapes_and_noise_stability(small_tree):
    tree, protos, S = small_tree
    assert tree.n_words == 64 and len(tree.levels) == 3
    for j, lv in enumerate(tree.levels):
        assert lv.shape == (4 ** j, 4, 256) and np.all(np.abs(lv) == 1.0)
    rng = np.random.default_rng(3)
    reps = np.repeat(protos, 2, axis=0)
    noisy = np.where(rng.random(reps.shape) < 0.03, -reps, reps)
    w = hv.assign_words_tree(tree, _t(noisy.astype(np.float32)),
                             torch.ones(len(noisy), dtype=torch.bool)).numpy()
    assert np.mean(w[0::2] == w[1::2]) > 0.8
    mask = np.zeros(10, bool)
    mask[::2] = True
    w = hv.assign_words_tree(tree, _t(S[:10]), _t(mask)).numpy()
    assert np.all(w[~mask] == -1) and np.all(w[mask] >= 0)


def test_hvocab_roundtrips(small_tree, tmp_path):
    tree, _, _ = small_tree
    p = hv.save_hvocab(str(tmp_path / "t"), tree)
    tree2 = hv.load_hvocab(p)
    assert tree2.k == tree.k and tree2.depth == tree.depth
    for a, b in zip(tree.levels, tree2.levels):
        np.testing.assert_array_equal(a, b)
    assert isinstance(dbow2.load_vocabulary_any(p), hv.HierVocab)
    pt = str(tmp_path / "voc.txt")
    hv.export_dbow2_text(tree, pt)
    flat = dbow2.load_dbow2_text(pt, n_words=64)
    assert {tuple(r) for r in flat} == {tuple(r) for r in hv.flat_leaves(tree)}


def test_sparse_db_matches_dense_scoring(small_tree):
    tree, protos, _ = small_tree
    rng = np.random.default_rng(5)
    W = tree.n_words
    words = [hv.assign_words_tree(tree, _t(f), torch.ones(80, dtype=torch.bool)
                                  ).numpy()
             for f in _frames(rng, protos, 12, 80)]
    db = hv.empty_sparse_db(16, W, top_t=128)
    for w in words:
        db = hv.add_entry(db, _t(w), W)
    scores, ids = (x.numpy() for x in hv.query_sparse(db, _t(words[4]), W,
                                                      top_k=5))
    assert ids[0] == 4 and scores[0] > 0.999
    idf = np.log(12.0 / np.maximum(db.doc_freq.numpy(), 1.0))
    dense = []
    for w in words:
        h = np.bincount(w[w >= 0], minlength=W).astype(np.float32)
        hw = h / max(np.linalg.norm(h), 1e-8) * idf
        dense.append(hw / max(np.linalg.norm(hw), 1e-8))
    ref = np.stack(dense) @ dense[4]
    order_ref = np.argsort(-ref)[:5]
    np.testing.assert_array_equal(ids, order_ref)
    np.testing.assert_allclose(scores, ref[order_ref], atol=1e-5)


def test_sparse_db_capacity_and_exclude(small_tree):
    tree, protos, _ = small_tree
    rng = np.random.default_rng(9)
    W = tree.n_words
    db = hv.empty_sparse_db(4, W, top_t=32)
    w0 = None
    for i in range(6):
        w = hv.assign_words_tree(tree, _t(protos[rng.integers(0, 64, 40)]),
                                 torch.ones(40, dtype=torch.bool))
        w0 = w if i == 0 else w0
        db = hv.add_entry(db, w, W)
    assert int(db.n) == 4
    excl = torch.zeros(4, dtype=torch.bool)
    excl[0] = True
    scores, ids = hv.query_sparse(db, w0, W, exclude=excl, top_k=4)
    assert 0 not in ids.numpy()[scores.numpy() > 0]


def _write_tree_vocab(path, k=3, seed=0):
    rng = np.random.default_rng(seed)
    lines = [f"{k} 2 0 0"]
    node_id, level1, leaves = 0, [], []
    for _ in range(k):
        node_id += 1
        level1.append(node_id)
        lines.append("0 0 " + " ".join(map(str, rng.integers(0, 256, 32)))
                     + " 0.0")
    for p in level1:
        for _ in range(k):
            node_id += 1
            b = rng.integers(0, 256, 32)
            lines.append(f"{p} 1 " + " ".join(map(str, b))
                         + f" {rng.uniform(0.1, 2.0):.6f}")
            leaves.append(b)
    path.write_text("\n".join(lines) + "\n")
    return np.array(leaves, np.uint8)


def test_dbow2_tree_pads_to_codebook_width(tmp_path):
    p = tmp_path / "voc.txt"
    leaf_bytes = _write_tree_vocab(p)
    A = dbow2.load_dbow2_text(str(p))
    assert A.shape == (vocab_mod.N_WORDS, 256) and np.all(np.abs(A) == 1.0)
    want = {tuple(r) for r in dbow2._bytes_to_signs(leaf_bytes).tolist()}
    assert {tuple(r) for r in A[:9].tolist()} == want
    # the 3 inner nodes follow; the default codebook pads the rest
    np.testing.assert_array_equal(A[12:], vocab_mod._anchors_np()[12:])


def test_system_accepts_orbvoc_txt_and_rejects_malformed(tmp_path):
    rng = np.random.default_rng(2)
    book = _signs(rng, vocab_mod.N_WORDS)
    p = tmp_path / "ORBvoc.txt"
    dbow2.save_dbow2_text(str(p), book)
    np.testing.assert_array_equal(dbow2.load_dbow2_text(str(p)), book)
    sys_ = System(str(p), SETTINGS, Sensor.MONOCULAR, device="cpu")
    np.testing.assert_array_equal(sys_.vocab.anchors.numpy(), book)
    assert sys_.bow_db.vecs.shape == (sys_.map_cfg.max_kf, 1024)
    bad = tmp_path / "bad.txt"
    bad.write_text("10 6 0 0\n1 2 3\n")
    with pytest.raises(ValueError):
        dbow2.load_dbow2_text(str(bad))
