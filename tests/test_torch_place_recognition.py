"""The port's place-recognition benches and vocabulary training against
their scripts, on the CPU.

- `tools/bench_place_recognition.py` against
  `scripts/bench_place_recognition.py`: the three banks bit for bit
  against the script's renders (its `_traj` restated); on the same
  signs (the port's extraction of 20-frame banks at a 1 s period, so that
  11 queries revisit a place), the script's scoring restated over the JAX
  `loop/vocab.py` (random and trained codebooks) and the port's
  `evaluate` give exactly the same rows, per-query top-10 ranks and group
  winners. End to end at `--frames 40` (marked `slow`): the script's
  keys, `queries` (from the script's geometry restated) and `db_entries`;
  the vocabulary files under `--vocab-out` load in both packages.
- `tools/bench_pr_mapscale.py` against `scripts/bench_pr_mapscale.py`: on
  the same signs, the shipped tree's words, the sparse database and every
  query's top-10 over the JAX `loop/hvocab.py` (the script's one-pass
  build restated) are exactly the port's; end to end at `--frames 40
  --target-entries 200` (marked `slow`), the script's keys, `queries` and
  `db_entries`.
- `tools/train_vocab.py`: the synthetic branch (flat, and a small tree
  with its DBoW2 text) and the EuRoC branch on a recording the test
  writes with `io/recording.SequenceRecorder`; the script's `main` on the
  same flags; every file loads in both packages.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.io import synthetic as jsynthetic
from orb_slam3_ros2_tpu.loop import dbow2 as jdbow2
from orb_slam3_ros2_tpu.loop import hvocab as jhv
from orb_slam3_ros2_tpu.loop import vocab as jvocab
from orb_slam3_ros2_tpu_torch.loop import dbow2 as tdbow2
from orb_slam3_ros2_tpu_torch.loop import hvocab as thv
from orb_slam3_ros2_tpu_torch.loop import vocab as tvocab
from orb_slam3_ros2_tpu_torch.tools import bench_place_recognition as bpr
from orb_slam3_ros2_tpu_torch.tools import bench_pr_mapscale as bms
from orb_slam3_ros2_tpu_torch.tools import train_vocab
from tests.test_torch_ba_benches import (  # noqa: F401
    _script, _script_keys, _script_run, two_blas_threads)
from tests.test_torch_e2e_stereo import two_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_threads", "two_blas_threads")

F, PERIOD, FPS, G = 20, 1.0, 10.0, 5


def _jax_traj(phase, period):
    """`scripts/bench_place_recognition.py:84-96`, its branch for a
    `Trajectory` without `phase` (neither package's has one)."""
    assert not hasattr(jsynthetic.Trajectory, "phase")
    return jsynthetic.Trajectory(
        amp_t=np.array([1.2, 0.7, 0.9]) * (1.0 + 0.15 * phase),
        freq_t=np.array([1, 2, 1]) / period,
        amp_r=np.array([0.12, 0.18, 0.08]),
        freq_r=np.array([2, 1, 1]) / (period * (1.0 + 0.21 * phase)),
    )


def _jax_render(seed, traj, n=F):
    return jsynthetic.render_room_sequence(
        n_frames=n, width=320, height=240, fx=260.0, fy=260.0, fps=FPS,
        seed=seed, traj=traj)


@pytest.fixture(scope="module")
def banks():
    """The port's banks at the test's period, checked bit for bit against
    the script's renders, and the port's signs of all of them."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the module fixture runs before two_threads
    images, R_cw, t_cw, alias, other = bpr.make_banks(F, PERIOD, FPS)
    ref = _jax_render(3, _jax_traj(0.0, PERIOD))
    for got, want in zip((images, R_cw, t_cw), ref[:3]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(alias,
                                  _jax_render(3, _jax_traj(1.0, PERIOD))[0])
    np.testing.assert_array_equal(other,
                                  _jax_render(9, _jax_traj(0.5, PERIOD))[0])
    extract = bpr.make_extractor()
    parts = [bpr.extract_all(extract, b, "cpu")
             for b in (images, alias, other)]
    signs = torch.cat([s for s, _ in parts]).numpy()
    masks = torch.cat([m for _, m in parts]).numpy()
    torch.set_num_threads(n_threads)
    return dict(signs=signs, masks=masks, same=bpr.same_place(R_cw, t_cw),
                gap=int(round(PERIOD * FPS)) // 2)


def _jax_rows(anchors_pm, db_signs, db_masks, same, gap):
    """`scripts/bench_place_recognition.py:134-208` restated over the JAX
    package (its `evaluate`); also each query's (q, top-10, winner)."""
    jvocab.set_vocabulary(anchors_pm)
    try:
        K = db_signs.shape[0]
        db = jvocab.empty_database(max_kf=K)
        for k in range(K):
            db = jvocab.add_keyframe(db, jnp.asarray(db_signs[k]),
                                     jnp.asarray(db_masks[k]))
        hits1 = hits5 = hits10 = g_hits1 = n_q = 0
        ranks, queries = [], []
        for q in range(gap, F):
            allowed = np.zeros(K, bool)
            allowed[:F] = np.arange(F) <= q - gap
            allowed[F:] = True
            gt = np.zeros(K, bool)
            gt[:F] = same[q] & allowed[:F]
            if not gt.any():
                continue
            full_scores, full_idx = jvocab.query(
                db, jnp.asarray(db_signs[q]), jnp.asarray(db_masks[q]),
                jnp.asarray(~allowed), top_k=K)
            order = np.asarray(full_idx)
            sc = np.asarray(full_scores)
            n_q += 1
            hits1 += bool(gt[order[0]])
            hits5 += bool(gt[order[:5]].any())
            hits10 += bool(gt[order[:10]].any())
            rank = next((r for r, i in enumerate(order) if gt[i]), K)
            ranks.append(rank + 1)
            topn = order[:10]
            top_set = set(int(i) for i in topn)
            score_of = np.full(K, 0.0)
            score_of[order] = np.maximum(sc, 0.0)
            groups = []
            for cand in topn:
                seg = cand // F
                members = [m for m in range(max(seg * F, cand - G),
                                            min((seg + 1) * F, cand + G + 1))
                           if m in top_set]
                acc = float(sum(score_of[m] for m in members))
                best_m = max(members, key=lambda m: score_of[m])
                groups.append((acc, best_m))
            best_acc = max(a for a, _ in groups)
            retained = [m for a, m in groups if a >= 0.75 * best_acc]
            winner = max(retained, key=lambda m: score_of[m])
            g_hits1 += bool(gt[winner])
            queries.append((q, topn.tolist(), int(winner)))
    finally:
        jvocab.set_vocabulary(np.asarray(jvocab._anchors_np()))
    row = {"queries": n_q, "db_entries": int(K),
           "recall@1": round(hits1 / max(n_q, 1), 3),
           "recall@5": round(hits5 / max(n_q, 1), 3),
           "recall@10": round(hits10 / max(n_q, 1), 3),
           "group_recall@1": round(g_hits1 / max(n_q, 1), 3),
           "median_true_rank": float(np.median(ranks)) if ranks else None}
    return row, queries


def test_pr_scoring_equals_script_on_same_signs(banks):
    s, m = banks["signs"], banks["masks"]
    trained = tvocab.train_vocabulary(s[2 * F:2 * F + 3][m[2 * F:2 * F + 3]],
                                      seed=0)
    for anchors in (tvocab._anchors_np(), trained):
        ref, ref_q = _jax_rows(anchors, s, m, banks["same"], banks["gap"])
        got, got_q = bpr.evaluate(s, m, tvocab.Vocabulary(anchors),
                                  banks["same"], F, banks["gap"], G, "x")
        assert got.pop("codebook") == "x"
        assert got_q == ref_q
        assert got == ref
        assert ref["queries"] >= 8



def _jax_queries(n_frames, period=4.0, fps=FPS):
    """The script's query count: its geometry alone (the query bank's
    poses, the same-place relation, the half-period gap)."""
    _, R_cw, t_cw, _ = _jax_render(3, _jax_traj(0.0, period), n=n_frames)
    centers = -np.einsum("kji,kj->ki", R_cw, t_cw)
    axes = R_cw[:, 2, :]
    d_pos = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    d_ang = np.degrees(np.arccos(
        np.clip(np.einsum("ki,ji->kj", axes, axes), -1, 1)))
    same = (d_pos < 0.35) & (d_ang < 15.0)
    gap = int(round(period * fps)) // 2
    return sum(bool((same[q] & (np.arange(n_frames) <= q - gap)).any())
               for q in range(gap, n_frames))


@pytest.mark.slow
def test_pr_bench_end_to_end(tmp_path):
    """`main` at `--frames 40`: 144 frames extracted on the CPU and a
    codebook trained on 14k descriptors, ~15 s alone and ~95 s under the
    suite's six workers, so `slow` (phase 16d runs it on the card at its
    published size)."""
    out = tmp_path / "pr.json"
    blob = bpr.main(["--frames", "40", "--device", "cpu", "--out", str(out),
                     "--vocab-out", str(tmp_path / "vocab")])
    assert json.loads(out.read_text()) == json.loads(json.dumps(blob))
    assert set(blob) == set(_script_keys("bench_place_recognition",
                                         "aliased_room_distractors")) | {
        "card"}
    row_keys = _script_keys("bench_place_recognition", "group_recall@1")
    n_q = _jax_queries(40)
    assert [r["codebook"] for r in blob["results"]] == [
        "random", "trained(held-out scene)", "dbow2-format(shipped txt)"]
    for r in blob["results"]:
        assert list(r) == row_keys
        assert r["queries"] == n_q and r["db_entries"] == 120
    npz = tmp_path / "vocab" / "synth_orb_vocab.npz"
    txt = tmp_path / "vocab" / "synth_orb_vocab.txt"
    np.testing.assert_array_equal(jvocab.load_vocabulary(str(npz)),
                                  tvocab.load_vocabulary(str(npz)))
    np.testing.assert_array_equal(jdbow2.load_vocabulary_any(str(txt)),
                                  tdbow2.load_vocabulary_any(str(txt)))
    np.testing.assert_array_equal(tvocab.load_vocabulary(str(npz)),
                                  tdbow2.load_vocabulary_any(str(txt)))


def test_mapscale_scoring_equals_script_on_same_signs(banks):
    tree = thv.load_hvocab(bms.VOCAB)
    jtree = jhv.load_hvocab(bms.VOCAB)
    W, T = tree.n_words, 256
    s, m = banks["signs"], banks["masks"]
    words = torch.stack([thv.assign_words_tree(bms.tree_on(tree, "cpu"),
                                               torch.from_numpy(a),
                                               torch.from_numpy(b))
                         for a, b in zip(s, m)])
    jwords = np.stack([np.asarray(jhv.assign_words_tree(
        jtree, jnp.asarray(a), jnp.asarray(b))) for a, b in zip(s, m)])
    np.testing.assert_array_equal(words.numpy(), jwords)
    # `scripts/bench_pr_mapscale.py:113-125`, restated
    ids_all, tf_all = jax.jit(jax.vmap(lambda w: jhv.sparse_entry(w, W, T)))(
        jnp.asarray(jwords))
    ids_np = np.asarray(ids_all)
    df = np.zeros(W, np.float32)
    np.add.at(df, ids_np[ids_np >= 0], 1.0)
    K = len(jwords)
    jdb = jhv.SparseBowDB(word_ids=jnp.asarray(ids_np), tf=tf_all,
                          doc_freq=jnp.asarray(df), valid=jnp.ones(K, bool),
                          n=jnp.asarray(K, jnp.int32))
    db = bms.build_db(words, W, T)
    np.testing.assert_array_equal(db.word_ids.numpy(), ids_np)
    np.testing.assert_array_equal(db.doc_freq.numpy(), df)
    np.testing.assert_allclose(db.tf.numpy(), np.asarray(tf_all), rtol=1e-6)
    got = bms.evaluate(db, words, W, banks["same"], F, banks["gap"])
    ref = []
    for q, _ in got["ranked"]:
        allowed = np.zeros(K, bool)
        allowed[:F] = np.arange(F) <= q - banks["gap"]
        allowed[F:] = True
        _, idx = jhv.query_sparse(jdb, jnp.asarray(jwords[q]), W,
                                  exclude=jnp.asarray(~allowed), top_k=32)
        ref.append((q, np.asarray(idx)[:10].tolist()))
    assert got["ranked"] == ref
    assert got["queries"] >= 8


@pytest.mark.slow
def test_mapscale_end_to_end():
    """`main` at `--frames 40 --target-entries 200`: 200 frames extracted
    on the CPU, ~17 s alone and ~170 s under the suite's six workers, so
    `slow` (phase 16e runs it on the card)."""
    blob = bms.main(["--frames", "40", "--target-entries", "200",
                     "--device", "cpu"])
    assert list(blob) == _script_keys("bench_pr_mapscale",
                                      "query_cost_note") + ["card"]
    assert blob["queries"] == _jax_queries(40)
    assert blob["db_entries"] == 200 and blob["distractor_banks"] == 4
    assert blob["n_words"] == 10000 and blob["query_ms_median"] > 0




def _loads_flat(path):
    a, b = tvocab.load_vocabulary(path), jvocab.load_vocabulary(path)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (1024, 256) and np.all(np.abs(a) == 1.0)
    tvocab.Vocabulary(tdbow2.load_vocabulary_any(path))
    jdbow2.load_vocabulary_any(path)
    return a


_TRAINED = {}


def _same_training(capsys, path, port_path=None):
    """Reads the "training on N descriptors from F frames" line the run
    wrote to stderr and loads its file in both packages; with
    `port_path`, the port's run (read earlier) must have trained on the
    same frames and on descriptor counts within 1% of the script's (each
    package extracts its own features; they differ at a few BRIEF
    near-ties and FAST threshold crossings: measured 2 of 2190)."""
    line = [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("training on ")][-1]
    n_desc, n_frames = (int(w) for w in line.split() if w.isdigit())
    _loads_flat(path)
    _TRAINED[path] = (n_desc, n_frames)
    if port_path is not None:
        p_desc, p_frames = _TRAINED[port_path]
        assert p_frames == n_frames
        assert abs(p_desc - n_desc) <= 0.01 * n_desc


def test_train_vocab_synthetic(tmp_path, capsys):
    flags = ["--synthetic", "--max-frames", "4"]
    out = str(tmp_path / "port.npz")
    assert train_vocab.main([*flags, "--device", "cpu", "--out", out]) == out
    _same_training(capsys, out)
    with _script_run(["train_vocab.py", *flags, "--out",
                str(tmp_path / "jax.npz")]) as buf:
        assert _script("train_vocab").main() == 0
    assert buf.getvalue().strip() == str(tmp_path / "jax.npz")
    _same_training(capsys, str(tmp_path / "jax.npz"), out)
    # the hierarchical branch with its DBoW2 text, small
    tree_out, txt = str(tmp_path / "tree.npz"), str(tmp_path / "tree.txt")
    train_vocab.main(["--synthetic", "--max-frames", "2", "--scenes", "2",
                      "--hierarchical", "--branching", "4", "--depth", "2",
                      "--export-dbow2-txt", txt, "--device", "cpu",
                      "--out", tree_out])
    t_tree, j_tree = thv.load_hvocab(tree_out), jhv.load_hvocab(tree_out)
    assert (t_tree.k, t_tree.depth) == (j_tree.k, j_tree.depth) == (4, 2)
    for a, b in zip(t_tree.levels, j_tree.levels):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert isinstance(tdbow2.load_vocabulary_any(txt), (np.ndarray,
                                                        thv.HierVocab))
    jdbow2.load_vocabulary_any(txt)


def test_train_vocab_euroc(tmp_path, capsys):
    from orb_slam3_ros2_tpu_torch.io import recording
    from orb_slam3_ros2_tpu_torch.io import synthetic

    images = synthetic.render_sequence(n_frames=4, width=320, height=240,
                                       fx=260.0, fy=260.0, fps=10.0,
                                       seed=5)[0]
    rec = recording.SequenceRecorder(str(tmp_path / "seq"))
    for i, img in enumerate(images):
        t = 1.0 + 0.1 * i
        rec.add_imu(t - 0.05, [0.0, 0.0, 0.0], [0.0, 9.81, 0.0])
        rec.add_frame(np.clip(img, 0, 255).astype(np.uint8), t)
    root = rec.close()
    flags = ["--dataset", root, "--max-frames", "4"]
    out = str(tmp_path / "port.npz")
    train_vocab.main([*flags, "--device", "cpu", "--out", out])
    _same_training(capsys, out)
    with _script_run(["train_vocab.py", *flags, "--out",
                str(tmp_path / "jax.npz")]):
        assert _script("train_vocab").main() == 0
    _same_training(capsys, str(tmp_path / "jax.npz"), out)


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--synthetic", "--out", "x.npz"]):
        mod = bpr if not argv else train_vocab
        with pytest.raises(SystemExit):
            mod.main(argv)
    with pytest.raises(SystemExit):
        bms.main([])
    for mod in (bpr, bms):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            mod.run()
