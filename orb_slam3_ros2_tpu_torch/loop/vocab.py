"""Place recognition: a flat BoW vocabulary and the keyframe database.

Port of `orb_slam3_ros2_tpu/loop/vocab.py`. A vocabulary of W anchor
descriptors (±1 vectors) assigns every feature of a frame its word with one
(N, 256) x (256, W) product and a first-maximum argmax; a frame's global
descriptor is its L2-normalized (idf-weighted) word histogram; retrieval is
one (K, W) x (W,) product and a top-k with ties to the lower slot, as
`lax.top_k` orders them.

Where the JAX module keeps the active codebook in process-wide globals
(`set_vocabulary`), the port has a `Vocabulary` object that the System owns
and passes to every BoW function: anchors as a device tensor, and
optionally a hierarchical tree (`hvocab.HierVocab`) whose walk then assigns
the words. There is no module state.

`add_keyframe` takes the slot to write. The JAX System writes slot `db.n`,
which in monocular runs one row per keyframe after the two initializer
keyframes (they get none), so its slot s describes keyframe s + 2; the port
writes keyframe k's row at slot k (ROADMAP.md §3).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.loop import hvocab as hv
from orb_slam3_ros2_tpu_torch.ops import matcher, orb_descriptor

N_WORDS = 1024
N_BITS = 256


@functools.lru_cache(maxsize=None)
def _anchors_np(n_words: int = N_WORDS, seed: int = 7) -> np.ndarray:
    """(W, 256) ±1 anchor descriptors (the default codebook); copied from
    the JAX module, numpy only."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random((n_words, N_BITS)) < 0.5, -1.0, 1.0).astype(
        np.float32)


class Vocabulary:
    """The active codebook: `anchors` (W, 256) ±1 on `device`, and `tree`
    when a hierarchical vocabulary assigns the words (its levels on the
    same device; `anchors` are then its leaves in word-id order)."""

    def __init__(self, anchors_pm=None, device="cpu"):
        """`anchors_pm`: None (the default codebook), a (W, 256) ±1 array,
        or a `hvocab.HierVocab`; as the JAX `set_vocabulary` accepts."""
        self.device = torch.device(device)
        self.tree: Optional[hv.HierVocab] = None
        if isinstance(anchors_pm, hv.HierVocab):
            self.tree = hv.HierVocab(
                levels=tuple(torch.as_tensor(np.asarray(lv, np.float32),
                                             device=self.device)
                             for lv in anchors_pm.levels),
                k=anchors_pm.k, depth=anchors_pm.depth)
            a = hv.flat_leaves(anchors_pm)
        elif anchors_pm is None:
            a = _anchors_np()
        else:
            a = np.asarray(anchors_pm, np.float32)
            if a.ndim != 2 or a.shape[1] != N_BITS:
                raise ValueError(
                    f"vocabulary must be (W, {N_BITS}) ±1, got {a.shape}")
            if not np.all(np.abs(a) == 1.0):
                raise ValueError("vocabulary anchors must be ±1 sign vectors")
        self.anchors = torch.as_tensor(np.asarray(a, np.float32),
                                       device=self.device)

    @property
    def n_words(self) -> int:
        return int(self.anchors.shape[0])


def save_vocabulary(path: str, anchors_pm: np.ndarray) -> str:
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez_compressed(path, anchors=np.asarray(anchors_pm, np.float32))
    return path


def load_vocabulary(path: str) -> np.ndarray:
    if not path.endswith(".npz"):
        path = path + ".npz"
    return np.load(path)["anchors"].astype(np.float32)


def train_vocabulary(signs: np.ndarray, n_words: int = N_WORDS,
                     iters: int = 8, seed: int = 0) -> np.ndarray:
    """k-majority clustering of (M, 256) ±1 descriptors into an
    (n_words, 256) ±1 codebook; copied from the JAX module (numpy)."""
    rng = np.random.default_rng(seed)
    S = np.asarray(signs, np.float32)
    M = S.shape[0]
    if M < n_words:
        raise ValueError(f"need >= {n_words} descriptors, got {M}")
    A = S[rng.permutation(M)[:n_words]].copy()
    for _ in range(iters):
        w = np.argmax(S @ A.T, axis=1)
        sums = np.zeros((n_words, S.shape[1]), np.float32)
        np.add.at(sums, w, S)
        counts = np.bincount(w, minlength=n_words)
        upd = np.where(sums != 0, np.sign(sums), A)
        A = np.where(counts[:, None] > 0, upd, A)
        empty = np.where(counts == 0)[0]
        if len(empty):
            A[empty] = S[rng.integers(0, M, len(empty))]
    return A.astype(np.float32)


def assign_words(vocab: Vocabulary, signs: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """(N, 256) ±1 descriptors -> (N,) int32 word ids (masked -> -1): the
    tree walk when `vocab` has a tree, else the flat product's first
    maximum (the ±1 dot products are integers, exact in f32, so ties are
    frequent and broken as `jnp.argmax` breaks them)."""
    if vocab.tree is not None:
        return hv.assign_words_tree(vocab.tree, signs, mask)
    sim = signs @ vocab.anchors.T  # (N, W)
    w = torch.argmax(sim, dim=-1).to(torch.int32)
    return torch.where(mask, w, -1)


def bow_vector(vocab: Vocabulary, signs: torch.Tensor, mask: torch.Tensor,
               idf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L2-normalized (idf-weighted) word histogram of one frame: (W,)."""
    hist = hv.word_histogram(assign_words(vocab, signs, mask), vocab.n_words)
    if idf is not None:
        hist = hist * idf
    return hist / torch.linalg.norm(hist).clamp(min=1e-8)


class BowDatabase(NamedTuple):
    """Fixed-capacity keyframe BoW database (field order as in the JAX
    package: the Atlas file stores the leaves in this order)."""

    vecs: torch.Tensor  # (K, W) normalized bow vectors
    valid: torch.Tensor  # (K,) bool
    doc_freq: torch.Tensor  # (W,) word document counts (for idf)
    n: torch.Tensor  # () int32 rows held


def empty_database(max_kf: int, n_words: int = N_WORDS,
                   device="cpu") -> BowDatabase:
    return BowDatabase(
        vecs=torch.zeros((max_kf, n_words), dtype=torch.float32,
                         device=device),
        valid=torch.zeros((max_kf,), dtype=torch.bool, device=device),
        doc_freq=torch.zeros((n_words,), dtype=torch.float32, device=device),
        n=torch.zeros((), dtype=torch.int32, device=device))


def add_keyframe(db: BowDatabase, vocab: Vocabulary, signs: torch.Tensor,
                 mask: torch.Tensor, slot) -> BowDatabase:
    """Write one keyframe's row at `slot` (an int or a 0-dim tensor: the
    keyframe's id). A slot past the capacity writes nothing. Rewriting a
    held slot replaces its document counts."""
    K = db.vecs.shape[0]
    dev = db.vecs.device
    vec = bow_vector(vocab, signs, mask)
    slot = torch.as_tensor(slot, device=dev).reshape(()).long()
    ok = slot < K
    k = torch.clamp(slot, max=K - 1).reshape(1)
    old = db.vecs.index_select(0, k)[0]
    was = db.valid.index_select(0, k)[0]
    new_row = torch.where(ok, vec, old)
    df = (db.doc_freq + torch.where(ok, (vec > 0).float(), 0.0)
          - torch.where(ok & was, (old > 0).float(), 0.0))
    return BowDatabase(
        vecs=db.vecs.clone().index_copy_(0, k, new_row[None]),
        valid=db.valid.clone().index_copy_(0, k, (was | ok).reshape(1)),
        doc_freq=df,
        n=db.n + (ok & ~was).to(torch.int32))


def place_rows(db: BowDatabase, src_db: BowDatabase, src, dst) -> BowDatabase:
    """`db` with rows `dst` replaced by `src_db`'s rows `src` (keyframe
    ids before and after a compaction or a merge); the document counts
    and `n` recounted from the valid rows."""
    dev = db.vecs.device
    src = torch.as_tensor(src, dtype=torch.long, device=dev)
    dst = torch.as_tensor(dst, dtype=torch.long, device=dev)
    vecs = db.vecs.clone().index_copy_(0, dst, src_db.vecs[src])
    valid = db.valid.clone().index_copy_(0, dst, src_db.valid[src])
    return BowDatabase(
        vecs=vecs, valid=valid,
        doc_freq=((vecs > 0) & valid[:, None]).sum(0).to(torch.float32),
        n=valid.sum().to(torch.int32))


def rows_from_keyframes(vocab: Vocabulary, kf_bits: torch.Tensor,
                        kf_feat_valid: torch.Tensor,
                        n_kf: int) -> BowDatabase:
    """A database with keyframe k's row at slot k for k < n_kf, each the
    BoW vector of the keyframe's stored descriptors ((K, F, 8) packed
    words, (K, F) valid), and the document counts recounted: the rows
    `add_keyframe` writes, since a keyframe stores the features its row
    was made from."""
    K = kf_feat_valid.shape[0]
    dev = kf_bits.device
    db = empty_database(K, vocab.n_words, dev)
    if n_kf == 0:
        return db
    vecs = torch.stack([
        bow_vector(vocab, orb_descriptor.signs_from_bits(kf_bits[k]),
                   kf_feat_valid[k]) for k in range(n_kf)])
    return place_rows(db, db._replace(
        vecs=vecs, valid=torch.ones(n_kf, dtype=torch.bool, device=dev)),
        torch.arange(n_kf), torch.arange(n_kf))


def query(db: BowDatabase, vocab: Vocabulary, signs: torch.Tensor,
          mask: torch.Tensor, exclude: torch.Tensor, top_k: int = 5):
    """Top-k similar keyframe slots: (scores (k,), ids (k,) int32).
    `exclude` (K,) bool masks forbidden slots (the covisible neighbourhood
    and a recent window, for loop candidates); unusable slots score -1."""
    idf = torch.log(db.n.to(torch.float32).clamp(min=1.0)
                    / db.doc_freq.clamp(min=1.0))
    q = bow_vector(vocab, signs, mask, idf)
    vecs = db.vecs * idf[None, :]
    vecs = vecs / torch.linalg.norm(vecs, dim=-1, keepdim=True).clamp(
        min=1e-8)
    scores = vecs @ q
    ok = db.valid & ~exclude.to(db.valid.device)
    vals, ids = matcher.top_k_stable(torch.where(ok, scores, -1.0), top_k)
    return vals, ids.to(torch.int32)


def exclude_window(max_kf: int, lo: int, hi: int,
                   device="cpu") -> torch.Tensor:
    """(K,) bool mask excluding slot ids in [lo, hi] (temporal guard)."""
    ids = torch.arange(max_kf, device=device)
    return (ids >= lo) & (ids <= hi)
