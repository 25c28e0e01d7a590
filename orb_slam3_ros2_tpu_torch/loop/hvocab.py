"""Hierarchical BoW vocabulary and the sparse map-scale database.

Port of `orb_slam3_ros2_tpu/loop/hvocab.py`. A k-ary tree of ±1 anchors
(depth d, k^d leaf words) assigns words level by level with a gather and an
(N, k) dot-product argmax; the sparse database keeps each entry's top-T
(word id, tf) pairs and scores all entries with a (K, T) gather and a row
reduction, independent of the vocabulary size.

Training, the npz format and the DBoW2 text export are numpy, copied from
the JAX module. A `HierVocab`'s levels may be numpy arrays or tensors; the
walk moves them to the descriptors' device (`loop.vocab.Vocabulary` keeps
them there).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.ops import matcher

N_BITS = 256


class HierVocab(NamedTuple):
    """k-ary tree of ±1 anchor descriptors: levels[j] (k^j, k, 256) holds
    the k children of every node at depth j; word id = flattened leaf
    index."""

    levels: tuple
    k: int
    depth: int

    @property
    def n_words(self) -> int:
        return self.k ** self.depth


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def train_hierarchical(signs: np.ndarray, k: int = 10, depth: int = 4,
                       iters: int = 6, seed: int = 0) -> HierVocab:
    """Hierarchical k-majority clustering of (M, 256) ±1 descriptors; each
    level clusters every node's members, empty clusters re-seed from
    random members (copied from the JAX module, numpy)."""
    rng = np.random.default_rng(seed)
    S = np.ascontiguousarray(np.asarray(signs, np.float32))
    M = S.shape[0]
    assign = np.zeros(M, np.int64)
    levels = []
    for j in range(depth):
        n_nodes = k ** j
        anchors_j = np.zeros((n_nodes, k, N_BITS), np.float32)
        new_assign = np.zeros_like(assign)
        order = np.argsort(assign, kind="stable")
        bounds = np.searchsorted(assign[order], np.arange(n_nodes + 1))
        for node in range(n_nodes):
            idx = order[bounds[node]:bounds[node + 1]]
            Sm = S[idx]
            if len(idx) >= k:
                A = Sm[rng.permutation(len(idx))[:k]].copy()
            else:
                A = S[rng.integers(0, M, k)].copy()
            for _ in range(iters):
                if len(idx) == 0:
                    break
                w = np.argmax(Sm @ A.T, axis=1)
                sums = np.zeros((k, N_BITS), np.float32)
                np.add.at(sums, w, Sm)
                counts = np.bincount(w, minlength=k)
                upd = np.where(sums != 0, np.sign(sums), A)
                A = np.where(counts[:, None] > 0, upd, A)
                empty = np.where(counts == 0)[0]
                if len(empty):
                    A[empty] = Sm[rng.integers(0, len(idx), len(empty))] \
                        if len(idx) else S[rng.integers(0, M, len(empty))]
            anchors_j[node] = A
            if len(idx):
                w = np.argmax(Sm @ A.T, axis=1)
                new_assign[idx] = node * k + w
        levels.append(anchors_j)
        assign = new_assign
    return HierVocab(levels=tuple(levels), k=k, depth=depth)


def assign_words_tree(vocab: HierVocab, signs: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """(N, 256) ±1 -> (N,) int32 leaf word ids by the tree walk (-1 where
    masked); the first maximum among a node's children, as `jnp.argmax`."""
    N = signs.shape[0]
    node = torch.zeros((N,), dtype=torch.long, device=signs.device)
    for j in range(vocab.depth):
        ch = torch.as_tensor(vocab.levels[j], dtype=torch.float32,
                             device=signs.device)
        sim = torch.einsum("nd,nkd->nk", signs, ch[node])
        node = node * vocab.k + torch.argmax(sim, dim=-1)
    return torch.where(mask, node.to(torch.int32), -1)


def flat_leaves(vocab: HierVocab) -> np.ndarray:
    """(W, 256) leaf anchors in word-id order."""
    return _np(vocab.levels[-1]).reshape(-1, N_BITS)


def save_hvocab(path: str, vocab: HierVocab) -> str:
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez_compressed(
        path, k=vocab.k, depth=vocab.depth,
        **{f"level{j}": _np(v) for j, v in enumerate(vocab.levels)})
    return path


def load_hvocab(path: str) -> HierVocab:
    if not path.endswith(".npz"):
        path += ".npz"
    z = np.load(path)
    depth = int(z["depth"])
    levels = tuple(z[f"level{j}"].astype(np.float32) for j in range(depth))
    return HierVocab(levels=levels, k=int(z["k"]), depth=depth)


def export_dbow2_text(vocab: HierVocab, path: str) -> str:
    """Write the tree in DBoW2's text format (`k L score_type
    weight_type`, then one node per line: parent_id is_leaf 32 descriptor
    bytes weight), nodes numbered breadth-first from 1."""
    k, depth = vocab.k, vocab.depth
    lines = [f"{k} {depth} 0 0\n"]
    node_id = 0
    parent_of = {(-1, 0): 0}
    for j in range(depth):
        anchors_j = _np(vocab.levels[j])
        for node in range(anchors_j.shape[0]):
            parent = parent_of[(j - 1, node)]
            for c in range(k):
                node_id += 1
                parent_of[(j, node * k + c)] = node_id
                bits = (anchors_j[node, c] > 0).astype(np.uint8).reshape(
                    32, 8)
                by = (bits << np.arange(8, dtype=np.uint8)[None, :]).sum(
                    1).astype(np.uint8)
                is_leaf = 1 if j == depth - 1 else 0
                lines.append(f"{parent} {is_leaf} "
                             + " ".join(str(int(x)) for x in by) + " 0.0\n")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


# --------------------------------------------------------------------------
# sparse forward-file database


class SparseBowDB(NamedTuple):
    """Fixed-capacity sparse BoW database: per entry, its top-T (word,
    tf) pairs."""

    word_ids: torch.Tensor  # (K, T) int32, -1 padded
    tf: torch.Tensor  # (K, T) f32 L2-normalized term frequencies
    doc_freq: torch.Tensor  # (W,) f32 document counts
    valid: torch.Tensor  # (K,) bool
    n: torch.Tensor  # () int32


def empty_sparse_db(max_entries: int, n_words: int, top_t: int = 256,
                    device="cpu") -> SparseBowDB:
    return SparseBowDB(
        word_ids=torch.full((max_entries, top_t), -1, dtype=torch.int32,
                            device=device),
        tf=torch.zeros((max_entries, top_t), dtype=torch.float32,
                       device=device),
        doc_freq=torch.zeros((n_words,), dtype=torch.float32, device=device),
        valid=torch.zeros((max_entries,), dtype=torch.bool, device=device),
        n=torch.zeros((), dtype=torch.int32, device=device))


def word_histogram(words: torch.Tensor, n_words: int) -> torch.Tensor:
    """(W,) f32 counts of the word ids >= 0 (the others add into a dropped
    slot); adds of 1.0 are exact in any order."""
    hist = torch.zeros((n_words + 1,), dtype=torch.float32,
                       device=words.device)
    hist.index_add_(0, torch.where(words >= 0, words, n_words).long(),
                    torch.ones(words.shape, dtype=torch.float32,
                               device=words.device))
    return hist[:n_words]


def sparse_entry(words: torch.Tensor, n_words: int, top_t: int):
    """(N,) word ids (-1 masked) -> (ids (T,) int32, tf (T,)): the top-T
    of the histogram, ties to the lower word id as `lax.top_k`."""
    hist = word_histogram(words, n_words)
    k = min(top_t, n_words)
    vals, ids = matcher.top_k_stable(hist, k)
    if k < top_t:
        vals = torch.nn.functional.pad(vals, (0, top_t - k))
        ids = torch.nn.functional.pad(ids, (0, top_t - k))
    ids = torch.where(vals > 0, ids.to(torch.int32), -1)
    nrm = torch.sqrt(torch.sum(vals * vals).clamp(min=1e-12))
    return ids, vals / nrm


def add_entry(db: SparseBowDB, words: torch.Tensor,
              n_words: int) -> SparseBowDB:
    """Insert one frame's word set (from `assign_words_tree`) at slot n."""
    E, T = db.word_ids.shape
    ids, tf = sparse_entry(words, n_words, T)
    ok = db.n < E
    slot = torch.clamp(db.n, max=E - 1).reshape(1).long()
    df_inc = word_histogram(torch.where(ok, ids, -1), n_words)
    old_ids = db.word_ids.index_select(0, slot)[0]
    old_tf = db.tf.index_select(0, slot)[0]
    old_valid = db.valid.index_select(0, slot)
    return SparseBowDB(
        word_ids=db.word_ids.clone().index_copy_(
            0, slot, torch.where(ok, ids, old_ids)[None]),
        tf=db.tf.clone().index_copy_(0, slot,
                                     torch.where(ok, tf, old_tf)[None]),
        doc_freq=db.doc_freq + df_inc,
        valid=db.valid.clone().index_copy_(0, slot, old_valid | ok),
        n=db.n + ok.to(torch.int32))


def query_sparse(db: SparseBowDB, words: torch.Tensor, n_words: int,
                 exclude=None, top_k: int = 5):
    """Cosine similarity of idf-weighted tf vectors of one query frame
    against every entry, with no (K, W) structure: (scores, ids)."""
    T = db.word_ids.shape[1]
    dev = db.tf.device
    idf = torch.log(db.n.to(torch.float32).clamp(min=1.0)
                    / db.doc_freq.clamp(min=1.0))
    q_ids, q_tf = sparse_entry(words, n_words, T)
    q_safe = q_ids.clamp(0, n_words - 1).long()
    qv = torch.zeros((n_words + 1,), dtype=torch.float32, device=dev)
    # the ids >= 0 are distinct (a top-k of a histogram); the rest land in
    # the dropped slot
    qv.scatter_(0, torch.where(q_ids >= 0, q_ids, n_words).long(),
                q_tf * idf[q_safe])
    qv = qv[:n_words]
    qv = qv / torch.linalg.norm(qv).clamp(min=1e-8)
    ids_safe = db.word_ids.clamp(0, n_words - 1).long()
    w_entry = db.tf * idf[ids_safe] * (db.word_ids >= 0)
    raw = torch.sum(qv[ids_safe] * w_entry, dim=-1)
    nrm = torch.sqrt(torch.sum(w_entry * w_entry, dim=-1).clamp(min=1e-12))
    scores = raw / nrm
    ok = db.valid
    if exclude is not None:
        ok = ok & ~exclude.to(dev)
    vals, ids = matcher.top_k_stable(torch.where(ok, scores, -1.0), top_k)
    return vals, ids.to(torch.int32)
