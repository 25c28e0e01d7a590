"""DBoW2 text-vocabulary (ORBvoc.txt) reader and writer.

Copied from `orb_slam3_ros2_tpu/loop/dbow2.py` (numpy only). The format
(DBoW2 `TemplatedVocabulary::saveToTextFile`):

    line 0:    k L scoring_type weighting_type        (e.g. "10 6 0 0")
    line i>0:  parent_id is_leaf b0 b1 ... b31 weight

one line per non-root node, ids by line order from 1, parents before
children. The tree is flattened to a W-word codebook by taking the level
whose node count is nearest W (heaviest nodes first) and padding with the
default codebook.
"""

from __future__ import annotations

import numpy as np

from orb_slam3_ros2_tpu_torch.loop import hvocab as hv
from orb_slam3_ros2_tpu_torch.loop import vocab as vocab_mod


def _bytes_to_signs(byte_rows: np.ndarray) -> np.ndarray:
    """(M, 32) uint8 descriptor bytes -> (M, 256) ±1 float32 (little-endian
    bit order within each byte)."""
    bits = np.unpackbits(byte_rows.astype(np.uint8), axis=1,
                         bitorder="little")
    return np.where(bits > 0, 1.0, -1.0).astype(np.float32)


def load_dbow2_text(path: str, n_words: int = vocab_mod.N_WORDS,
                    seed: int = 7) -> np.ndarray:
    """Parse a DBoW2 text vocabulary into a (n_words, 256) ±1 codebook."""
    with open(path, "r") as f:
        header = f.readline().split()
        if len(header) < 2:
            raise ValueError(f"{path}: not a DBoW2 text vocabulary")
        rows = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if rows.size == 0:
        raise ValueError(f"{path}: empty vocabulary")
    if rows.shape[1] != 35:
        raise ValueError(
            f"{path}: expected 35 columns (parent is_leaf 32-bytes weight), "
            f"got {rows.shape[1]}")
    n_nodes = rows.shape[0]
    parent = rows[:, 0].astype(np.int64)
    byte_rows = rows[:, 2:34]
    weight = rows[:, 34]
    depth = np.zeros(n_nodes + 1, np.int32)
    for i in range(n_nodes):
        depth[i + 1] = depth[parent[i]] + 1
    node_depth = depth[1:]
    levels, counts = np.unique(node_depth, return_counts=True)
    best = levels[int(np.argmin(np.abs(counts - n_words)))]
    order = np.lexsort((-weight, np.abs(node_depth - best)))
    chosen = order[:n_words]
    signs = _bytes_to_signs(byte_rows[chosen])
    if len(chosen) < n_words:
        pad = vocab_mod._anchors_np(n_words, seed=seed)[len(chosen):]
        signs = np.concatenate([signs, pad], axis=0)
    return signs.astype(np.float32)


def save_dbow2_text(path: str, anchors_pm: np.ndarray,
                    k: int = 10, L: int = 1) -> str:
    """Write a codebook as a single-level DBoW2 text vocabulary."""
    A = np.asarray(anchors_pm)
    byte_rows = np.packbits((A > 0).astype(np.uint8), axis=1,
                            bitorder="little")
    with open(path, "w") as f:
        f.write(f"{k} {L} 0 0\n")
        for r in byte_rows:
            f.write("0 1 " + " ".join(str(int(b)) for b in r) + " 1.0\n")
    return path


def load_vocabulary_any(path: str):
    """A DBoW2 `.txt`, a flat codebook `.npz` ((W, 256) array) or a
    hierarchical `.npz` (`hvocab.HierVocab`)."""
    if path.endswith(".txt"):
        return load_dbow2_text(path)
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        if "k" in z and "depth" in z:
            depth = int(z["depth"])
            levels = tuple(z[f"level{j}"].astype(np.float32)
                           for j in range(depth))
            return hv.HierVocab(levels=levels, k=int(z["k"]), depth=depth)
        return z["anchors"].astype(np.float32)
