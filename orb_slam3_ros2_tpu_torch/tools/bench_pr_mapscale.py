"""Place-recognition recall at map scale on the card: a ~10k-entry
database, the 10^4-word hierarchical vocabulary, sparse forward-file
retrieval (`loop/hvocab.py`).

    python -m orb_slam3_ros2_tpu_torch.tools.bench_pr_mapscale
        [--target-entries 10200] [--out JSON] [--device cuda|cpu]

Port of `scripts/bench_pr_mapscale.py`. The database holds the periodic
query room (600 frames at 320x240), the same room along a detuned
trajectory, and distractor rooms (seed 9, 17, ...) until it has
`--target-entries` frames. Every frame's 600 ORB features get their words
by walking the shipped tree (`vocab/synth_orb_vocab_h10k.npz`), the
sparse database (each entry's top-256 words) is built in one pass, and
each query takes its 32 best entries with `query_sparse`, whose cost is
O(entries x top-t) and does not grow with the vocabulary.

The sizes, seeds and keys are the script's. The script extracts in
jitted batches of 32 frames (the last one padded); here each frame is
extracted and assigned on the device as it comes, so there is no padding.
`query_ms_median` is the median host time of one query between two
`torch.cuda.synchronize()` calls (in the script, reading the ids back to
the host was that sync). `--platform` gives way to `--device`, and the
report adds `card` (the card's `name` and `power.limit`, as `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` gives them).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.tools.bench_place_recognition import (
    make_extractor, render, room_banks, same_place, trajectory)
from orb_slam3_ros2_tpu_torch.tools.cli import (REPO, add_device,
                                                check_device, device_of,
                                                sync)
from orb_slam3_ros2_tpu_torch.tools.roofline import card

VOCAB = os.path.join(REPO, "vocab", "synth_orb_vocab_h10k.npz")
QUERY_COST_NOTE = (
    "scoring is O(K*T) gather+reduce against the query's dense "
    "(W,) scatter - no (K,W) structure exists; W enters only "
    "through the one-time (W,) idf vector, so query cost is "
    "sub-linear (near-constant) in vocabulary size")


def make_banks(F: int, period: float, fps: float, target_entries: int):
    """(banks of images, R_cw, t_cw of the query bank): the query room
    (seed 3) and the aliased bank (seed 3, detuned), as
    `bench_place_recognition.room_banks` renders them, then distractor
    rooms seed 9, 17, ... (trajectory phase 0.5 + 0.01 seed) until the
    banks hold `target_entries` frames."""
    images, R_cw, t_cw, alias_imgs = room_banks(F, period, fps)
    banks = [images, alias_imgs]
    seed = 9
    while sum(len(b) for b in banks) < target_entries:
        banks.append(render(F, fps, seed,
                            trajectory(0.5 + 0.01 * seed, period))[0])
        seed += 8
    return banks, R_cw, t_cw


def tree_on(tree, device):
    """The tree with its levels as f32 tensors on `device`."""
    from orb_slam3_ros2_tpu_torch.loop import hvocab as hv

    return hv.HierVocab(
        levels=tuple(torch.as_tensor(np.asarray(lv, np.float32),
                                     device=device) for lv in tree.levels),
        k=tree.k, depth=tree.depth)


def words_of(extract, tree, images, device) -> torch.Tensor:
    """(n, N) int32 word ids of every image's features (-1 masked)."""
    from orb_slam3_ros2_tpu_torch.loop import hvocab as hv

    out = []
    for img in images:
        f = extract(torch.from_numpy(np.asarray(img, np.float32)).to(device))
        out.append(hv.assign_words_tree(tree, f.signs, f.mask))
    return torch.stack(out)


def build_db(words_all: torch.Tensor, W: int, T: int):
    """The sparse database of every entry, in one pass: each entry's
    top-T (word, tf), the document counts over all entries."""
    from orb_slam3_ros2_tpu_torch.loop import hvocab as hv

    K = words_all.shape[0]
    ids, tf = zip(*(hv.sparse_entry(w, W, T) for w in words_all))
    ids, tf = torch.stack(ids), torch.stack(tf)
    df = hv.word_histogram(ids.reshape(-1), W)
    return hv.SparseBowDB(
        word_ids=ids, tf=tf, doc_freq=df,
        valid=torch.ones(K, dtype=torch.bool, device=ids.device),
        n=torch.tensor(K, dtype=torch.int32, device=ids.device))


def evaluate(db, words_all: torch.Tensor, W: int, same: np.ndarray, F: int,
             gap: int, top_k: int = 32) -> dict:
    """Recall over the queries q in [gap, F) with a true place among the
    query frames up to q - gap; every query timed between two syncs.
    `ranked` holds each query's (q, top-10 ids)."""
    from orb_slam3_ros2_tpu_torch.loop import hvocab as hv

    dev = words_all.device
    K = words_all.shape[0]
    hits1 = hits5 = hits10 = n_q = 0
    ranks, q_times, ranked = [], [], []
    for q in range(gap, F):
        allowed = np.zeros(K, bool)
        allowed[:F] = np.arange(F) <= q - gap
        allowed[F:] = True
        gt = np.zeros(K, bool)
        gt[:F] = same[q] & allowed[:F]
        if not gt.any():
            continue
        exclude = torch.from_numpy(~allowed).to(dev)
        sync(dev)
        t0 = time.perf_counter()
        _, idx = hv.query_sparse(db, words_all[q], W, exclude=exclude,
                                 top_k=top_k)
        sync(dev)
        q_times.append(time.perf_counter() - t0)
        idx = idx.cpu().numpy()
        n_q += 1
        if gt[idx[0]]:
            hits1 += 1
        if gt[idx[:5]].any():
            hits5 += 1
        if gt[idx[:10]].any():
            hits10 += 1
        r = next((r for r, i in enumerate(idx) if gt[i]), top_k)
        ranks.append(r + 1)
        ranked.append((q, idx[:10].tolist()))
    return dict(queries=n_q, hits=(hits1, hits5, hits10), ranks=ranks,
                q_times=q_times, ranked=ranked)


def run(F: int = 600, target_entries: int = 10200, period: float = 4.0,
        fps: float = 10.0, top_t: int = 256, vocab: str = VOCAB,
        device="cuda") -> dict:
    from orb_slam3_ros2_tpu_torch.loop import hvocab as hv

    dev = check_device(device)
    tree = hv.load_hvocab(vocab)
    W = tree.n_words
    t_render0 = time.time()
    banks, R_cw, t_cw = make_banks(F, period, fps, target_entries)
    print(f"rendered {sum(len(b) for b in banks)} frames "
          f"({len(banks)} banks) in {time.time()-t_render0:.0f}s",
          file=sys.stderr)

    t_ex0 = time.time()
    extract, tree_d = make_extractor(), tree_on(tree, dev)
    words_all = torch.cat([words_of(extract, tree_d, b, dev) for b in banks])
    K = words_all.shape[0]
    sync(dev)
    print(f"extracted+assigned {K} frames in {time.time()-t_ex0:.0f}s",
          file=sys.stderr)
    db = build_db(words_all, W, top_t)
    gap = int(round(period * fps)) // 2
    ev = evaluate(db, words_all, W, same_place(R_cw, t_cw), F, gap)
    n_q = ev["queries"]
    hits1, hits5, hits10 = ev["hits"]
    return {
        "vocab": os.path.basename(vocab),
        "n_words": int(W),
        "tree": f"k={tree.k} depth={tree.depth}",
        "db_entries": int(K),
        "aliased_room_distractors": F,
        "distractor_banks": len(banks) - 1,
        "top_t": top_t,
        "queries": n_q,
        "recall@1": round(hits1 / max(n_q, 1), 3),
        "recall@5": round(hits5 / max(n_q, 1), 3),
        "recall@10": round(hits10 / max(n_q, 1), 3),
        "median_true_rank": (float(np.median(ev["ranks"])) if ev["ranks"]
                             else None),
        "query_ms_median": round(float(np.median(ev["q_times"])) * 1e3, 2)
        if ev["q_times"] else None,
        "query_cost_note": QUERY_COST_NOTE,
        "card": card(dev),
    }


def main(argv=None) -> dict:
    """Runs the bench; prints the report, writes `--out` when given, and
    returns it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--target-entries", type=int, default=10200)
    ap.add_argument("--period", type=float, default=4.0)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--top-t", type=int, default=256)
    ap.add_argument("--vocab", default=VOCAB)
    ap.add_argument("--out", default=None)
    add_device(ap)
    args = ap.parse_args(argv)
    dev = device_of(ap, args)
    report = run(args.frames, args.target_entries, args.period, args.fps,
                 args.top_t, args.vocab, dev)
    print(json.dumps(report, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
