"""Place-recognition recall on the card: random, trained and DBoW2-format
codebooks, plain top-k against covisibility-group accumulation.

    python -m orb_slam3_ros2_tpu_torch.tools.bench_place_recognition
        [--frames 600] [--out JSON] [--vocab-out build/vocab]
        [--device cuda|cpu]

Port of `scripts/bench_place_recognition.py`. The query sequence flies a
strictly periodic trajectory (period `--period` s) through a rendered room,
so every late frame revisits an early place. The database holds it, an
equal-length sequence through the same room along a detuned trajectory
(views that look like the true place and are not: perceptual aliasing),
and one through another room. Every query frame past half a period is
scored against the earlier query frames and every distractor two ways:
plain per-frame top-k, and the DetectLoopCandidates-style group rule
(`group_winner`). Three codebooks: the default random one
(`vocab._anchors_np()`), one trained on a held-out scene (seed 11, 24
frames), and that one written in the DBoW2 text format and read back. The
trained codebook is exported as `synth_orb_vocab.{npz,txt}` under
`--vocab-out`: `build/vocab/` by default, never the repository's `vocab/`.

The sizes, seeds, rows and keys are the script's. The script sets its
vocabulary process-wide (`set_vocabulary`); the port's BoW functions take
a `loop/vocab.Vocabulary`, so nothing global is set or restored. Its
`_traj` builds a phase-shifted `Trajectory` when the class has a `phase`
field; neither package's has one, so only its other branch (amplitude and
frequency detuned by the phase) is kept here. `--platform` gives way to
`--device`; the `--out` JSON adds `card` (the card's `name` and
`power.limit`, as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` gives them).
"""

from __future__ import annotations

import argparse
import functools
import json
import os

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.tools.cli import (REPO, add_device,
                                                check_device, device_of)
from orb_slam3_ros2_tpu_torch.tools.roofline import card

WIDTH, HEIGHT, FOCAL = 320, 240, 260.0
POS_TOL, ANG_TOL = 0.35, 15.0  # metres, degrees: the same-place relation


def trajectory(phase: float, period: float):
    """The script's `_traj` (its branch for a `Trajectory` without
    `phase`): amplitudes and rotation frequencies detuned by `phase`."""
    from orb_slam3_ros2_tpu_torch.io import synthetic

    return synthetic.Trajectory(
        amp_t=np.array([1.2, 0.7, 0.9]) * (1.0 + 0.15 * phase),
        freq_t=np.array([1, 2, 1]) / period,
        amp_r=np.array([0.12, 0.18, 0.08]),
        freq_r=np.array([2, 1, 1]) / (period * (1.0 + 0.21 * phase)),
    )


def render(n_frames: int, fps: float, seed: int, traj=None):
    """`render_room_sequence` at the bench's 320x240, f = 260."""
    from orb_slam3_ros2_tpu_torch.io import synthetic

    return synthetic.render_room_sequence(
        n_frames=n_frames, width=WIDTH, height=HEIGHT, fx=FOCAL, fy=FOCAL,
        fps=fps, seed=seed, traj=traj)


@functools.lru_cache(maxsize=1)
def room_banks(F: int, period: float, fps: float):
    """(query images, their R_cw, t_cw, aliased images): the query sequence
    through room seed 3 and the same room along the detuned trajectory.
    Both place-recognition benches start from these two banks, so the last
    render is kept for the process; callers do not write into it."""
    images, R_cw, t_cw, _ = render(F, fps, 3, trajectory(0.0, period))
    alias_imgs = render(F, fps, 3, trajectory(1.0, period))[0]
    return images, R_cw, t_cw, alias_imgs


def make_banks(F: int, period: float, fps: float):
    """(query images, their R_cw, t_cw, aliased images, other-room
    images): `room_banks` and room seed 9."""
    other_imgs = render(F, fps, 9, trajectory(0.5, period))[0]
    return (*room_banks(F, period, fps), other_imgs)


def make_extractor():
    from orb_slam3_ros2_tpu_torch.frontend import extractor as ex

    return ex.make_extractor(ex.ExtractorConfig(
        n_features=600, n_levels=4, height=HEIGHT, width=WIDTH))


def extract_all(extract, images, device):
    """(signs (n, N, 256) f32, masks (n, N) bool) of every image, on
    `device`."""
    signs, masks = [], []
    for img in images:
        f = extract(torch.from_numpy(np.asarray(img, np.float32)).to(device))
        signs.append(f.signs)
        masks.append(f.mask)
    return torch.stack(signs), torch.stack(masks)


def same_place(R_cw, t_cw, pos_tol: float = POS_TOL,
               ang_tol: float = ANG_TOL) -> np.ndarray:
    """(F, F) bool: camera centres within `pos_tol` m and optical axes
    within `ang_tol` degrees."""
    centers = -np.einsum("kji,kj->ki", R_cw, t_cw)
    axes = R_cw[:, 2, :]
    d_pos = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    d_ang = np.degrees(np.arccos(
        np.clip(np.einsum("ki,ji->kj", axes, axes), -1, 1)))
    return (d_pos < pos_tol) & (d_ang < ang_tol)


def group_winner(order: np.ndarray, scores: np.ndarray, F: int,
                 G: int) -> int:
    """The upstream DetectLoopCandidates group rule over a query's ranked
    database `order` and its `scores` (both over every entry): each of the
    top 10 candidates' temporal group (the +-G entries of its own
    sequence, standing in for covisibility) accumulates the scores of its
    members that are themselves top candidates; groups at >= 0.75 x the
    best accumulated score are kept, each by its best single frame, and
    the best-scoring of those wins. The accumulation is an acceptance
    filter (it prunes lone aliased hits), not a new ranking."""
    K = order.shape[0]
    topn = order[:10]
    top_set = set(int(i) for i in topn)
    score_of = np.full(K, 0.0)
    score_of[order] = np.maximum(scores, 0.0)
    groups = []
    for cand in topn:
        seg = cand // F  # groups never span sequences
        members = [m for m in range(max(seg * F, cand - G),
                                    min((seg + 1) * F, cand + G + 1))
                   if m in top_set]
        acc = float(sum(score_of[m] for m in members))
        best_m = max(members, key=lambda m: score_of[m])
        groups.append((acc, best_m))
    best_acc = max(a for a, _ in groups)
    retained = [m for a, m in groups if a >= 0.75 * best_acc]
    return int(max(retained, key=lambda m: score_of[m]))


def evaluate(db_signs, db_masks, vocab, same: np.ndarray, F: int, gap: int,
             G: int, label: str):
    """One codebook's (row, queries): the database of every entry's BoW
    vector (slot k = entry k), then each query q in [gap, F) with a true
    place among the query frames up to q - gap, against those and every
    distractor; `queries` holds each one's (q, top-10 ids, group
    winner)."""
    from orb_slam3_ros2_tpu_torch.loop import vocab as vocab_mod

    dev = vocab.device
    db_signs = torch.as_tensor(db_signs, device=dev)
    db_masks = torch.as_tensor(db_masks, device=dev)
    K = db_signs.shape[0]
    db = vocab_mod.empty_database(max_kf=K, n_words=vocab.n_words,
                                  device=dev)
    for k in range(K):
        db = vocab_mod.add_keyframe(db, vocab, db_signs[k], db_masks[k], k)
    hits1 = hits5 = hits10 = g_hits1 = n_q = 0
    ranks, queries = [], []
    for q in range(gap, F):
        allowed = np.zeros(K, bool)
        allowed[:F] = np.arange(F) <= q - gap   # earlier query frames
        allowed[F:] = True                       # all distractors
        gt = np.zeros(K, bool)
        gt[:F] = same[q] & allowed[:F]
        if not gt.any():
            continue
        scores, ids = vocab_mod.query(
            db, vocab, db_signs[q], db_masks[q],
            torch.from_numpy(~allowed).to(dev), top_k=K)
        order = ids.cpu().numpy()
        sc = scores.cpu().numpy()
        n_q += 1
        if gt[order[0]]:
            hits1 += 1
        if gt[order[:5]].any():
            hits5 += 1
        if gt[order[:10]].any():
            hits10 += 1
        rank = next((r for r, i in enumerate(order) if gt[i]), K)
        ranks.append(rank + 1)
        winner = group_winner(order, sc, F, G)
        if gt[winner]:
            g_hits1 += 1
        queries.append((q, order[:10].tolist(), winner))
    row = {"codebook": label, "queries": n_q,
           "db_entries": int(K),
           "recall@1": round(hits1 / max(n_q, 1), 3),
           "recall@5": round(hits5 / max(n_q, 1), 3),
           "recall@10": round(hits10 / max(n_q, 1), 3),
           "group_recall@1": round(g_hits1 / max(n_q, 1), 3),
           "median_true_rank": float(np.median(ranks)) if ranks
           else None}
    return row, queries


def train_codebook(extract, fps: float, device) -> np.ndarray:
    """The codebook trained on descriptors of a different rendered scene
    (seed 11, 24 frames, default trajectory)."""
    from orb_slam3_ros2_tpu_torch.loop import vocab as vocab_mod

    train_imgs = render(24, fps, 11)[0]
    tr_signs, tr_masks = extract_all(extract, train_imgs, device)
    return vocab_mod.train_vocabulary(
        tr_signs[tr_masks].cpu().numpy(), seed=0)


def run(F: int = 600, period: float = 4.0, fps: float = 10.0, G: int = 5,
        vocab_out: str = os.path.join(REPO, "build", "vocab"),
        device="cuda") -> dict:
    """The three rows (printed as they come) and the `--out` blob."""
    from orb_slam3_ros2_tpu_torch.loop import dbow2 as dbow2_mod
    from orb_slam3_ros2_tpu_torch.loop import vocab as vocab_mod

    dev = check_device(device)
    images, R_cw, t_cw, alias_imgs, other_imgs = make_banks(F, period, fps)
    extract = make_extractor()
    parts = [extract_all(extract, b, dev)
             for b in (images, alias_imgs, other_imgs)]
    db_signs = torch.cat([s for s, _ in parts])
    db_masks = torch.cat([m for _, m in parts])
    K = db_signs.shape[0]  # 3F database entries
    same = same_place(R_cw, t_cw)
    gap = int(round(period * fps)) // 2

    rows = []

    def row(anchors, label):
        r, _ = evaluate(db_signs, db_masks,
                        vocab_mod.Vocabulary(anchors, device=dev), same, F,
                        gap, G, label)
        print(json.dumps(r), flush=True)
        rows.append(r)

    # 1. the default random-projection codebook
    row(vocab_mod._anchors_np(), "random")
    # 2. a codebook trained on descriptors of a different rendered scene
    trained = train_codebook(extract, fps, dev)
    row(trained, "trained(held-out scene)")
    # 3. the exported artifact, round-tripped through the DBoW2 text format
    os.makedirs(vocab_out, exist_ok=True)
    npz_path = os.path.join(vocab_out, "synth_orb_vocab.npz")
    txt_path = os.path.join(vocab_out, "synth_orb_vocab.txt")
    vocab_mod.save_vocabulary(npz_path, trained)
    dbow2_mod.save_dbow2_text(txt_path, trained)
    row(dbow2_mod.load_vocabulary_any(txt_path), "dbow2-format(shipped txt)")
    return {"frames": F, "db_entries": int(K),
            "aliased_room_distractors": F,
            "other_room_distractors": F,
            "pos_tol_m": POS_TOL, "ang_tol_deg": ANG_TOL,
            "group_halfwindow": G, "results": rows, "card": card(dev)}


def main(argv=None) -> dict:
    """Runs the bench; prints the rows, writes `--out` when given, and
    returns the blob."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--period", type=float, default=4.0,
                    help="trajectory period in seconds (revisit spacing)")
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--group", type=int, default=5,
                    help="temporal covisibility half-window for group "
                         "score accumulation")
    ap.add_argument("--out", default=None)
    ap.add_argument("--vocab-out",
                    default=os.path.join(REPO, "build", "vocab"))
    add_device(ap)
    args = ap.parse_args(argv)
    dev = device_of(ap, args)
    blob = run(args.frames, args.period, args.fps, args.group,
               args.vocab_out, dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(blob, f, indent=1)
    return blob


if __name__ == "__main__":
    main()
