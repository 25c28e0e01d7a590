"""Speed-of-light audit of the port's per-frame tracking step on the card.

    python -m orb_slam3_ros2_tpu_torch.tools.profile_tracking
        [--trace LOGDIR] [--out JSON] [--device cuda|cpu]

Port of `scripts/profile_tracking.py`: the same four stage programs on
`tools/bench.py`'s setup (752x480 noise frames, 1000 features over 8
levels, a map of 8192 slots with 4096 landmarks from `default_rng(0)`):
`pyramid`, `extract`, `extract+match` and `full` (+ the pose LM, the pose
chained frame to frame), each a Python loop over a batch of frames on the
device, timed by the batch-size slope (T(512) - T(32)) / 480, each T the
best of 5 runs ending in one synchronize. The derived rows are the
differences of neighbouring stages, then the whole step, then one BA
iteration of `tools/bench.py`'s 64-keyframe x 8192-landmark problem
(the slope between 10 and 30 iterations).

Each row's bytes and operations are the port's own work on one frame,
counted while the stage runs once (`count_work`):
- each hand-written kernel (`frontend_pass_packed`, `match_window`,
  `optimize_pose_fused`) from `tools/roofline.py`, the counts that
  `chip_smoke.py` gives its bound, on that call's inputs;
- every other torch op from its shapes: each tensor input read once
  and each output written once (a gather reads what it writes; a view or
  an allocation moves nothing), and an operation an element of its
  largest operand, 2mnk for a matrix product, 2n^3/3 for an LU.
The peaks are the card's (`tools/roofline.py`: 3.35 TB/s, 67 TFLOP/s f32,
TF32 off). A row's bound is the larger of its bytes over the memory rate
and its operations over the f32 rate, and its share of the speed of
light is that bound over the measured time. The JAX script's counts of
bf16 casts, the block gather and the all-bin steering matmul have no
counterpart here: the port's describe steers each keypoint exactly.

`--trace LOGDIR` writes a torch.profiler Chrome trace of the full stage
over 64 frames (`LOGDIR/trace.json`). `--out` writes the rows, the
configuration, the peaks, the card and each stage's counts as JSON. Runs
on the card by default and stops without one; `--device cpu` is for the
tests.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod
from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused
from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
from orb_slam3_ros2_tpu_torch.frontend import tracking as trk
from orb_slam3_ros2_tpu_torch.ops import frontend_packed as fp
from orb_slam3_ros2_tpu_torch.ops import fused_match
from orb_slam3_ros2_tpu_torch.ops import pyramid as pyr_ops
from orb_slam3_ros2_tpu_torch.tools import bench, roofline

B_SMALL, B_LARGE = 32, 512
N_REPS = 5
NOISE_FLOOR_MS = 0.03  # a stage difference below this is not reported
STAGES = ("pyramid", "extract", "extract+match", "full")
TRACE_FRAMES = 64

# ops whose first input is read only where the output gathers from it
_GATHERS = {"index.Tensor", "gather.default", "index_select.default",
            "take.default", "embedding.default"}
# in-place scatters: the updates and indices read, the touched cells
# written
_SCATTERS = {"index_put_.default", "index_put.default", "scatter_.src",
             "scatter.src", "scatter_add_.default", "scatter_add.default",
             "index_add_.default", "index_add.default", "scatter_.value",
             "scatter.value", "index_put_.accumulate"}


def _tensors(tree):
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    walk(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def op_cost(func, args, kwargs, out):
    """(bytes, operations) of one aten op from its shapes (see the module
    docstring)."""
    name = str(func).removeprefix("aten.")
    if func.is_view or name.startswith(("empty", "_local_scalar_dense",
                                        "lift_fresh", "detach", "_unsafe_view",
                                        "set_", "resize_")):
        return 0, 0
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    if name in _GATHERS:
        src, rest = ins[0], ins[1:]
        moved = sum(_nbytes(o) for o in outs)
        n_bytes = moved + sum(_nbytes(t) for t in rest) + moved
        return n_bytes, sum(o.numel() for o in outs)
    if name in _SCATTERS:
        rest = ins[1:]
        moved = sum(_nbytes(t) for t in rest)
        vals = max((t.numel() for t in rest), default=0)
        return moved + vals * ins[0].element_size(), vals
    n_bytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(o) for o in outs)
    if name.startswith(("mm.", "addmm.", "bmm.", "baddbmm.")):
        a, b = (ins[-2], ins[-1])
        batch = a.shape[0] if a.dim() == 3 else 1
        return n_bytes, 2 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]
    if name.startswith(("linalg_lu_factor_ex", "linalg_solve_ex",
                        "linalg_cholesky_ex", "linalg_lu.")):
        a = ins[0]
        n = a.shape[-1]
        batch = a.numel() // (n * n)
        lu = (n ** 3) // 3 if "cholesky" in name else 2 * n ** 3 // 3
        rhs = ins[1].shape[-1] if name.startswith("linalg_solve_ex") else 0
        return n_bytes, batch * (lu + 2 * n * n * rhs)
    if name.startswith(("linalg_lu_solve", "triangular_solve",
                        "linalg_solve_triangular", "cholesky_solve")):
        a, b = ins[0], ins[1]
        n = a.shape[-1]
        batch = a.numel() // (n * n)
        return n_bytes, batch * 2 * n * n * b.shape[-1]
    if name.startswith(("sort", "topk", "argsort")):
        n = ins[0].numel()
        return n_bytes, int(n * max(1.0, math.log2(max(n, 2))))
    return n_bytes, max((t.numel() for t in ins + outs), default=0)


class _Counter(TorchDispatchMode):
    """Adds up `op_cost` of every aten op dispatched while `active`."""

    def __init__(self):
        super().__init__()
        self.active = True
        self.bytes = self.ops = self.n_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.active:
            b, o = op_cost(func, args, kwargs, out)
            self.bytes += b
            self.ops += o
            self.n_ops += 1
        return out


@contextlib.contextmanager
def _kernels_counted(counts: dict, counter: _Counter):
    """The three main-path kernel wrappers, each adding its
    `tools/roofline.py` cost on the call's inputs to `counts` and
    hiding the torch ops it dispatches (allocations on the card, the plain
    version on the CPU) from `counter`."""
    def counted(orig, cost):
        def wrapped(*args, **kw):
            counter.active = False
            try:
                out = orig(*args, **kw)
                b, o = cost(args, kw, out)
            finally:
                counter.active = True
            counts["kernel_bytes"] += b
            counts["kernel_ops"] += o
            counts["kernel_launches"] += 1
            return out

        wrapped.__dict__ = orig.__dict__  # one `launches` counter for both
        return wrapped

    def frontend_cost(args, kw, out):
        levels = args[0]
        return roofline.frontend_packed_cost(
            sum(lv.numel() for lv in levels), out[0].numel())

    def match_cost(args, kw, out):
        _, ma, uva, _, mb, uvb = args[:6]
        return roofline.match_cost(uva, ma, uvb, mb, kw.get("radius", 15.0))

    def pose_cost(args, kw, out):
        return roofline.pose_cost(args[2].shape[0])

    table = [(fp, "frontend_pass_packed", frontend_cost),
             (fused_match, "match_window", match_cost),
             (pose_opt_fused, "optimize_pose_fused", pose_cost)]
    saved = []
    try:
        for module, name, cost in table:
            orig = getattr(module, name)
            saved.append((module, name, orig))
            setattr(module, name, counted(orig, cost))
        yield
    finally:
        for module, name, orig in saved:
            setattr(module, name, orig)


def count_work(fn) -> dict:
    """The bytes and operations of one call of fn(): the kernels' from
    `tools/roofline.py`, every other torch op's from its shapes."""
    counts = dict(kernel_bytes=0, kernel_ops=0, kernel_launches=0)
    counter = _Counter()
    with _kernels_counted(counts, counter), counter:
        fn()
    counts.update(torch_bytes=counter.bytes, torch_ops=counter.ops,
                  torch_calls=counter.n_ops)
    counts["bytes"] = counts["kernel_bytes"] + counts["torch_bytes"]
    counts["ops"] = counts["kernel_ops"] + counts["torch_ops"]
    return counts


def make_stages(extract, cfg: ex.ExtractorConfig, m, cam, device):
    """The four stage programs: each runs a batch of frames and returns a
    device tensor that depends on every frame."""
    fx, fy, cx, cy, width, height = cam
    R0 = torch.eye(3, device=device)
    t0 = torch.zeros(3, device=device)

    def stage_pyramid(frames):
        c = torch.zeros((), device=device)
        for img in frames:
            levels = pyr_ops.build_pyramid(img, cfg.n_levels,
                                           cfg.scale_factor)
            c = c + levels[-1].mean()
        return c

    def stage_extract(frames):
        c = torch.zeros((), device=device)
        for img in frames:
            f = extract(img)
            c = c + f.uv.sum() + f.signs.sum()
        return c

    def stage_extract_match(frames):
        c = torch.zeros((), device=device)
        for img in frames:
            f = extract(img)
            tm = trk.match_to_map(m, f.uv, f.bits, f.mask, R0, t0, fx, fy,
                                  cx, cy, width, height)
            c = c + tm.n_matches.to(torch.float32)
        return c

    def stage_full(frames):
        R, t, n = bench.track_batch(extract, m, frames, R0, t0, cam)
        return R.sum() + t.sum() + n.sum().to(torch.float32)

    return dict(zip(STAGES, (stage_pyramid, stage_extract,
                             stage_extract_match, stage_full)))


def slope_time(fn, rng, height, width, device, batches=(B_SMALL, B_LARGE),
               reps: int = N_REPS) -> float:
    """Seconds a frame: (T(large) - T(small)) / (large - small), each T
    the best of `reps` runs after a warm-up run."""
    times = {}
    for nb in batches:
        fr = bench.noise_frames(rng, nb, height, width, device)
        fn(fr)
        bench._sync(device)
        fr = bench.noise_frames(rng, nb, height, width, device)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(fr)
            bench._sync(device)
            best = min(best, time.perf_counter() - t0)
            fr = fr + 0.001
        times[nb] = best
    small, large = batches
    return (times[large] - times[small]) / (large - small)


def stage_row(name: str, dt: float, n_bytes: float, n_ops: float) -> dict:
    """One row with the JAX script's keys: measured ms a frame, counted MB
    and GFLOP, what bounds it, and the achieved rates and share of the
    speed of light (or, under the noise floor, the bound alone)."""
    b = roofline.bound(n_bytes, n_ops)
    row = dict(stage=name, ms_per_frame=dt * 1e3, est_MB=n_bytes / 1e6,
               est_GFLOP=n_ops / 1e9, bound=b["bound_by"])
    if dt * 1e3 < NOISE_FLOOR_MS:
        row.update(ms_per_frame=max(dt * 1e3, 0.0),
                   note="below measurement noise floor",
                   roofline_bound_ms=b["bound_ms"])
    else:
        row.update(achieved_GBs=n_bytes / dt / 1e9,
                   achieved_TFLOPs=n_ops / dt / 1e12,
                   pct_speed_of_light=b["bound_ms"] / (dt * 1e3) * 100)
    return row


def derived_rows(t_meas: dict, counts: dict) -> list:
    """The stage rows: each stage's difference from the one before it,
    then the whole step."""
    def diff(a, b, key):
        return counts[a][key] - (counts[b][key] if b else 0)

    rows = []
    for name, stage, prev in (
            ("pyramid", "pyramid", None),
            ("fast+nms+blur+describe", "extract", "pyramid"),
            ("match(8192 lm)", "extract+match", "extract"),
            ("pose LM", "full", "extract+match"),
            ("FULL STEP", "full", None)):
        dt = t_meas[stage] - (t_meas[prev] if prev else 0.0)
        rows.append(stage_row(name, dt, diff(stage, prev, "bytes"),
                              diff(stage, prev, "ops")))
    return rows


def _ba_roofline(device, K: int = 64, L: int = 8192, iters=bench.BA_ITERS,
                 reps: int = N_REPS) -> dict:
    """One BA iteration of `tools/bench.py`'s problem: the slope between
    `iters`, each the best of `reps` runs on a fresh input; its counted
    work a iteration (the same slope of `count_work`), the JAX script's
    structural count (the observed pairs and co-observing camera pairs
    only) and the share of the speed of light."""
    problem = bench.ba_problem(device, K, L)
    times, work = {}, {}
    for n_iters in iters:
        ba_mod.bundle_adjust(problem, *bench.BA_CAMERA, n_iters=n_iters)
        bench._sync(device)
        work[n_iters] = count_work(lambda: ba_mod.bundle_adjust(
            problem, *bench.BA_CAMERA, n_iters=n_iters))
        best = float("inf")
        for i in range(reps):
            p2 = problem._replace(t=problem.t + 1e-6 * (i + 1))
            bench._sync(device)
            t0 = time.perf_counter()
            ba_mod.bundle_adjust(p2, *bench.BA_CAMERA, n_iters=n_iters)
            bench._sync(device)
            best = min(best, time.perf_counter() - t0)
        times[n_iters] = best
    lo, hi = iters
    dt_iter = (times[hi] - times[lo]) / (hi - lo)
    n_ops = (work[hi]["ops"] - work[lo]["ops"]) / (hi - lo)
    n_bytes = (work[hi]["bytes"] - work[lo]["bytes"]) / (hi - lo)
    vis = problem.w.cpu().numpy() > 0
    nnz = float(vis.sum())
    co = vis.astype(np.float64) @ vis.astype(np.float64).T
    useful = ((3 * 150 + 288 + 108 + 96) * nnz + 216 * float(co.sum())
              + (6 * K) ** 3 // 3)
    b = roofline.bound(n_bytes, n_ops)
    return dict(
        stage=f"BA iteration ({K}kf x {L}lm dense robust-LM Schur)",
        ms_per_iter=dt_iter * 1e3,
        dense_GFLOP=n_ops / 1e9,
        structural_GFLOP=useful / 1e9,
        useful_fraction=useful / n_ops,
        achieved_TFLOPs=n_ops / dt_iter / 1e12,
        pct_speed_of_light=b["bound_ms"] / (dt_iter * 1e3) * 100,
        bound=b["bound_by"],
        note=(f"counted {n_bytes / 1e6:.1f} MB and {n_ops / 1e9:.2f} GFLOP "
              "a iteration; the structural count keeps the observed pairs "
              "only; the covisibility-partitioned block BA "
              "(parallel/block_ba.py) is the sparse counterpart used at "
              "map scale"),
    )


def profile(device, height: int = bench.HEIGHT, width: int = bench.WIDTH,
            n_features: int = 1000, n_landmarks: int = bench.N_LANDMARKS,
            batches=(B_SMALL, B_LARGE), reps: int = N_REPS,
            ba_size=(64, 8192), trace: str | None = None) -> dict:
    """Times the stages, counts their work, and returns the JSON of
    `--out` (every size a keyword, for the tests)."""
    scale = width / bench.WIDTH
    cam = (bench.FX * scale, bench.FY * scale, bench.CX * scale,
           bench.CY * scale, width, height)
    cfg = ex.ExtractorConfig(n_features=n_features, n_levels=8,
                             height=height, width=width)
    extract = ex.make_extractor(cfg)
    rng = np.random.default_rng(0)
    m = bench.tracking_map(rng, cfg, device, n_landmarks)
    stages = make_stages(extract, cfg, m, cam, device)

    t_meas, counts = {}, {}
    for name, fn in stages.items():
        t_meas[name] = slope_time(fn, rng, height, width, device, batches,
                                  reps)
        one = bench.noise_frames(rng, 1, height, width, device)
        counts[name] = count_work(lambda: fn(one))
        print(f"measured {name}: {t_meas[name] * 1e3:.3f} ms/frame",
              file=sys.stderr)
    rows = derived_rows(t_meas, counts)
    rows.append(_ba_roofline(device, *ba_size, reps=reps))
    for row in rows:
        print(json.dumps(row))

    if trace:
        from orb_slam3_ros2_tpu_torch.utils import tracing

        fr = bench.noise_frames(rng, TRACE_FRAMES, height, width, device)
        stages["full"](fr)
        bench._sync(device)
        with tracing.capture(trace):
            stages["full"](fr)
            bench._sync(device)
        print(f"trace written to {trace}/trace.json", file=sys.stderr)

    return dict(
        config=dict(H=height, W=width, n_features=n_features,
                    n_levels=cfg.n_levels, max_lm=int(m.lm_valid.shape[0])),
        peaks=dict(hbm_GBs=roofline.PEAK_BYTES_S / 1e9,
                   f32_TFLOPs=roofline.PEAK_OPS_S / 1e12),
        card=roofline.card(device),
        counts=counts,
        stages=rows)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default=None, metavar="LOGDIR")
    ap.add_argument("--out", default=None, metavar="JSON")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; stops without a card) or cpu")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        ap.error("no CUDA device is available; pass --device cpu to run on "
                 "the CPU")
    out = profile(torch.device(args.device), trace=args.trace)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
