"""ATE evaluation of the port: real EuRoC / TUM-VI sequences when present
under `--data`, the rendered synthetic suite otherwise.

    python -m orb_slam3_ros2_tpu_torch.tools.eval_ate [--quick]
        [--data DIR] [--modes mono vi stereo stereo_vi] [--max-frames N]
        [--out JSON] [--out-md MD] [--device cuda|cpu]

Port of `scripts/eval_ate.py` over the port's `runtime/bench_eval.py`
cases and `io/euroc.py`: the same suite (`synthetic_suite`: easy, hard,
five mono-inertial seeds, hard stereo, KB8 stereo, the leave-and-return
loop; `--quick` is 40 frames and 2 seeds), the same real-data branch
(`discover_real`, `eval_real_sequence`, `_config_for`) and the same table
columns. It writes `EVAL_TORCH.md` and `eval_results_torch.json` at the
repository root by default (never `EVAL.md` / `eval_results.json`, the
JAX package's), runs on the card by default (stops without one; `--device
cpu` for the tests), and names the card and its power limit in the
table's header: `fps`, `fps_steady` and `p95 ms` are the card's.

Beside each synthetic row it sets EVAL.md's JAX row (and the JAX System's
ATE on the CPU where one was taken) and the row's bar: ATE at most
max(1.5 x EVAL.md's, EVAL.md's + 0.01 m), the tracked share of frames at
least 95% of EVAL.md's, the IMU initialized on a mono-inertial row, at
least one loop closed or map merged on `synth_loopy`. The mono-inertial
rows carry `imu_initialized` for that; the JSON's `bars` lists each row's
bar and whether it was met.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from orb_slam3_ros2_tpu_torch.tools.roofline import card

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the JAX System on the same case on a CPU (`scripts/jax_reference_runs.py
# --config synth_loopy`, loop closing on; PERF.md §4)
JAX_CPU_ATE_M = {"synth_loopy": 0.3370}
TABLE_HEADER = ("| sequence | mode | ATE RMSE (m) | KF ATE (m) | "
                "tracked/total | fps | fps_steady | p95 ms | scale err % | "
                "scale err end % |")


def _config_for(seq_name: str, mode: str) -> str:
    fam = {
        "mono": "Monocular", "vi": "Monocular-Inertial",
        "stereo": "Stereo", "stereo_vi": "Stereo-Inertial",
    }[mode]
    rig = "TUM-VI" if seq_name.startswith("tumvi") else "EuRoC"
    return os.path.join(REPO, "config", fam, f"{rig}.yaml")


def eval_real_sequence(root: str, name: str, mode: str, max_frames=None,
                       device=None):
    from orb_slam3_ros2_tpu_torch.io import euroc, synthetic
    from orb_slam3_ros2_tpu_torch.runtime.system import Sensor, System

    sensor = {
        "mono": Sensor.MONOCULAR, "vi": Sensor.IMU_MONOCULAR,
        "stereo": Sensor.STEREO, "stereo_vi": Sensor.IMU_STEREO,
    }[mode]
    seq = euroc.load_sequence(root, stereo="stereo" in mode)
    sys_ = System(None, _config_for(name, mode), sensor=sensor,
                  device=device)
    t0 = time.perf_counter()
    est, gt = euroc.run_slam_on_sequence(
        sys_, seq, max_frames=max_frames, use_imu="vi" in mode)
    wall = time.perf_counter() - t0
    n = max_frames or len(seq.frames)
    if len(est) < 10:
        return {"sequence": name, "mode": mode, "ate_rmse_m": None,
                "tracked_frames": int(len(est)), "frames": int(n),
                "status": "tracking failed"}
    ate = synthetic.ate_rmse(est, gt)
    return {"sequence": name, "mode": mode, "ate_rmse_m": round(ate, 4),
            "tracked_frames": int(len(est)), "frames": int(n),
            "wall_s": round(wall, 1), "fps": round(len(est) / wall, 1),
            "status": "ok"}


def discover_real(data_dir: str):
    if not os.path.isdir(data_dir):
        return []
    out = []
    for name in sorted(os.listdir(data_dir)):
        root = os.path.join(data_dir, name)
        if os.path.isdir(os.path.join(root, "mav0")):
            out.append((name, root))
    return out


# --------------------------------------------------------------------------
# synthetic suite (always runnable; exact groundtruth)
# --------------------------------------------------------------------------

def synthetic_suite(quick: bool = False):
    """Rendered-image benchmark cases. `hard=True` uses the realistic image
    formation (perspective texture warp + photometric noise + exposure
    drift) and realistic EuRoC-grade IMU noise (see io/synthetic.py)."""
    n = 40 if quick else 120
    # mono-inertial over five seeds: every seed must initialize
    vi_rows = [
        dict(name=f"synth_hard_vi_s{i}", mode="vi", n_frames=n, hard=True,
             seed=i)
        for i in range(2 if quick else 5)
    ]
    return [
        dict(name="synth_easy", mode="mono", n_frames=n, hard=False),
        dict(name="synth_hard", mode="mono", n_frames=n, hard=True),
        *vi_rows,
        dict(name="synth_hard_stereo", mode="stereo", n_frames=n, hard=True),
        dict(name="synth_kb8_stereo", mode="fisheye_stereo",
             n_frames=max(n // 3, 24)),
        dict(name="synth_loopy", mode="loop",
             n_frames=80 if quick else 280),
    ]


def eval_synthetic(case):
    """The case's row (`runtime/bench_eval.py`); a mono-inertial row also
    carries `imu_initialized`."""
    from orb_slam3_ros2_tpu_torch.runtime import bench_eval

    if case["mode"] == "fisheye_stereo":
        return bench_eval.run_fisheye_stereo_case(case)
    if case["mode"] == "loop":
        return bench_eval.run_loop_closure_case(case)
    row, sys_ = bench_eval.run_synthetic_case_system(case)
    if case["mode"] == "vi":
        row["imu_initialized"] = bool(sys_.imu_initialized)
    return row


def results_table(results) -> str:
    """The markdown table of `scripts/eval_ate.py`, row for row."""
    lines = [TABLE_HEADER, "|---|---|---|---|---|---|---|---|---|---|"]
    for r in results:
        ate = "—" if r["ate_rmse_m"] is None else f"{r['ate_rmse_m']:.4f}"
        kfa = r.get("kf_ate_rmse_m")
        kfa = "—" if kfa is None else f"{kfa:.4f}"
        mode = r["mode"]
        if r.get("loops_closed") is not None:
            mode += f" ({r['loops_closed']} loops)"
        lines.append(
            f"| {r['sequence']} | {mode} | {ate} | {kfa} "
            f"| {r['tracked_frames']}/{r['frames']} "
            f"| {r.get('fps', '—')} | {r.get('fps_steady', '—')} "
            f"| {r.get('frame_ms_p95', '—')} "
            f"| {r.get('scale_err_pct', '—')} "
            f"| {r.get('scale_err_end_pct', '—')} |")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# the JAX rows and the bar
# --------------------------------------------------------------------------

def eval_md_rows(path: str = os.path.join(REPO, "EVAL.md")) -> dict:
    """EVAL.md's rows (the JAX package's run of `scripts/eval_ate.py`):
    sequence -> {ate_rmse_m, tracked_frames, frames, loops_closed}."""
    rows = {}
    with open(path) as f:
        for line in f:
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if len(cells) != 10 or not cells[0].startswith("synth_"):
                continue
            tracked, frames = (int(x) for x in cells[4].split("/"))
            loops = None
            if "loops)" in cells[1]:
                loops = int(cells[1].split("(")[-1].split()[0])
            rows[cells[0]] = {
                "ate_rmse_m": None if cells[2] == "—" else float(cells[2]),
                "tracked_frames": tracked, "frames": frames,
                "loops_closed": loops}
    return rows


def row_bar(row: dict, ref: dict | None) -> dict | None:
    """The row's bar against EVAL.md's JAX row `ref` (None without one):
    ATE <= max(1.5 x ref, ref + 0.01 m), tracked share >= 95% of ref's,
    the IMU initialized (mono-inertial), >= 1 loop closed or map merged
    (the loop case)."""
    if ref is None or ref["ate_rmse_m"] is None:
        return None
    ate_max = max(1.5 * ref["ate_rmse_m"], ref["ate_rmse_m"] + 0.01)
    tracked_min = (0.95 * ref["tracked_frames"] / ref["frames"]
                   * row["frames"])
    checks = {
        "ate": row["ate_rmse_m"] is not None and row["ate_rmse_m"] <= ate_max,
        "tracked": row["tracked_frames"] >= tracked_min,
    }
    if row["mode"] == "vi":
        checks["imu_initialized"] = bool(row.get("imu_initialized"))
    if row.get("loops_closed") is not None:
        checks["loops_closed"] = row["loops_closed"] >= 1
    return {"sequence": row["sequence"], "ate_max_m": ate_max,
            "tracked_min": tracked_min, "checks": checks,
            "met": all(checks.values())}


def comparison_table(results, refs: dict, bars) -> str:
    """Each row beside EVAL.md's JAX row and its bar."""
    lines = ["| sequence | ATE (m) | EVAL.md ATE (m) | JAX CPU ATE (m) | "
             "tracked/total | EVAL.md tracked/total | bar: ATE <= | "
             "bar: tracked >= | checks | met |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for r, bar in zip(results, bars):
        ref = refs.get(r["sequence"])
        ate = "—" if r["ate_rmse_m"] is None else f"{r['ate_rmse_m']:.4f}"
        if ref is None or bar is None:
            lines.append(f"| {r['sequence']} | {ate} | — | — "
                         f"| {r['tracked_frames']}/{r['frames']} | — | — | — "
                         "| — | no bar |")
            continue
        jcpu = JAX_CPU_ATE_M.get(r["sequence"])
        checks = ", ".join(f"{k} {'yes' if v else 'NO'}"
                           for k, v in bar["checks"].items())
        lines.append(
            f"| {r['sequence']} | {ate} | {ref['ate_rmse_m']:.4f} "
            f"| {'—' if jcpu is None else f'{jcpu:.4f}'} "
            f"| {r['tracked_frames']}/{r['frames']} "
            f"| {ref['tracked_frames']}/{ref['frames']} "
            f"| {bar['ate_max_m']:.4f} | {bar['tracked_min']:.1f} "
            f"| {checks} | {'yes' if bar['met'] else 'NO'} |")
    return "\n".join(lines)


def _write_eval_md(path: str, blob: dict, table: str, argv_text: str):
    c = blob["card"]
    lines = [
        "# EVAL_TORCH — accuracy of the PyTorch/CUDA port",
        "",
        f"Generated by `{argv_text}` ({time.strftime('%Y-%m-%d')}) on "
        f"{c['name'] or 'the CPU'}"
        + (f", power limit {c['power.limit']}" if c["power.limit"] else "")
        + f". Source: **{blob['source']}** data. `fps`, `fps_steady` and "
        "`p95 ms` are this run's, on that device.",
        "",
        table,
        "",
    ]
    if blob["source"] == "synthetic":
        lines += [
            "Each row beside EVAL.md's (the JAX package's run of "
            "`scripts/eval_ate.py` on a TPU: its accuracy, not its "
            "times) and its bar:",
            "",
            comparison_table(blob["results"], blob["eval_md"], blob["bars"]),
            "",
        ]
        missed = [b["sequence"] for b in blob["bars"] if b and not b["met"]]
        if missed:
            lines += [f"Rows that miss their bar: {', '.join(missed)} "
                      "(PERF.md §6 has their comparison on the CPU).", ""]
    lines += [
        "Notes:",
        "- ATE RMSE after Sim3 alignment (`io/synthetic.ate_rmse`), as "
        "EVAL.md's; the same cases, sizes and seeds "
        "(`runtime/bench_eval.py`).",
        "- The bar of a row: ATE at most max(1.5 x EVAL.md's, EVAL.md's + "
        "0.01 m), the tracked share at least 95% of EVAL.md's, the IMU "
        "initialized on the `synth_hard_vi_s*` rows, at least one loop "
        "closed or map merged on `synth_loopy`.",
        "- `fps_steady` is the synchronous System's host-loop rate "
        "(median per-frame time over the second half; a frame's time "
        "includes its host launches). `tools/bench.py`'s "
        "`system_fps_steady` times the pipelined System.",
        "- `scale err %`: the unaligned trajectory-length error (vi / "
        "stereo rows); the KB8 row: the Umeyama Sim3-scale error.",
        "",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default=os.path.join(REPO, "datasets"))
    ap.add_argument("--modes", nargs="+", default=["mono", "vi"],
                    choices=["mono", "vi", "stereo", "stereo_vi"])
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out",
                    default=os.path.join(REPO, "eval_results_torch.json"))
    ap.add_argument("--out-md", default=os.path.join(REPO, "EVAL_TORCH.md"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; stops without a card) or cpu")
    return ap


def main(argv=None, *, given=None):
    """Runs the suite, writes the JSON and the markdown, prints the table
    and returns the JSON blob. `given` (from Python only, not the CLI)
    maps a synthetic case's name to a row already computed for that
    case, which then stands in the results in place of a run."""
    given = given or {}
    ap = build_parser()
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        ap.error("no CUDA device is available; pass --device cpu to run on "
                 "the CPU")
    results = []
    real = discover_real(args.data)
    if real:
        for name, root in real:
            for mode in args.modes:
                print(f"== {name} [{mode}]", file=sys.stderr)
                results.append(eval_real_sequence(
                    root, name, mode, args.max_frames, device=args.device))
                print(json.dumps(results[-1]), file=sys.stderr)
        source = "real"
    else:
        print("no real sequences under --data; running the synthetic "
              "rendered suite", file=sys.stderr)
        for case in synthetic_suite(args.quick):
            print(f"== {case['name']} [{case['mode']}]", file=sys.stderr)
            results.append(given.get(case["name"]) or eval_synthetic(
                dict(case, device=args.device)))
            print(json.dumps(results[-1]), file=sys.stderr)
        source = "synthetic"

    blob = {"source": source, "results": results, "card": card(args.device)}
    if source == "synthetic":
        blob["eval_md"] = eval_md_rows()
        blob["bars"] = [row_bar(r, blob["eval_md"].get(r["sequence"]))
                        for r in results]
    with open(args.out, "w") as f:
        json.dump(blob, f, indent=1)
    table = results_table(results)
    argv_text = " ".join(["python -m orb_slam3_ros2_tpu_torch.tools.eval_ate",
                          *(["--quick"] if args.quick else [])])
    _write_eval_md(args.out_md, blob, table, argv_text)
    print(table)
    return blob


if __name__ == "__main__":
    main()
