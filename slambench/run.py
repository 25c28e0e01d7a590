"""Run one benchmark cell of the PyTorch/CUDA port and print its result.

    python3 -m slambench.run --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. The cell (`BENCHMARK.json` `workloads`)
names its configuration (`slambench/configs/<name>.json`) and its traffic
(`slambench/traffic/<mix>.json`), whose `generator` names the module under
`slambench/gen/` that makes the inputs from the seed, sets up the program,
measures the window and holds the window's outputs to the plain
references. With --trace 1 a slice of the window runs under
torch.profiler and the line carries the cell's per-layer metrics, each
read by `slambench/metrics/<metric>.py`, instead of its end-to-end ones.
The compared numbers and their limits (`slambench/limits/<cell>.json`)
are printed last on stderr and last in the result line. --control 1 adds
each compared number's control reading (the reference computed a
precision below the program's) to stderr, for setting limits; the
benchmark's own runs do not use it.

Exits 2 without a CUDA device or with fewer than the cell's chips, and 3
if JAX or the JAX package was loaded; neither prints a result.
"""

from __future__ import annotations

from slambench import harness

harness.pin_host_threads()

import argparse  # noqa: E402
import importlib  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from slambench.metrics import _load  # noqa: E402


def cell_of(bench: dict, name: str):
    for w in bench["workloads"]:
        if w["name"] == name:
            cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
            return w, cfg
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def judge(raw: list, limits: dict):
    """(checks, correct): each compared number (name, value, limit), the
    limits that got no reading among them with the value None; correct
    where there is at least one limit, every limit has a finite reading
    at or under it, and every reading has a limit."""
    read = {n: v for n, v, _ in raw}
    checks = [(n, v, limits.get(n)) for n, v, _ in raw]
    checks += [(n, None, lim) for n, lim in limits.items() if n not in read]
    correct = bool(limits) and all(
        v is not None and lim is not None and math.isfinite(v) and v <= lim
        for _, v, lim in checks)
    return checks, correct


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell, _ = cell_of(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(harness.HOST_THREADS)
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda:0"),
                   control=bool(args.control))
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules the benchmark may not load: {bad}",
              file=sys.stderr)
        return 3
    harness.print_result(*out)
    return 0


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device, control: bool = False, config=None,
             traffic=None):
    """Set up, measure and check one cell on `device`. Returns the
    arguments of `harness.print_result`. `config` / `traffic` replace the
    cell's files (the CPU tests run the path at a tiny size)."""
    root = harness.ROOT
    cell, cfg_entry = cell_of(bench, name)
    config = config or harness.load_json(root / cfg_entry["file"])
    traffic = traffic or harness.load_json(
        root / "slambench" / "traffic" / f"{cell['traffic']}.json")
    gen = importlib.import_module(f"slambench.gen.{traffic['generator']}")
    wl = gen.Workload(config, traffic, seed, device, trace)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)  # the context, before its counters
        torch.cuda.reset_peak_memory_stats(device)
    wl.setup()
    setup_s = harness.process_age_s()
    e2e = wl.window(seconds)
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if cuda \
        else 0
    attempted, failed = wl.attempted_failed()
    readings = wl.readings()
    wl.release()
    raw = wl.check(control=control)
    lim_path = root / "slambench" / "limits" / f"{name}.json"
    limits = harness.load_json(lim_path) if lim_path.exists() else {}
    checks, correct = judge(raw, limits)
    correct = correct and failed == 0
    if control:
        for n, v, c in raw:
            print(f"control {n} program {v!r} control {c!r}",
                  file=sys.stderr)
    metrics = {}
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": memory_peak}
    brk = sl_info = None
    if trace:
        for m in for_cell(bench["per_layer"], name):
            v = _load(m["name"]).read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        sl = readings["slice"]
        device_info["busy_s"] = harness.busy_us(sl.events) / 1e6
        device_info["window_s"] = sl.wall_s
        brk = harness.breakdown(sl.events)
        sl_info = {"units": sl.units, "wall_s": sl.wall_s}
    else:
        values = dict(e2e, setup_s=setup_s)
        for m in for_cell(bench["end_to_end"], name):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    return (correct, attempted, failed, metrics, device_info, checks, brk,
            sl_info)


if __name__ == "__main__":
    sys.exit(main())
