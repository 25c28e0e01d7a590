"""The control on the card: the program with its own lower precision
switched on (TF32 for its matrix products) is not correct, while the
program is, on three seeds. Needs a CUDA device; skips without one. The cells' own sizes are
run by `python3 -m slambench.run --workload CELL --seed N --seconds S
--control 1` (PERF.md, section 6, has those readings); this test holds
shorter set-ups."""

import pytest
import torch

from slambench import harness, run

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
SEEDS = (2147483659, 2147483693, 2147483713)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _short(cell):
    w, c = run.cell_of(BENCH, cell)
    cfg = harness.load_json(harness.ROOT / c["file"])
    tr = harness.load_json(harness.ROOT / "slambench" / "traffic"
                           / f"{w['traffic']}.json")
    if tr["generator"] == "orbit":
        tr["setup"] = {"MONOCULAR": {"frames": 120},
                       "IMU_MONOCULAR": {"intervals": 12}}
    else:
        tr.update(keyframes=64, landmarks=2048, candidates=12000)
    return cfg, tr


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_where_the_program_passes(cell, seed, capsys):
    dev = _card()
    cfg, tr = _short(cell)
    gen = __import__(f"slambench.gen.{tr['generator']}",
                     fromlist=["Workload"])
    wl = gen.Workload(cfg, tr, seed, dev, False)
    wl.setup()
    wl.window(4.0)
    wl.release()
    raw = wl.check(control=True)
    limits = harness.load_json(harness.ROOT / "slambench" / "limits"
                               / f"{cell}.json")
    for name, value, _ in raw:
        assert value <= limits[name], (name, value)
    failed = [n for n, _, c in raw if c is not None and c > limits[n]]
    assert failed, raw
