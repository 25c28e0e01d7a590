"""What the benchmark runs loads neither JAX nor the JAX package, and the
references load nothing of the program; top-level module names are
compared whole (the port's name begins with the JAX package's)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from slambench import harness

BENCH = harness.ROOT / "slambench"
JAX_SIDE = {"jax", "jaxlib", "flax", "orb_slam3_ros2_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".", 1)[0]


def test_references_import_nothing_of_the_program_or_jax():
    for path in (BENCH / "reference").glob("*.py"):
        tops = set(_imports(path))
        assert not tops & (JAX_SIDE | {"orb_slam3_ros2_tpu_torch"}), path


def test_harness_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not set(_imports(path)) & JAX_SIDE, path


def test_a_loaded_harness_holds_no_jax_module():
    """Load every module a run loads (the harness, each generator and
    metric, the program's System) in a fresh process and list
    `sys.modules` by whole top-level name."""
    code = (
        "import sys\n"
        "from slambench import harness\n"
        "harness.pin_host_threads()\n"
        "import slambench.run, slambench.gen.orbit, slambench.gen.gba_map\n"
        "from slambench.metrics import _load\n"
        "import json\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "[_load(m['name']) for m in b['per_layer']]\n"
        "import orb_slam3_ros2_tpu_torch.runtime.system\n"
        "import orb_slam3_ros2_tpu_torch.frontend.tracking\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_run_prints_nothing_and_fails(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "slambench.run", "--workload",
         "euroc_mono.gba", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "orb_slam3_ros2_tpu_torch_fake", sys)
    assert "orb_slam3_ros2_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "orb_slam3_ros2_tpu.io", sys)
    assert "orb_slam3_ros2_tpu" in harness.forbidden_modules()
