"""The port's BA benches against their scripts, on the CPU.

- `tools/bench_block_ba.py` against `scripts/bench_block_ba.py`: the
  corridor bit for bit (the initial rotations, one batched f32 `so3_exp`
  here and one call a keyframe there, within 1e-6; measured 0), and
  the script's `main` at `--kf 16 --blocks 4 --iters 5` against the
  port's: the same keys, `note` and `analysis`, and the `initial`,
  `global` and `block_fixed_boundary` rows with `pose_rmse_m` within
  1e-3 m (measured 0) and `full_cost` within 1% (measured 0 and 9e-5).
- `tools/bench_scaling.py` against `scripts/bench_scaling.py`: the problem
  bit for bit, and 1 and 2 shards on the CPU (`--shards-per-device 2`)
  at 8 poses x 1024 landmarks, 3 iterations, 1 rep, each line's
  `final_cost` within 1e-4 relative of the JAX `sharded_ba` on a 1-device
  mesh (measured 2e-6 and 1.6e-5), with the script's keys; the 2-shard line's
  `efficiency` is null (its shards share the CPU).
"""

import ast
import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.backend import ba as jba
from orb_slam3_ros2_tpu.io import synthetic as jsynthetic
from orb_slam3_ros2_tpu.parallel import mesh as jmesh
from orb_slam3_ros2_tpu.parallel import sharded_ba as jsharded
from orb_slam3_ros2_tpu_torch.tools import bench_block_ba, bench_scaling
from tests.test_torch_e2e_stereo import two_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_threads", "two_blas_threads")

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


@pytest.fixture(scope="module")
def two_blas_threads():
    """Two BLAS threads for a module of these tests (the renders, the
    corridor and the codebook training run numpy products; under the
    suite's six workers a BLAS pool of every core in each made them
    several times slower). Where threadpoolctl is absent the pools stay
    as they are."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=2):
        yield


def _script(name):
    """`scripts/<name>.py` as a module (its `main` is not run)."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _script_run(argv):
    """Runs the block under `sys.argv = argv` with stdout captured (the
    yielded buffer), and puts back the JAX cache settings that a script's
    `main` changes."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    old_argv, buf = sys.argv, io.StringIO()
    sys.argv = argv
    try:
        with contextlib.redirect_stdout(buf):
            yield buf
    finally:
        sys.argv = old_argv
        for k, v in saved.items():
            jax.config.update(k, v)


def test_corridor_equals_script():
    ref = _script("bench_block_ba").build_corridor(K=16)
    got = bench_block_ba.build_corridor(K=16)
    assert set(got) == set(ref)
    for k in ref:
        if k == "R0":
            assert got[k].dtype == np.float32 and ref[k].dtype == np.float32
            np.testing.assert_allclose(got[k], ref[k], atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(got[k], ref[k])


def test_block_ba_rows_match_script(tmp_path):
    mod = _script("bench_block_ba")
    flags = ["--kf", "16", "--blocks", "4", "--iters", "5"]
    with _script_run(["bench_block_ba.py", *flags, "--out",
                      str(tmp_path / "ref.json")]):
        mod.main()
    ref = json.loads((tmp_path / "ref.json").read_text())
    out = tmp_path / "got.json"
    got = bench_block_ba.main([*flags, "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(got))
    assert got["problem"] == ref["problem"]
    assert list(got["results"]) == list(ref["results"])
    assert set(got) == set(ref) | {"card"}
    for key, row in ref["results"].items():
        if key == "analysis":
            assert got["results"][key] == row
            continue
        extra = {"ms_per_iter"} if "wall_s" in row else set()
        assert set(got["results"][key]) == set(row) | extra, key
    assert (got["results"]["block_fixed_boundary"]["note"]
            == ref["results"]["block_fixed_boundary"]["note"])
    for key in ("initial", "global", "block_fixed_boundary"):
        g, r = got["results"][key], ref["results"][key]
        assert abs(g["pose_rmse_m"] - r["pose_rmse_m"]) <= 1e-3, key
        assert g["full_cost"] == pytest.approx(r["full_cost"], rel=1e-2), key


def _jax_scaling_problem(K, L):
    """`scripts/bench_scaling.py:62-83`, restated."""
    rng = np.random.default_rng(0)
    sc = jsynthetic.make_scene(n_frames=K, n_points=min(L, 512),
                               noise_px=0.5, seed=1)
    reps = L // sc.X.shape[0] + 1
    X = np.tile(sc.X, (reps, 1))[:L] + rng.normal(0, 0.05, (L, 3))
    t = sc.t_cw + rng.normal(0, 0.02, sc.t_cw.shape)
    uv = np.tile(sc.uv, (1, reps, 1))[:, :L]
    w = np.tile(sc.vis, (1, reps))[:, :L].astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return jba.BAProblem(
        R=jnp.asarray(sc.R_cw, jnp.float32), t=jnp.asarray(t, jnp.float32),
        X=jnp.asarray(X, jnp.float32), uv=jnp.asarray(uv, jnp.float32),
        w=jnp.asarray(w), fixed=jnp.asarray(fixed),
        point_valid=jnp.ones(L, bool))


def _script_keys(name, var):
    """The keys of the script's dict literal that holds the key `var`."""
    tree = ast.parse((SCRIPTS / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) for k in node.keys):
            keys = [k.value for k in node.keys]
            if var in keys:
                return keys
    raise AssertionError(var)


def test_scaling_matches_sharded_ba():
    K, L, iters = 8, 1024, 3
    ref_p = _jax_scaling_problem(K, L)
    p = bench_scaling.problem(K, L, "cpu")
    for f in jba.BAProblem._fields:
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(ref_p, f)), f)
    mesh = jmesh.make_mesh(1)
    ref = jsharded.make_sharded_ba(mesh, 350.0, 350.0, 320.0, 240.0,
                                   n_iters=iters)(
        jsharded.shard_problem(ref_p, mesh))
    ref_cost = float(ref.cost)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lines = bench_scaling.main(
            ["--poses", str(K), "--landmarks", str(L), "--iters", str(iters),
             "--reps", "1", "--device", "cpu", "--shards-per-device", "2"])
    assert [json.loads(ln) for ln in buf.getvalue().splitlines()] == lines
    rows, summary = lines[:-1], lines[-1]
    assert [r["devices"] for r in rows] == [1, 2]
    line_keys = _script_keys("bench_scaling", "ba_iters_per_s")
    for r in rows:
        assert list(r) == line_keys + ["best_s"]
        assert r["final_cost"] == pytest.approx(ref_cost, rel=1e-4)
        assert r["ba_iters_per_s"] > 0
    assert rows[0]["efficiency"] == 1.0 and rows[1]["efficiency"] is None
    assert list(summary) == _script_keys("bench_scaling", "metric") + [
        "shards_per_device", "card"]
    assert summary["platform"] == "cpu" and summary["max_devices"] == 2
    assert summary["efficiency_at_max"] is None
    assert summary["shards_per_device"] == 2


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (bench_block_ba, bench_scaling):
        with pytest.raises(SystemExit):
            mod.main([])
        with pytest.raises(RuntimeError, match='device="cpu"'):
            mod.run()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_ba_benches_on_gpu_match_cpu(cuda_device):
    """The small block-BA and scaling benches on the card against the
    same runs on the CPU (the solvers' own tolerances: rmse within 1e-3 m,
    cost within 1%; the sharded cost within 1e-4 relative)."""
    got = bench_block_ba.run(16, 4, 5, cuda_device)["results"]
    ref = bench_block_ba.run(16, 4, 5, "cpu")["results"]
    for key in ("global", "block_fixed_boundary", "block_round_4"):
        assert abs(got[key]["pose_rmse_m"] - ref[key]["pose_rmse_m"]) <= 1e-3
        assert got[key]["full_cost"] == pytest.approx(ref[key]["full_cost"],
                                                      rel=1e-2)
    lines = bench_scaling.run(8, 1024, 3, 1, 2, cuda_device)
    cpu = bench_scaling.run(8, 1024, 3, 1, 1, "cpu")[0]["final_cost"]
    assert [r["devices"] for r in lines[:-1]] == [1, 2]
    for r in lines[:-1]:
        assert r["final_cost"] == pytest.approx(cpu, rel=1e-4)
    assert lines[-1]["card"]["name"]
