"""The port's distributed SLAM session (`parallel/distributed_session.py`):
two OS processes x four CPU shards in a gloo group (a file store under
tmp_path), each tracking its segment with the full System, then the map
all-gather, the deterministic weld and the global sharded BA, held to
tests/test_distributed_session.py's bars (:73-89).

Each initialization attempt draws the JAX System's RANSAC samples for its
frame, as tests/test_torch_e2e_mono.py feeds them: the two packages'
generators cannot draw the same numbers, and on this clip the frame the
initializer first accepts (the port's own draws: frame 14 of segment 0's
22, JAX's: earlier) decides how many keyframes segment 0 gives the weld.
The workers run this module (`python -m tests.test_torch_distributed_session`).
Marked `slow` as its JAX model is."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 900


def feed_jax_draws():
    """Patch the port's initializer to take the JAX System's samples for
    each attempt's frame (`PRNGKey(frame)`), on the CPU."""
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    from orb_slam3_ros2_tpu.frontend import initializer as jinit
    from orb_slam3_ros2_tpu_torch.frontend import initializer as tinit

    def initialize(gen, uv1, uv2, mask, *args, **kwargs):
        kh, kf = jax.random.split(jax.random.PRNGKey(gen.initial_seed()))
        m = jnp.asarray(mask.cpu().numpy())
        idx_h = np.array(jinit._sample_indices(kh, m, jinit.N_HYPO, 4))
        idx_f = np.array(jinit._sample_indices(kf, m, jinit.N_HYPO, 8))
        return tinit.initialize_from_samples(
            uv1, uv2, mask, torch.from_numpy(idx_h).to(mask.device),
            torch.from_numpy(idx_f).to(mask.device), *args, **kwargs)

    tinit.initialize = initialize


def run_ranks(module: str, n: int, tmp_path, extra=()):
    """Start n worker processes of `module` (argv: RANK N STORE OUT
    extra...) and return their last JSON lines."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    out_json = str(tmp_path / "report.json")
    store = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, str(r), str(n), store, out_json,
         *extra], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out[-2000:]}\n{err[-3000:]}"
    return [json.loads([ln for ln in out.splitlines()
                        if ln.startswith("{")][-1]) for _, out, _ in outs]


@pytest.mark.slow
def test_two_process_session_weld_and_global_gba(tmp_path):
    reports = run_ranks("tests.test_torch_distributed_session", 2, tmp_path)
    rep = reports[0]
    assert rep["global_devices"] == 8 and rep["processes"] == 2
    assert rep["backend"] == "gloo"
    assert rep["n_maps_welded"] == 2, rep
    assert rep["n_kf_merged"] > rep["n_kf_local"], rep
    assert rep["kf_ate_refined_m"] < 0.08, rep
    assert rep["kf_ate_refined_m"] <= rep["kf_ate_merged_m"] + 0.01, rep
    # both processes computed the identical merged map (deterministic weld)
    assert len({r["kf_ate_refined_m"] for r in reports}) == 1, reports


if __name__ == "__main__":
    # a worker: RANK N STORE OUT
    import torch

    torch.set_num_threads(1)
    feed_jax_draws()
    from orb_slam3_ros2_tpu_torch.parallel import distributed_session

    distributed_session.run_worker(
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], 4, sys.argv[4],
        device="cpu")
