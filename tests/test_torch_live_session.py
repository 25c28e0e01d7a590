"""The port's continuously-operating distributed session
(`parallel/live_session.py`): four OS processes x two CPU shards in a gloo
group (a file store under tmp_path), held to tests/test_live_session.py's
bars (:161-180): welds found mid-run while tracking continues, all four
hosts connected, per-host landmark residency, and the identical refined
global trajectory on every process. The initializer takes the JAX draws,
as in tests/test_torch_distributed_session.py. Marked `slow` as its JAX
model is."""

import sys

import pytest

from tests.test_torch_distributed_session import feed_jax_draws, run_ranks


@pytest.mark.slow
def test_live_session_4_hosts(tmp_path):
    reports = run_ranks("tests.test_torch_live_session", 4, tmp_path,
                        extra=("100",))
    total_lm = sum(r["n_lm_local"] for r in reports)
    for r in reports:
        assert r["n_edges"] >= 1
        assert min(r["weld_frames"]) <= r["frames_tracked"] - 5, r
        assert r["n_connected_hosts"] == 4
        assert r["n_lm_local"] <= 0.5 * total_lm
        assert r["global_kf_ate_m"] == reports[0]["global_kf_ate_m"]
        assert r["global_devices"] == 8 and r["backend"] == "gloo"
    assert reports[0]["global_kf_ate_m"] < 0.6, reports[0]


if __name__ == "__main__":
    # a worker: RANK N STORE OUT N_FRAMES
    import torch

    torch.set_num_threads(1)
    feed_jax_draws()
    from orb_slam3_ros2_tpu_torch.parallel import live_session

    live_session.run_worker(
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], 2, sys.argv[4],
        n_frames=int(sys.argv[5]), device="cpu")
