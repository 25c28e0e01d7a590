"""The inertial global BA on the card: it makes no host sync
(`backend/vi_ba.py`: "no host sync"), held under
`torch.cuda.set_sync_debug_mode("error")`, and a solve whose LM stages
replay their CUDA graphs is bitwise the eager solve. Marked `cuda`, the
tests skip without a card. The map is the `vi_gba_map` traffic's at 16
keyframes and 1,024 landmarks, solved as its cell solves it
(`runtime/system.vi_ba2`)."""

import pytest
import torch

from orb_slam3_ros2_tpu_torch.backend import vi_ba
from slambench import harness
from slambench.gen import vi_gba_map

COUNTERS = ("graph_captures", "graph_replays", "eager_stages")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def workload(device):
    """The cell's workload at 16 keyframes, after its set-up's solve."""
    cfg = harness.load_json(harness.ROOT / "slambench" / "configs"
                            / "euroc_vi.json")
    tr = harness.load_json(harness.ROOT / "slambench" / "traffic"
                           / "vi_gba_map.json")
    tr.update(keyframes=16, landmarks=1024, candidates=8000)
    wl = vi_gba_map.Workload(cfg, tr, 2147483659, device, False)
    wl.setup()
    return wl


def counts():
    return {k: getattr(vi_ba.vi_bundle_adjust, k) for k in COUNTERS}


class _Eager:
    """A stand-in for the graph cache that gives every solve no graphs."""

    def solve(self, *problem):
        return None


@pytest.mark.cuda
def test_vi_ba2_makes_no_host_sync(cuda_device):
    """A second solve (the first makes the libraries' handles) raises on
    any synchronizing call."""
    wl = workload(cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = wl.solve()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in out)
    assert not torch.equal(out[0], wl.map.kf_R)


@pytest.mark.cuda
def test_vi_ba2_replays_its_graphs_bitwise(cuda_device, monkeypatch):
    """Once every stage is captured (two solves), a solve replays six
    graphs an iteration (the reduce, the inertial terms, the solve, the
    update and the two costs) and gives the eager solve's bits."""
    monkeypatch.setattr(vi_ba, "_GRAPHS", vi_ba.stage_graphs.StageGraphs(
        vi_ba._count))
    wl = workload(cuda_device)
    wl.solve()
    before = counts()
    replayed = wl.solve()
    torch.cuda.synchronize()
    after = counts()
    assert after["graph_captures"] == before["graph_captures"]
    assert after["eager_stages"] == before["eager_stages"]
    assert after["graph_replays"] - before["graph_replays"] == 6 * wl.n_iters
    with monkeypatch.context() as mp:
        mp.setattr(vi_ba, "_GRAPHS", _Eager())
        eager = wl.solve()
    for a, b in zip(replayed, eager):
        assert torch.equal(a, b)
