"""The port's top-level entry points (`tools/graft_entry.py`) against
`__graft_entry__.py`, on the CPU.

- `entry()`: the same texture (bit for bit) and depth draws; each package
  extracts its own features, so the landmark x, y differ where the
  extractors' keypoints do (measured 3.9e-3 m; held to 5e-3), while every
  z and the landmark count are equal. The step against the jitted JAX
  step: R and t within 1e-4 (measured 0 and 0), inliers within 5%
  (measured 512 and 512), and the JAX test's own checks (> 100 inliers,
  R within 1e-3 of the identity, t within 1e-3 of 0).
- `dryrun_multichip(n, devices=["cpu"] * n)` for n = 2 and 4: every check
  of the JAX function holds, and its numbers agree with
  `__graft_entry__.dryrun_multichip(n)` run in the same test on the
  conftest's CPU mesh (its printed lines parsed; the pose graph's cost and
  the cut fractions read at full precision by wrapping the JAX package's
  `make_sharded_pose_graph` and `cut_fraction`; the printed numbers
  carry 3 to 5 decimals, so a measured difference under 5e-5 is the
  print's rounding): the System's global BA pose error before within
  1e-4 m (measured 3e-5) and after within 1e-3 m (1.6e-5), the BA step's
  cost within 1e-4 relative (1e-6), the pose graph's error before within
  1e-4 m (3e-5) and after within 1e-4 m (2.2e-7) and its cost within 1e-9
  (both ~1e-13, f32 round-off), the VI BA's pose error before within
  1e-4 m (3e-5) and after within 2e-3 m (6e-4) and its gyro-bias error
  within 1e-3 (3e-5), the (kf, lm) mesh shape and both cut fractions
  equal (measured equal).
  n = 4 gives a 2x2 mesh, so the cut-fraction bar (covisibility
  partitioning under 0.6x contiguous chunking) is held there with cuts
  that are not zero (0.252 vs 0.504 in both packages).
- Without a card the default device raises and says to pass the CPU.
- On a card (`-m cuda`): one step launches each main-path kernel once and
  agrees with the same step through the plain versions.
"""

import contextlib
import io
import re

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from orb_slam3_ros2_tpu_torch.tools import graft_entry as tge
from tests.test_torch_ba_benches import two_blas_threads  # noqa: F401
from tests.test_torch_e2e_stereo import two_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_threads", "two_blas_threads")


def test_entry_matches_jax():
    fn, (jimg, jm) = ge.entry()
    R_j, t_j, n_j = (np.asarray(a) for a in jax.jit(fn)(jimg, jm))
    step, (img, m) = tge.entry(device="cpu")
    assert np.array_equal(img.numpy(), np.asarray(jimg))
    assert torch.equal(m.lm_valid, torch.from_numpy(np.array(jm.lm_valid)))
    v = m.lm_valid.numpy()
    np.testing.assert_array_equal(m.lm_X[v, 2].numpy(),
                                  np.asarray(jm.lm_X)[v, 2])
    np.testing.assert_allclose(m.lm_X.numpy(), np.asarray(jm.lm_X),
                               atol=5e-3)
    R, t, n = step(img, m)
    assert R.shape == (3, 3) and t.shape == (3,)
    assert int(n) > 100
    np.testing.assert_allclose(R.numpy(), np.eye(3), atol=1e-3)
    np.testing.assert_allclose(t.numpy(), 0.0, atol=1e-3)
    np.testing.assert_allclose(R.numpy(), R_j, atol=1e-4)
    np.testing.assert_allclose(t.numpy(), t_j, atol=1e-4)
    assert abs(int(n) - int(n_j)) <= 0.05 * int(n_j)


def _jax_dryrun(n, monkeypatch):
    """Run `__graft_entry__.dryrun_multichip(n)` and return its numbers:
    the printed lines parsed, the pose graph's cost and the cut fractions
    caught where the JAX package computes them."""
    from orb_slam3_ros2_tpu.parallel import partition
    from orb_slam3_ros2_tpu.parallel import sharded_pose_graph as spg

    seen = {"cut": []}
    cut_fraction = partition.cut_fraction

    def cut(*a, **k):
        c = cut_fraction(*a, **k)
        seen["cut"].append(float(c))
        return c

    make_pg = spg.make_sharded_pose_graph

    def make(*a, **k):
        opt = make_pg(*a, **k)

        def run(*b, **kw):
            res = opt(*b, **kw)
            seen["pg_cost"] = float(res.cost)
            return res
        return run

    monkeypatch.setattr(partition, "cut_fraction", cut)
    monkeypatch.setattr(spg, "make_sharded_pose_graph", make)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ge.dryrun_multichip(n)
    text = buf.getvalue()

    def nums(pattern):
        m = re.search(pattern, text)
        assert m, (pattern, text)
        return [float(g) for g in m.groups()]

    f = r"([0-9.]+)"
    seen["sys"] = nums(rf"global BA OK \(pose err {f} -> {f}")
    seen["ba_cost"], = nums(rf"distributed BA step OK, cost={f}")
    seen["pg"] = nums(rf"pose-graph step OK, pose err {f} -> {f}")
    seen["vi"] = nums(
        rf"VIBA step OK \(pose err {f} -> {f}, gyro-bias err {f}")
    seen["mesh"] = [int(v) for v in nums(r"block BA on (\d+)x(\d+)")]
    return seen


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_matches_jax(n, monkeypatch):
    j = _jax_dryrun(n, monkeypatch)
    out = tge.dryrun_multichip(n, devices=["cpu"] * n)
    sys_ba, pg, vi = out["system_global_ba"], out["pose_graph"], out["vi_ba"]
    assert abs(sys_ba["err_before"] - j["sys"][0]) <= 1e-4
    assert abs(sys_ba["err_after"] - j["sys"][1]) <= 1e-3
    assert out["sharded_ba_cost"] == pytest.approx(j["ba_cost"], rel=1e-4)
    assert abs(pg["err_before"] - j["pg"][0]) <= 1e-4
    assert abs(pg["err_after"] - j["pg"][1]) <= 1e-4
    assert abs(pg["cost"] - j["pg_cost"]) <= 1e-9
    assert abs(vi["err_before"] - j["vi"][0]) <= 1e-4
    assert abs(vi["err_after"] - j["vi"][1]) <= 2e-3
    assert abs(vi["bg_err"] - j["vi"][2]) <= 1e-3
    assert out["block_ba"]["mesh"] == j["mesh"]
    assert [out["block_ba"]["cut"],
            out["block_ba"]["cut_contiguous"]] == j["cut"]
    if n == 4:
        assert j["mesh"] == [2, 2] and 0 < j["cut"][0] < 0.6 * j["cut"][1]


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tge.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tge.dryrun_multichip(2)
    with pytest.raises(SystemExit):
        tge.main([])


def test_main_on_cpu(capsys):
    blob = tge.main(["--device", "cpu"])
    assert blob["n_inliers"] > 100
    np.testing.assert_allclose(blob["R"], np.eye(3), atol=1e-3)
    assert capsys.readouterr().out.strip().startswith('{"R"')


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_entry_step_launches_each_kernel_once_on_gpu(cuda_device):
    from orb_slam3_ros2_tpu_torch.backend import pose_opt, pose_opt_fused
    from orb_slam3_ros2_tpu_torch.ops import frontend_packed as fp
    from orb_slam3_ros2_tpu_torch.ops import fused_match as fm

    step, args = tge.entry(device=cuda_device)
    counters = (fp.frontend_pass_packed, fm.match_window,
                pose_opt_fused.optimize_pose_fused)
    for c in counters:
        c.launches = 0
    R, t, n = step(*args)
    assert [c.launches for c in counters] == [1, 1, 1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fp, "frontend_pass_packed", fp.frontend_pass_packed_ref)
        mp.setattr(fm, "match_window", fm.match_window_ref)
        mp.setattr(pose_opt_fused, "optimize_pose_fused",
                   pose_opt.optimize_pose)
        Rp, tp, n_p = step(*args)
    assert int(n) > 100 and int(n) == int(n_p)
    np.testing.assert_allclose(R.cpu().numpy(), Rp.cpu().numpy(), atol=5e-5)
    np.testing.assert_allclose(t.cpu().numpy(), tp.cpu().numpy(), atol=5e-4)
