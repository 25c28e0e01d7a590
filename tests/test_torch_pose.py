"""Parity of the port's pose-only LM with the JAX package on the CPU (the
bounds of tests/test_fused_kernels.py:100-116: R atol 5e-5, t atol 5e-4,
identical inlier sets), and of the pose CUDA kernel with its plain version
on a GPU."""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_ros2_tpu.backend import pose_opt as jpo
from orb_slam3_ros2_tpu.backend import pose_opt_fused as jpof
from orb_slam3_ros2_tpu.geom import lie as jlie
from orb_slam3_ros2_tpu_torch.backend import pose_opt as tpo
from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused as tpof


def _pose_case(seed=1, N=300, outlier_frac=0.3):
    """tests/test_fused_kernels.py's case, as numpy arrays."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N),
                  rng.uniform(4, 10, N)], -1).astype(np.float32)
    fx = fy = 400.0
    cx, cy = 320.0, 240.0
    R_true = np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.1, 0.02])))
    t_true = np.array([0.1, -0.05, 0.2], np.float32)
    xc = X @ R_true.T + t_true
    uv = np.stack([fx * xc[:, 0] / xc[:, 2] + cx,
                   fy * xc[:, 1] / xc[:, 2] + cy], -1).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    out = rng.random(N) < outlier_frac
    uv[out] += rng.uniform(-80, 80, (out.sum(), 2)).astype(np.float32)
    mask = rng.random(N) > 0.05
    invs2 = (1.2 ** (-2.0 * rng.integers(0, 8, N))).astype(np.float32)
    return (X, uv, invs2, mask, (fx, fy, cx, cy), R_true, t_true)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("seed,N,frac", [(1, 300, 0.3), (2, 1000, 0.3),
                                         (3, 120, 0.0)])
def test_pose_opt_matches_jax(seed, N, frac):
    X, uv, invs2, mask, K, R_true, t_true = _pose_case(seed, N, frac)
    ref = jpo.optimize_pose(jnp.eye(3), jnp.zeros(3), jnp.asarray(X),
                            jnp.asarray(uv), jnp.asarray(invs2),
                            jnp.asarray(mask), *K)
    refs = [ref]
    if seed == 1:  # the Pallas kernel in interpret mode (slow on a CPU)
        refs.append(jpof.optimize_pose_fused(
            jnp.eye(3), jnp.zeros(3), jnp.asarray(X), jnp.asarray(uv),
            jnp.asarray(invs2), jnp.asarray(mask), *K, interpret=True))
    got = tpof.optimize_pose_fused(torch.eye(3), torch.zeros(3),
                                   torch.from_numpy(X), torch.from_numpy(uv),
                                   torch.from_numpy(invs2),
                                   torch.from_numpy(mask), *K)
    assert np.abs(got.R.numpy() - R_true).max() < 2e-3
    assert np.abs(got.t.numpy() - t_true).max() < 1e-2
    for r in refs:
        np.testing.assert_allclose(got.R.numpy(), np.asarray(r.R), atol=5e-5)
        np.testing.assert_allclose(got.t.numpy(), np.asarray(r.t), atol=5e-4)
        assert int(got.n_inliers) == int(r.n_inliers)
        np.testing.assert_array_equal(got.inliers.numpy(),
                                      np.asarray(r.inliers))
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-3)


def test_pose_opt_from_perturbed_start():
    """6° / 0.3 m initial error, as the JAX docstring's budget claim."""
    X, uv, invs2, mask, K, R_true, t_true = _pose_case(4, 400, 0.2)
    R0, t0 = _perturbed_start(R_true, t_true)
    ref = jpo.optimize_pose(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X),
                            jnp.asarray(uv), jnp.asarray(invs2),
                            jnp.asarray(mask), *K)
    got = tpo.optimize_pose(torch.from_numpy(R0), torch.from_numpy(t0),
                            torch.from_numpy(X), torch.from_numpy(uv),
                            torch.from_numpy(invs2), torch.from_numpy(mask),
                            *K)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=5e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=5e-4)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))


def _perturbed_start(R_true, t_true):
    """6° about x and 0.3 m along x off the true pose."""
    R0 = (np.asarray(jlie.so3_exp(jnp.asarray([0.1, 0.0, 0.0]))) @ R_true
          ).astype(np.float32)
    return R0, (t_true + np.array([0.3, 0.0, 0.0])).astype(np.float32)


# (seed, N, outlier fraction, every point masked out, perturbed start)
GPU_CASES = {
    "N=1": (6, 1, 0.0, False, False),
    "N=33": (5, 33, 0.3, False, False),
    "N=1000": (2, 1000, 0.3, False, False),
    "N=2000": (4, 2000, 0.3, False, False),
    "N=4096": (8, 4096, 0.3, False, False),
    "all_masked": (9, 500, 0.3, True, False),
    "perturbed_start": (4, 400, 0.2, False, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GPU_CASES))
def test_pose_kernel_matches_plain_on_gpu(cuda_device, case):
    """The kernel against the plain version on the card, in the plan
    `plan_for` picks (one block up to 2048 points, clusters above): R
    atol 5e-5, t atol 5e-4, identical inliers and n_inliers; two launches
    give the same bits."""
    seed, N, frac, masked_out, perturbed = GPU_CASES[case]
    X, uv, invs2, mask, K, R_true, t_true = _pose_case(seed, N, frac)
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    if masked_out:
        mask[:] = False
    if perturbed:
        R0, t0 = _perturbed_start(R_true, t_true)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (R0, t0, X, uv, invs2, mask)]
    n = tpof.optimize_pose_fused.launches
    got = tpof.optimize_pose_fused(*args, *K)
    again = tpof.optimize_pose_fused(*args, *K)
    ref = tpo.optimize_pose(*args, *K)
    assert tpof.optimize_pose_fused.launches == n + 2
    np.testing.assert_allclose(got.R.cpu().numpy(), ref.R.cpu().numpy(),
                               atol=5e-5)
    np.testing.assert_allclose(got.t.cpu().numpy(), ref.t.cpu().numpy(),
                               atol=5e-4)
    np.testing.assert_array_equal(got.inliers.cpu().numpy(),
                                  ref.inliers.cpu().numpy())
    assert got.n_inliers.dtype == torch.int32
    assert int(got.n_inliers) == int(ref.n_inliers)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if N >= 1000:
        np.testing.assert_allclose(got.R.cpu().numpy(), R_true, atol=2e-3)


def test_pose_wrapper_raises_off_cpu_without_a_kernel():
    """A non-CPU, non-CUDA tensor is refused, never optimized by the plain
    version."""
    meta = dict(device="meta")
    n = tpof.optimize_pose_fused.launches
    with pytest.raises(ValueError, match="CUDA"):
        tpof.optimize_pose_fused(
            torch.eye(3, **meta), torch.zeros(3, **meta),
            torch.zeros((10, 3), **meta), torch.zeros((10, 2), **meta),
            torch.ones(10, **meta), torch.ones(10, dtype=torch.bool, **meta),
            400.0, 400.0, 320.0, 240.0)
    assert tpof.optimize_pose_fused.launches == n


@pytest.mark.parametrize("N,masked_out", [(2000, False), (4096, False),
                                          (300, True)])
def test_pose_opt_matches_jax_at_scale(N, masked_out):
    """The plain port against JAX `optimize_pose` at KITTI's 2000 features,
    at 4096 points, and with every point masked out (the pose stays put,
    no inliers, zero cost)."""
    X, uv, invs2, mask, K, R_true, t_true = _pose_case(N, N, 0.3)
    if masked_out:
        mask[:] = False
    ref = jpo.optimize_pose(jnp.eye(3), jnp.zeros(3), jnp.asarray(X),
                            jnp.asarray(uv), jnp.asarray(invs2),
                            jnp.asarray(mask), *K)
    got = tpo.optimize_pose(torch.eye(3), torch.zeros(3),
                            torch.from_numpy(X), torch.from_numpy(uv),
                            torch.from_numpy(invs2), torch.from_numpy(mask),
                            *K)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=5e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=5e-4)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers)
    if masked_out:
        assert int(got.n_inliers) == 0 and float(got.cost) == 0.0
        np.testing.assert_array_equal(got.R.numpy(), np.eye(3))
    else:
        np.testing.assert_allclose(got.R.numpy(), R_true, atol=2e-3)


@pytest.mark.parametrize("N,plan", [
    (1, (128, 1, 8)), (1000, (128, 1, 8)), (1024, (128, 1, 8)),
    (1025, (128, 2, 8)), (2000, (128, 2, 8)), (2448, (128, 4, 8)),
    (4096, (128, 4, 8)), (4097, (128, 8, 8)), (8192, (128, 8, 8))])
def test_pose_plan_by_points(N, plan):
    """Clusters of 8 blocks of 128 threads, 1, 2, 4 or 8 points a thread;
    every plan holds N."""
    assert tpof.plan_for(N) == plan
    nt, p, cl = plan
    assert N <= nt * p * cl


def test_pose_plans_are_instantiated_and_refuse_above_the_largest():
    """Every plan of the wrapper is instantiated in the source's
    POSE_PLANS, capacities grow, and N above the largest raises before
    any launch."""
    src = (Path(tpof.__file__).resolve().parents[1] / "csrc"
           / "pose_opt_fused.cu").read_text()
    block = src[src.index("#define POSE_PLANS(X)"):]
    block = block[:block.index("\n\n")]
    inst = {tuple(int(v) for v in m)
            for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", block)}
    caps = [cap for cap, *_ in tpof.PLANS]
    assert caps == sorted(caps) and tpof.MAX_POINTS == caps[-1] >= 8192
    for cap, nt, p, cl in tpof.PLANS:
        assert (nt, p, cl) in inst and cap == nt * p * cl
    n = tpof.optimize_pose_fused.launches
    meta = dict(device="meta")
    N = tpof.MAX_POINTS + 1
    with pytest.raises(ValueError, match="largest plan"):
        tpof.plan_for(N)
    with pytest.raises(ValueError):
        tpof.optimize_pose_fused(
            torch.eye(3, **meta), torch.zeros(3, **meta),
            torch.zeros((N, 3), **meta), torch.zeros((N, 2), **meta),
            torch.ones(N, **meta), torch.ones(N, dtype=torch.bool, **meta),
            400.0, 400.0, 320.0, 240.0)
    assert tpof.optimize_pose_fused.launches == n


def test_pose_launch_args_view_the_mask_and_allocate_int32_count():
    """What one launch is handed: the bool mask as a uint8 view of the same
    memory (no copy), f32 inputs passed through, pose (16,) f32,
    n_inliers () int32, inliers (N,) bool, and nothing dispatched but
    `empty` and views."""
    from torch.utils._python_dispatch import TorchDispatchMode

    X, uv, invs2, mask, K, _, _ = _pose_case(3, 50, 0.3)
    args = [torch.eye(3), torch.zeros(3)] + [
        torch.from_numpy(a) for a in (X, uv, invs2, mask)]

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            self.ops.append(func)
            return func(*a, **(kw or {}))

    with Log() as log:
        inputs, (pose, n_inl, inl) = tpof.launch_args(*args)
    assert all(op is torch.ops.aten.empty.memory_format or op.is_view
               for op in log.ops), log.ops
    assert sum(op is torch.ops.aten.empty.memory_format
               for op in log.ops) == 3
    for got, given in zip(inputs, args):
        assert got.data_ptr() == given.data_ptr()
    assert inputs[5].dtype == torch.uint8
    assert pose.dtype == torch.float32 and tuple(pose.shape) == (16,)
    assert n_inl.dtype == torch.int32 and tuple(n_inl.shape) == ()
    assert inl.dtype == torch.bool and tuple(inl.shape) == (50,)
    # a float mask is compared with 0 first
    fmask = torch.from_numpy(mask.astype(np.float32))
    inputs, _ = tpof.launch_args(*args[:5], fmask)
    np.testing.assert_array_equal(inputs[5].numpy(), mask.astype(np.uint8))
    with pytest.raises(ValueError, match="X \\(N, 3\\)"):
        tpof.launch_args(*args[:2], args[2][:, :2], *args[3:])


def test_pose_ablation_edits_apply_to_the_kernel():
    """tools/pose_ablation.py builds its variants by editing the solve's
    call once each; the edits must still find it."""
    from orb_slam3_ros2_tpu_torch.tools import pose_ablation

    src = (Path(tpof.__file__).resolve().parents[1] / "csrc"
           / "pose_opt_fused.cu").read_text()
    variants = pose_ablation.variants(src)
    plans = sorted({p for v in pose_ablation.PLANS.values() for p in v})
    assert variants["full"] == pose_ablation.with_plans(src, plans)
    assert "X(256, 1, 8)" in variants["full"] and "X(256, 1, 8)" not in src
    assert "s_pose[12]" in variants["thread0_solve"]
    assert "lm_step(G, lam" not in variants["no_solve"]
    assert variants["div_solve"].count("s / L[") == 3
    assert "rsqrtf(" not in variants["sqrt_solve"] and "rsqrtf(" in src
    assert len(set(variants.values())) == 5
    for cap, plans in pose_ablation.PLANS.items():
        for nt, p, cl in plans:
            assert nt * p * cl == cap
