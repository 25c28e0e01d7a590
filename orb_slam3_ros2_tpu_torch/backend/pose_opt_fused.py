"""Pose-only robust LM as one kernel launch per call.

Port of `optimize_pose_fused` (`orb_slam3_ros2_tpu/backend/
pose_opt_fused.py`). CUDA tensors launch `csrc/pose_opt_fused.cu`: one
cluster of 8 thread blocks runs all 3 rounds × 5 iterations (18
evaluations) with each point's state in the registers of the thread that
owns it; `plan_for` picks the points per thread by N. CPU tensors take
the plain version, `pose_opt.optimize_pose`. The two run the same
algorithm with sums taken in another order, so they agree to float
tolerance, not bitwise; two launches on the same inputs agree bitwise.

One call dispatches three `torch.empty` and views, and enqueues the kernel
alone on the current stream (no host sync, no device op besides it).
"""

from __future__ import annotations

import ctypes

import torch

from orb_slam3_ros2_tpu_torch.backend import pose_opt
from orb_slam3_ros2_tpu_torch.backend import residuals as res
from orb_slam3_ros2_tpu_torch.ops import cuda_lib


_C = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "pose_opt_launch": (
        _I, [_C] * 6 + [_I] + [ctypes.c_float] * 6 + [_I] * 5 + [_C] * 4),
    "pose_floor_launch": (_I, [_I] * 3 + [_C] * 2),
}

# (capacity, threads per block, points per thread, blocks per cluster), by
# capacity: a cluster of 8 blocks of 128 threads with 1, 2, 4 or 8 points
# a thread, the fastest plan at 1000, 2000 and 4096 points on an H100
# (one block and clusters of 2 and 4 were slower: `tools/pose_ablation.py`).
# Each is instantiated in `POSE_PLANS` of the source.
PLANS = (
    (1024, 128, 1, 8),
    (2048, 128, 2, 8),
    (4096, 128, 4, 8),
    (8192, 128, 8, 8),
)
MAX_POINTS = PLANS[-1][0]


def plan_for(n: int):
    """(threads, points per thread, cluster size) of the smallest plan that
    holds n points; raises above MAX_POINTS."""
    for cap, nt, p, cl in PLANS:
        if n <= cap:
            return nt, p, cl
    raise ValueError(f"{n} points exceed the pose kernel's largest plan "
                     f"({MAX_POINTS} points)")


def _f32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()


def launch_args(R0, t0, X, uv, inv_sigma2, mask):
    """The tensors one launch reads (f32 and a uint8 view of the bool mask,
    copied only where dtype or layout demand it) and the outputs it writes:
    pose (16,) f32, n_inliers () int32, inliers (N,) bool."""
    N = X.shape[0]
    if (X.shape != (N, 3) or uv.shape != (N, 2)
            or inv_sigma2.shape != (N,) or mask.shape != (N,)
            or R0.numel() != 9 or t0.numel() != 3):
        raise ValueError("pose inputs: X (N, 3), uv (N, 2), inv_sigma2 (N,),"
                         " mask (N,), R0 3x3, t0 (3,)")
    if mask.dtype != torch.bool:
        mask = mask != 0
    if not mask.is_contiguous():
        mask = mask.contiguous()
    inputs = (_f32(R0), _f32(t0), _f32(X), _f32(uv), _f32(inv_sigma2),
              mask.view(torch.uint8))
    dev = X.device
    outputs = (torch.empty((16,), dtype=torch.float32, device=dev),
               torch.empty((), dtype=torch.int32, device=dev),
               torch.empty((N,), dtype=torch.bool, device=dev))
    return inputs, outputs


def _kernel(R0, t0, X, uv, inv_sigma2, mask, fx, fy, cx, cy, n_rounds,
            iters_per_round, chi2_th):
    inputs, outputs = launch_args(R0, t0, X, uv, inv_sigma2, mask)
    if not all(t.is_cuda for t in inputs):
        raise ValueError("expected CUDA tensors for the pose kernel")
    N = X.shape[0]
    nt, p, cl = plan_for(N)
    lib = cuda_lib.load("pose_opt_fused", _SIGNATURES)
    err = lib.pose_opt_launch(
        *[t.data_ptr() for t in inputs], N, float(fx), float(fy), float(cx),
        float(cy), pose_opt.HUBER_MONO, float(chi2_th), int(n_rounds),
        int(iters_per_round), nt, p, cl,
        *[t.data_ptr() for t in outputs],
        torch.cuda.current_stream(X.device).cuda_stream)
    cuda_lib.check(err, "pose_opt_launch")
    return outputs


def optimize_pose_fused(R0, t0, X, uv, inv_sigma2, mask, fx, fy, cx, cy,
                        n_rounds: int = 3, iters_per_round: int = 5,
                        chi2_th: float = res.CHI2_MONO
                        ) -> pose_opt.PoseOptResult:
    """Drop-in for `pose_opt.optimize_pose`. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if X.device.type == "cpu":
        return pose_opt.optimize_pose(
            R0, t0, X, uv, inv_sigma2, mask, fx, fy, cx, cy,
            n_rounds=n_rounds, iters_per_round=iters_per_round,
            chi2_th=chi2_th)
    pose_out, n_inl, inl = _kernel(R0, t0, X, uv, inv_sigma2, mask, fx, fy,
                                   cx, cy, n_rounds, iters_per_round, chi2_th)
    optimize_pose_fused.launches += 1
    return pose_opt.PoseOptResult(
        R=pose_out[:9].view(3, 3), t=pose_out[9:12], inliers=inl,
        n_inliers=n_inl, cost=pose_out[12])


optimize_pose_fused.launches = 0


def latency_floor(n_reductions: int, n_points: int, device) -> torch.Tensor:
    """Launch the measurement kernel `pose_floor_kernel` in the launch shape
    of n_points' plan: only n_reductions reduce-and-broadcasts of the 29
    sums, the design's latency floor. Not used by the port."""
    nt, _, cl = plan_for(n_points)
    out = torch.empty((), dtype=torch.float32, device=device)
    lib = cuda_lib.load("pose_opt_fused", _SIGNATURES)
    cuda_lib.check(lib.pose_floor_launch(
        nt, cl, n_reductions, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream), "pose_floor_launch")
    return out
