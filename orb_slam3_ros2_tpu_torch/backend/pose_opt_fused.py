"""Pose-only robust LM as one kernel launch per call.

Port of `optimize_pose_fused` (`orb_slam3_ros2_tpu/backend/
pose_opt_fused.py`). CUDA tensors launch `csrc/pose_opt_fused.cu`: one
thread block runs all 3 rounds × 5 iterations (18 evaluations); CPU tensors
take the plain version, `pose_opt.optimize_pose`. The two run the same
algorithm with sums taken in another order, so they agree to float
tolerance, not bitwise.
"""

from __future__ import annotations

import ctypes

import torch

from orb_slam3_ros2_tpu_torch.backend import pose_opt
from orb_slam3_ros2_tpu_torch.backend import residuals as res
from orb_slam3_ros2_tpu_torch.ops import cuda_lib


_C = ctypes.c_void_p
_SIGNATURES = {
    "pose_opt_launch": (
        ctypes.c_int,
        [_C] * 5 + [ctypes.c_int] + [ctypes.c_float] * 6 + [ctypes.c_int] * 2
        + [_C] * 3),
    "pose_opt_max_points": (ctypes.c_int, []),
}


def _kernel(R0, t0, X, uv, inv_sigma2, mask, fx, fy, cx, cy, n_rounds,
            iters_per_round, chi2_th):
    dev = X.device
    N = X.shape[0]
    pose0 = torch.cat([R0.reshape(9), t0.reshape(3)]).to(torch.float32)
    X = X.to(torch.float32).contiguous()
    uv = uv.to(torch.float32).contiguous()
    invs2 = inv_sigma2.to(torch.float32).contiguous()
    mask8 = mask.to(torch.uint8).contiguous()
    cuda_lib.require_cuda(pose0, X, uv, invs2, mask8)
    lib = cuda_lib.load("pose_opt_fused", _SIGNATURES)
    if N > lib.pose_opt_max_points():
        raise ValueError(f"{N} points exceed the kernel's shared memory "
                         f"({lib.pose_opt_max_points()} max)")
    pose_out = torch.empty((16,), dtype=torch.float32, device=dev)
    inl = torch.empty((N,), dtype=torch.bool, device=dev)
    p = cuda_lib.ptr
    err = lib.pose_opt_launch(
        p(pose0), p(X), p(uv), p(invs2), p(mask8), N, float(fx), float(fy),
        float(cx), float(cy), float(pose_opt.HUBER_MONO), float(chi2_th),
        int(n_rounds), int(iters_per_round), p(pose_out), p(inl),
        cuda_lib.stream_handle(dev))
    cuda_lib.check(err, "pose_opt_launch")
    return pose_out, inl


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
    pose_out, inl = _kernel(R0, t0, X, uv, inv_sigma2, mask, fx, fy, cx, cy,
                            n_rounds, iters_per_round, chi2_th)
    optimize_pose_fused.launches += 1
    return pose_opt.PoseOptResult(
        R=pose_out[:9].reshape(3, 3), t=pose_out[9:12], inliers=inl,
        n_inliers=pose_out[13].to(torch.int32), cost=pose_out[12])


optimize_pose_fused.launches = 0
