"""Windowed search-by-projection matcher.

Port of `orb_slam3_ros2_tpu/ops/fused_match.py`. Semantics are those of
`matcher.match(a, ma, b, mb, gate=window_gate(uv_a, uv_b, radius), ...)`:
exact integer Hamming distances, argmins that keep the lowest index on a
tie, and a second best that excludes exactly the argmin column.

Descriptors enter in packed form, (N, 8) and (M, 8) int32 words: the kernel
(`csrc/fused_match.cu`) counts bits with popcount, and the map stores
landmarks packed, so no (M, 256) unpacked copy is gathered per frame.
`match_window` launches the kernel for CUDA tensors and takes the plain
version `match_window_ref` for CPU tensors; the acceptance epilogue is torch
in both.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from orb_slam3_ros2_tpu_torch.ops import cuda_lib
from orb_slam3_ros2_tpu_torch.ops import matcher
from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as desc_ops


_C = ctypes.c_void_p
_SIGNATURES = {
    "match_window_launch": (
        ctypes.c_int,
        [_C] * 3 + [ctypes.c_int] + [_C] * 3 + [ctypes.c_int, ctypes.c_float]
        + [_C] * 9),
    "match_window_tiles": (ctypes.c_int, [ctypes.c_int]),
    "match_window_colkey_init": (ctypes.c_ulonglong, []),
}


def match_window_ref(bits_a, mask_a, uv_a, bits_b, mask_b, uv_b, radius: float,
                     max_dist: float = 50.0, ratio: Optional[float] = 0.9,
                     mutual: bool = True) -> matcher.MatchResult:
    """Plain version: the dense masked matcher under a window gate."""
    return matcher.match(
        desc_ops.signs_from_bits(bits_a), mask_a,
        desc_ops.signs_from_bits(bits_b), mask_b,
        max_dist=max_dist, ratio=ratio,
        gate=matcher.window_gate(uv_a, uv_b, radius), mutual=mutual)


def _kernel(bits_a, mask_a, uv_a, bits_b, mask_b, uv_b, radius: float):
    """Launch the two-pass kernel -> (best, second, bidx, cidx)."""
    dev = bits_a.device
    N, M = bits_a.shape[0], bits_b.shape[0]
    mask_a = mask_a.to(torch.uint8).contiguous()
    mask_b = mask_b.to(torch.uint8).contiguous()
    uv_a = uv_a.to(torch.float32).contiguous()
    uv_b = uv_b.to(torch.float32).contiguous()
    bits_a = bits_a.contiguous()
    bits_b = bits_b.contiguous()
    cuda_lib.require_cuda(bits_a, mask_a, uv_a, bits_b, mask_b, uv_b)
    if bits_a.dtype != torch.int32 or bits_b.dtype != torch.int32:
        raise ValueError("packed descriptors must be int32")
    if bits_a.shape[1] != 8 or bits_b.shape[1] != 8:
        raise ValueError("packed descriptors must have 8 words")
    lib = cuda_lib.load("fused_match", _SIGNATURES)
    n_tiles = lib.match_window_tiles(M)
    part = torch.empty((3, n_tiles, N), dtype=torch.int32, device=dev)
    colkey = torch.full((M,), lib.match_window_colkey_init(),
                        dtype=torch.int64, device=dev)
    best = torch.empty((N,), dtype=torch.float32, device=dev)
    second = torch.empty((N,), dtype=torch.float32, device=dev)
    bidx = torch.empty((N,), dtype=torch.int32, device=dev)
    cidx = torch.empty((M,), dtype=torch.int32, device=dev)
    p = cuda_lib.ptr
    err = lib.match_window_launch(
        p(bits_a), p(mask_a), p(uv_a), N, p(bits_b), p(mask_b), p(uv_b), M,
        float(radius), p(part[0]), p(part[1]), p(part[2]), p(colkey),
        p(best), p(second), p(bidx), p(cidx), cuda_lib.stream_handle(dev))
    cuda_lib.check(err, "match_window_launch")
    return best, second, bidx, cidx


def match_window(
    bits_a: torch.Tensor,   # (N, 8) int32 packed
    mask_a: torch.Tensor,   # (N,) bool
    uv_a: torch.Tensor,     # (N, 2) feature positions
    bits_b: torch.Tensor,   # (M, 8) int32 packed
    mask_b: torch.Tensor,   # (M,) bool
    uv_b: torch.Tensor,     # (M, 2) predicted positions in the same image
    radius: float,
    max_dist: float = 50.0,
    ratio: Optional[float] = 0.9,
    mutual: bool = True,
) -> matcher.MatchResult:
    """Windowed best-match search A→B with ratio and mutual checks.

    CPU tensors take `match_window_ref`; CUDA tensors launch the kernel or
    raise."""
    if bits_a.device.type == "cpu":
        return match_window_ref(bits_a, mask_a, uv_a, bits_b, mask_b, uv_b,
                                radius, max_dist, ratio, mutual)
    best, second, bidx, cidx = _kernel(bits_a, mask_a, uv_a, bits_b, mask_b,
                                       uv_b, radius)
    match_window.launches += 1
    N = bits_a.shape[0]
    ok = (best <= max_dist) & mask_a
    if ratio is not None:
        ok = ok & (best < ratio * second)
    if mutual:
        ok = ok & (cidx[bidx.long()] == torch.arange(N, dtype=torch.int32,
                                                     device=bits_a.device))
    idx = torch.where(ok, bidx, -1)
    return matcher.MatchResult(idx=idx, dist=best, valid=ok)


match_window.launches = 0
