"""Windowed search-by-projection matcher.

Port of `orb_slam3_ros2_tpu/ops/fused_match.py`. Semantics are those of
`matcher.match(a, ma, b, mb, gate=window_gate(uv_a, uv_b, radius), ...)`:
exact integer Hamming distances, argmins that keep the lowest index on a
tie, and a second best that excludes exactly the argmin column.

Descriptors enter in packed form, (N, 8) and (M, 8) int32 words: the kernel
(`csrc/fused_match.cu`) counts bits with popcount, and the map stores
landmarks packed, so no (M, 256) unpacked copy is gathered per frame.
`match_window` takes the plain version `match_window_ref` for CPU tensors
and launches the kernel for CUDA tensors: one kernel that also runs the
acceptance test, the mutual check included, and writes idx, dist and
valid; besides views, a call dispatches only the three `torch.empty` of
its outputs.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from orb_slam3_ros2_tpu_torch.ops import cuda_lib
from orb_slam3_ros2_tpu_torch.ops import matcher
from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as desc_ops


_C = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LAUNCH = (_I, [_C, _C, _C, _I, _C, _C, _C, _I, _F, _F, _F]
           + [_I] * 5 + [_C] * 4)
_SIGNATURES = {"match_window_launch": _LAUNCH, "match_floor_launch": _LAUNCH}

# A key holds a distance and a 22-bit index (`IDX_BITS` of the source).
MAX_ENTRIES = 1 << 22

# (threads per block, rows per block, entries in flight a thread),
# instantiated in `MATCH_PLANS` of the source: on an H100 the fastest, or
# within 3% of it, of the plans `tools/match_ablation.py` times at
# 1000 x 4096 / 15 px, 2000 x 4096 and 1000 x 8192 / 4 px.
PLAN = (512, 8, 2)


def match_window_ref(bits_a, mask_a, uv_a, bits_b, mask_b, uv_b, radius: float,
                     max_dist: float = 50.0, ratio: Optional[float] = 0.9,
                     mutual: bool = True) -> matcher.MatchResult:
    """Plain version: the dense masked matcher under a window gate."""
    return matcher.match(
        desc_ops.signs_from_bits(bits_a), mask_a,
        desc_ops.signs_from_bits(bits_b), mask_b,
        max_dist=max_dist, ratio=ratio,
        gate=matcher.window_gate(uv_a, uv_b, radius), mutual=mutual)


def plan_for(N: int, M: int):
    """(threads, rows per block, entries in flight a thread) for N rows and
    M columns: 8 rows a block give 125 blocks at N = 1000 and 250 at 2000
    on the 132 SMs."""
    if not (1 <= N <= MAX_ENTRIES and 1 <= M <= MAX_ENTRIES):
        raise ValueError(f"match_window takes 1..{MAX_ENTRIES} rows and "
                         f"columns, got {N} x {M}")
    return PLAN


def blocks_for(N: int, M: int) -> int:
    """Blocks of one launch, as the source computes them."""
    return -(-N // plan_for(N, M)[1])


def _side(bits, mask, uv, what: str):
    """One side's tensors as the kernel reads them: int32 bits (n, 8),
    16-byte aligned; f32 uv (n, 2), 8-byte aligned; the bool mask as a
    uint8 view. Copies only where dtype, layout or alignment demand it."""
    n = bits.shape[0] if bits.dim() == 2 else -1
    if (bits.dim() != 2 or bits.shape[1] != 8 or tuple(uv.shape) != (n, 2)
            or tuple(mask.shape) != (n,)):
        raise ValueError(f"{what}: bits (n, 8), uv (n, 2), mask (n,)")
    if bits.dtype != torch.int32:
        raise ValueError("packed descriptors must be int32")
    if uv.dtype != torch.float32:
        uv = uv.to(torch.float32)
    if mask.dtype != torch.bool:
        mask = mask != 0
    if not bits.is_contiguous() or bits.data_ptr() % 16:
        bits = bits.clone(memory_format=torch.contiguous_format)
    if not uv.is_contiguous() or uv.data_ptr() % 8:
        uv = uv.clone(memory_format=torch.contiguous_format)
    if not mask.is_contiguous():
        mask = mask.contiguous()
    return bits, mask.view(torch.uint8), uv


def launch_args(bits_a, mask_a, uv_a, bits_b, mask_b, uv_b):
    """The tensors one launch reads ((bits, mask, uv) of each side) and
    writes: idx (N,) int32, dist (N,) f32, valid (N,) bool."""
    a = _side(bits_a, mask_a, uv_a, "rows")
    b = _side(bits_b, mask_b, uv_b, "columns")
    N, M = a[0].shape[0], b[0].shape[0]
    plan_for(N, M)
    dev = a[0].device
    return a + b, (torch.empty((N,), dtype=torch.int32, device=dev),
                   torch.empty((N,), dtype=torch.float32, device=dev),
                   torch.empty((N,), dtype=torch.bool, device=dev))


def _launch(entry: str, bits_a, mask_a, uv_a, bits_b, mask_b, uv_b,
            radius: float, max_dist: float, ratio: Optional[float],
            mutual: bool):
    if not all(t.is_cuda for t in (bits_a, mask_a, uv_a, bits_b, mask_b,
                                   uv_b)):
        raise ValueError("expected CUDA tensors for the match kernel")
    inputs, outputs = launch_args(bits_a, mask_a, uv_a, bits_b, mask_b, uv_b)
    dev = inputs[0].device
    if any(t.device != dev for t in inputs):
        raise ValueError("the match kernel's inputs lie on different devices")
    N, M = inputs[0].shape[0], inputs[3].shape[0]
    lib = cuda_lib.load("fused_match", _SIGNATURES)
    p = [t.data_ptr() for t in inputs]
    err = getattr(lib, entry)(
        p[0], p[1], p[2], N, p[3], p[4], p[5], M, float(radius),
        float(max_dist), 0.0 if ratio is None else float(ratio),
        ratio is not None, bool(mutual), *plan_for(N, M),
        *[t.data_ptr() for t in outputs],
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, entry)
    return outputs


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
    idx, dist, valid = _launch("match_window_launch", bits_a, mask_a, uv_a,
                               bits_b, mask_b, uv_b, radius, max_dist, ratio,
                               mutual)
    match_window.launches += 1
    return matcher.MatchResult(idx=idx, dist=dist, valid=valid)


match_window.launches = 0


def latency_floor(bits_a, mask_a, uv_a, bits_b, mask_b, uv_b, radius: float,
                  max_dist: float = 50.0, ratio: Optional[float] = 0.9,
                  mutual: bool = True):
    """Launch the kernel of a `match_window` call on these CUDA tensors with
    both its sweeps taken out (owner loads, reductions and acceptance: the
    design's latency floor). Its outputs mean nothing. Not used by the
    port."""
    return _launch("match_floor_launch", bits_a, mask_a, uv_a, bits_b,
                   mask_b, uv_b, radius, max_dist, ratio, mutual)
