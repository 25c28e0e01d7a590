"""Packed-pyramid frontend: every level's FAST score, NMS, blur and raw
pixels in four canvases, from one kernel launch.

Port of `frontend_pass_packed` (`orb_slam3_ros2_tpu/ops/pallas_kernels.py:
415-592`). The outputs are four (total_rows, W0) canvases that stack the
levels vertically under the static `pack_layout`, with PACK_GAP zero rows
between them, and the layout.

`frontend_pass_packed` launches `csrc/frontend_packed.cu` for CUDA tensors
and takes the plain version `frontend_pass_packed_ref` for CPU tensors. The
kernel reads the levels where they lie: the wrapper allocates the four
outputs and launches the kernel, nothing else. Its blocks follow a launch
plan (`launch_plan`, built once per pyramid shape): one block for each
tile of each level, then one for each ZR canvas rows that hold cells
outside the levels, which it writes 0 / false. The two versions agree
exactly on score everywhere, on keep at least 4 px inside each level, on
raw everywhere and on blur at least 4 px inside each level; nearer a
level's edge the blur differs (zero padding in the kernel, reflect padding
in the plain version), a band the extractor never reads (EDGE = 19 >
PATCH_R = 15 + 3).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from orb_slam3_ros2_tpu_torch.ops import cuda_lib
from orb_slam3_ros2_tpu_torch.ops import fast as fast_ops
from orb_slam3_ros2_tpu_torch.ops import pyramid as pyr_ops

_C = ctypes.c_void_p
_SIGNATURES = {
    "frontend_packed_launch": (
        ctypes.c_int,
        [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
         ctypes.POINTER(ctypes.c_float), _C, _C, _C, _C, _C]),
}

PACK_GAP = 8  # zero rows between packed levels (> max stencil reach 4)
PTILE = 48  # canvas height is a multiple of this (the TPU kernel's band)
# the kernel's tile (TW x TH cells of one level) and its zero-fill blocks'
# height (ZR canvas rows, one warp each), as in csrc/frontend_packed.cu,
# which refuses a plan made for others
TW, TH, ZR = 64, 16, 8
_TAPS = (ctypes.c_float * 7)(*[float(v)
                               for v in pyr_ops._gauss_kernel1d(7, 2.0)])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# copied verbatim from orb_slam3_ros2_tpu/ops/pallas_kernels.py:439-447
def pack_layout(shapes):
    """[(H_l, W_l)] -> (layout [(row0, H_l, W_l)], total_rows)."""
    layout = []
    off = 0
    for (h, w) in shapes:
        layout.append((off, h, w))
        off += h + PACK_GAP
    total = _cdiv(off - PACK_GAP, PTILE) * PTILE
    return tuple(layout), total


def _layout_of(levels):
    shapes = tuple((int(l.shape[0]), int(l.shape[1])) for l in levels)
    layout, total = pack_layout(shapes)
    return layout, total, shapes[0][1]


class LaunchPlan(NamedTuple):
    """The kernel's grid for one pyramid shape. Blocks 0 .. n_tiles-1 are
    tiles: level l owns tiles first[l] .. first[l + 1] - 1, tiles_x[l] to a
    row, in row-major order. Block n_tiles + z zeroes ZR canvas
    rows from zero_row0 + z * ZR on (zero_row0: the rows below level 0,
    which alone is W0 wide), outside the level that owns each row. `table`
    is the plan as the kernel's C entry point takes it."""

    layout: Tuple[Tuple[int, int, int], ...]
    total: int
    W0: int
    tiles_x: Tuple[int, ...]
    first: Tuple[int, ...]
    n_tiles: int
    n_zero: int
    zero_row0: int
    table: ctypes.Array


@functools.lru_cache(maxsize=32)
def launch_plan(levels: Tuple[Tuple[int, int, int], ...]) -> LaunchPlan:
    """Plan for levels given as (H_l, W_l, row pitch in elements)."""
    layout, total = pack_layout([(h, w) for h, w, _ in levels])
    W0 = levels[0][1]
    if any(w > W0 or pitch < w for _, w, pitch in levels):
        raise ValueError(f"levels {levels}: each must fit the {W0}-wide "
                         f"canvas and its row pitch")
    tiles_x = tuple(_cdiv(w, TW) for _, w, _ in levels)
    first, n = [], 0
    for (h, _, _), tx in zip(levels, tiles_x):
        first.append(n)
        n += tx * _cdiv(h, TH)
    zero_row0 = levels[0][0]
    n_zero = _cdiv(total - zero_row0, ZR)
    flat = [TW, TH, ZR, len(levels), total, W0, n, n_zero, zero_row0]
    for (r0, h, w), (_, _, pitch), tx, f in zip(layout, levels, tiles_x,
                                                 first):
        flat += [r0, h, w, pitch, tx, f]
    return LaunchPlan(layout, total, W0, tiles_x, tuple(first), n, n_zero,
                      zero_row0, (ctypes.c_int * len(flat))(*flat))


def frontend_pass_packed_ref(levels):
    """Plain version: per-level fast_score / nms3x3 / gaussian_blur placed
    into zero canvases (the JAX CPU fallback, pallas_kernels.py:569-584)."""
    layout, total, W0 = _layout_of(levels)
    dev = levels[0].device
    score = torch.zeros((total, W0), dtype=torch.float32, device=dev)
    keep = torch.zeros((total, W0), dtype=torch.bool, device=dev)
    blur = torch.zeros((total, W0), dtype=torch.float32, device=dev)
    raw = torch.zeros((total, W0), dtype=torch.float32, device=dev)
    for (r0, h, w), im_l in zip(layout, levels):
        s_l = fast_ops.fast_score(im_l)
        score[r0:r0 + h, :w] = s_l
        keep[r0:r0 + h, :w] = fast_ops.nms3x3(s_l)
        blur[r0:r0 + h, :w] = pyr_ops.gaussian_blur(im_l)
        raw[r0:r0 + h, :w] = im_l
    return score, keep, blur, raw, layout


def plan_of(levels) -> LaunchPlan:
    """The launch plan of CUDA levels; raises on what the kernel does not
    take (another device, another dtype, columns that are not adjacent)."""
    for im in levels:
        if im.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got {im.device}")
        if im.dtype != torch.float32 or im.dim() != 2 or im.stride(1) != 1:
            raise ValueError("levels must be (H, W) float32 with unit "
                             "column stride")
    return launch_plan(tuple((int(im.shape[0]), int(im.shape[1]),
                              int(im.stride(0))) for im in levels))


def frontend_pass_packed(levels):
    """All pyramid levels -> (score, keep, blur, raw) canvases + layout.

    CPU tensors take `frontend_pass_packed_ref`; CUDA tensors launch the
    kernel (one launch for the whole pyramid, the levels read in place) or
    raise."""
    if levels[0].device.type == "cpu":
        return frontend_pass_packed_ref(levels)
    plan = plan_of(levels)
    dev = levels[0].device
    shape = (plan.total, plan.W0)
    score = torch.empty(shape, dtype=torch.float32, device=dev)
    keep = torch.empty(shape, dtype=torch.bool, device=dev)
    blur = torch.empty(shape, dtype=torch.float32, device=dev)
    raw = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = cuda_lib.load("frontend_packed", _SIGNATURES)
    ptrs = (ctypes.c_void_p * len(levels))(*[im.data_ptr() for im in levels])
    err = lib.frontend_packed_launch(
        plan.table, ptrs, _TAPS, cuda_lib.ptr(score), cuda_lib.ptr(keep),
        cuda_lib.ptr(blur), cuda_lib.ptr(raw), cuda_lib.stream_handle(dev))
    cuda_lib.check(err, "frontend_packed_launch")
    frontend_pass_packed.launches += 1
    return score, keep, blur, raw, plan.layout


frontend_pass_packed.launches = 0
