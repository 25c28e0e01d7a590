"""Packed-pyramid frontend: every level's FAST score, NMS, blur and raw
pixels in one canvas, from one kernel launch.

Port of `frontend_pass_packed` (`orb_slam3_ros2_tpu/ops/pallas_kernels.py:
415-592`). All levels are stacked vertically in one (total_rows, W0) canvas
under the static `pack_layout`, with PACK_GAP zero rows between them; the
outputs are four canvases of that shape and the layout.

`frontend_pass_packed` launches `csrc/frontend_packed.cu` for CUDA tensors
and takes the plain version `frontend_pass_packed_ref` for CPU tensors. The
two agree on each level's interior; within 3 px of a level's edge the blur
differs (zero padding in the kernel, reflect padding in the plain version),
a band the extractor never reads (EDGE = 19 > PATCH_R = 15 + 3).
"""

from __future__ import annotations

import ctypes

import torch

from orb_slam3_ros2_tpu_torch.ops import cuda_lib
from orb_slam3_ros2_tpu_torch.ops import fast as fast_ops
from orb_slam3_ros2_tpu_torch.ops import pyramid as pyr_ops

_C = ctypes.c_void_p
_SIGNATURES = {
    "frontend_packed_launch": (
        ctypes.c_int,
        [_C, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
         _C, _C, _C, _C, _C]),
}

PACK_GAP = 8  # zero rows between packed levels (> max stencil reach 4)
PTILE = 48  # canvas height is a multiple of this (the TPU kernel's band)


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


def frontend_pass_packed(levels):
    """All pyramid levels -> (score, keep, blur, raw) canvases + layout.

    CPU tensors take `frontend_pass_packed_ref`; CUDA tensors launch the
    kernel (one launch for the whole pyramid) or raise."""
    if levels[0].device.type == "cpu":
        return frontend_pass_packed_ref(levels)
    layout, total, W0 = _layout_of(levels)
    dev = levels[0].device
    canvas = torch.zeros((total, W0), dtype=torch.float32, device=dev)
    for (r0, h, w), im_l in zip(layout, levels):
        canvas[r0:r0 + h, :w] = im_l
    cuda_lib.require_cuda(canvas)
    score = torch.empty((total, W0), dtype=torch.float32, device=dev)
    keep = torch.empty((total, W0), dtype=torch.bool, device=dev)
    blur = torch.empty((total, W0), dtype=torch.float32, device=dev)
    raw = torch.empty((total, W0), dtype=torch.float32, device=dev)
    lib = cuda_lib.load("frontend_packed", _SIGNATURES)
    flat = [v for entry in layout for v in entry]
    lay = (ctypes.c_int * len(flat))(*flat)
    taps = (ctypes.c_float * 7)(*[float(v) for v in pyr_ops._gauss_kernel1d(7, 2.0)])
    err = lib.frontend_packed_launch(
        cuda_lib.ptr(canvas), total, W0, len(layout), lay, taps,
        cuda_lib.ptr(score), cuda_lib.ptr(keep), cuda_lib.ptr(blur),
        cuda_lib.ptr(raw), cuda_lib.stream_handle(dev))
    cuda_lib.check(err, "frontend_packed_launch")
    frontend_pass_packed.launches += 1
    return score, keep, blur, raw, layout


frontend_pass_packed.launches = 0
