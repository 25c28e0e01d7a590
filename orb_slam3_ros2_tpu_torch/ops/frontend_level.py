"""Per-level frontend: FAST score + NMS, 7x7 blur and IC moment maps of one
pyramid level.

Port of the per-level ops of `orb_slam3_ros2_tpu/ops/pallas_kernels.py`:
`fast_nms` (:595, kernel `_fast_nms_call` :161), `blur7` (:611, `_blur_call`
:182), and `frontend_pass` / `frontend_pass_lite` (:375, :395, both
`_frontend_call` :340 with and without the moment maps). The signatures are
the JAX ones minus `interpret`.

Each function launches `csrc/frontend_level.cu` for a CUDA tensor and takes
its plain version (`*_ref`, built from `fast.fast_score`, `fast.nms3x3`,
`pyramid.gaussian_blur` and `orb_descriptor.moment_maps`) for a CPU tensor.
The two agree on the interior: the kernel zero-pads, the plain versions
reflect-pad the blur and pad NMS with -1, so score, keep and blur may differ
within 4 px of the border and the moment maps within 16 px.
"""

from __future__ import annotations

import ctypes

import torch

from orb_slam3_ros2_tpu_torch.ops import cuda_lib
from orb_slam3_ros2_tpu_torch.ops import fast as fast_ops
from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as desc_ops
from orb_slam3_ros2_tpu_torch.ops import pyramid as pyr_ops

_C = ctypes.c_void_p
_I = ctypes.c_int
_TAPS = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "fast_nms_level_launch": (_I, [_C, _I, _I, _C, _C, _C]),
    "blur7_level_launch": (_I, [_C, _I, _I, _TAPS, _C, _C]),
    "frontend_level_launch": (_I, [_C, _I, _I, _TAPS, _I] + [_C] * 6),
}


def _taps():
    return (ctypes.c_float * 7)(
        *[float(v) for v in pyr_ops._gauss_kernel1d(7, 2.0)])


def _prepare(img: torch.Tensor):
    """The image as a contiguous f32 CUDA tensor, the library and its shape."""
    if img.dim() != 2:
        raise ValueError(f"expected an (H, W) image, got {tuple(img.shape)}")
    img = img.to(torch.float32).contiguous()
    cuda_lib.require_cuda(img)
    return img, cuda_lib.load("frontend_level", _SIGNATURES), img.shape


def _maps(n: int, shape, device):
    return [torch.empty(shape, dtype=torch.float32, device=device)
            for _ in range(n)]


# ------------------------------------------------------------ plain versions

def fast_nms_ref(img: torch.Tensor):
    score = fast_ops.fast_score(img)
    return score, fast_ops.nms3x3(score)


def blur7_ref(img: torch.Tensor) -> torch.Tensor:
    return pyr_ops.gaussian_blur(img)


def frontend_pass_ref(img: torch.Tensor):
    score = fast_ops.fast_score(img)
    m01, m10 = desc_ops.moment_maps(img)
    return (score, fast_ops.nms3x3(score), m01, m10,
            pyr_ops.gaussian_blur(img))


def frontend_pass_lite_ref(img: torch.Tensor):
    score = fast_ops.fast_score(img)
    return score, fast_ops.nms3x3(score), pyr_ops.gaussian_blur(img)


# ------------------------------------------------------------------ wrappers

def fast_nms(img: torch.Tensor):
    """(H, W) image -> (score f32, keep bool), as fast_score + nms3x3."""
    if img.device.type == "cpu":
        return fast_nms_ref(img)
    img, lib, (H, W) = _prepare(img)
    score, = _maps(1, (H, W), img.device)
    keep = torch.empty((H, W), dtype=torch.bool, device=img.device)
    err = lib.fast_nms_level_launch(
        cuda_lib.ptr(img), H, W, cuda_lib.ptr(score), cuda_lib.ptr(keep),
        cuda_lib.stream_handle(img.device))
    cuda_lib.check(err, "fast_nms_level_launch")
    fast_nms.launches += 1
    return score, keep


def blur7(img: torch.Tensor) -> torch.Tensor:
    """7x7 sigma=2 Gaussian blur of an (H, W) image (zero-padded border)."""
    if img.device.type == "cpu":
        return blur7_ref(img)
    img, lib, (H, W) = _prepare(img)
    out, = _maps(1, (H, W), img.device)
    err = lib.blur7_level_launch(cuda_lib.ptr(img), H, W, _taps(),
                                 cuda_lib.ptr(out),
                                 cuda_lib.stream_handle(img.device))
    cuda_lib.check(err, "blur7_level_launch")
    blur7.launches += 1
    return out


def _frontend(img: torch.Tensor, with_moments: bool):
    img, lib, (H, W) = _prepare(img)
    score, blur = _maps(2, (H, W), img.device)
    m01, m10 = _maps(2, (H, W), img.device) if with_moments else (None, None)
    keep = torch.empty((H, W), dtype=torch.bool, device=img.device)

    def ptr(t):
        return ctypes.c_void_p(0) if t is None else cuda_lib.ptr(t)

    err = lib.frontend_level_launch(
        cuda_lib.ptr(img), H, W, _taps(), int(with_moments), ptr(score),
        ptr(keep), ptr(m01), ptr(m10), ptr(blur),
        cuda_lib.stream_handle(img.device))
    cuda_lib.check(err, "frontend_level_launch")
    return score, keep, m01, m10, blur


def frontend_pass(img: torch.Tensor):
    """(H, W) image -> (score, keep, m01, m10, blurred) in one pass."""
    if img.device.type == "cpu":
        return frontend_pass_ref(img)
    out = _frontend(img, True)
    frontend_pass.launches += 1
    return out


def frontend_pass_lite(img: torch.Tensor):
    """(H, W) image -> (score, keep, blurred): the pass without moments."""
    if img.device.type == "cpu":
        return frontend_pass_lite_ref(img)
    score, keep, _, _, blur = _frontend(img, False)
    frontend_pass_lite.launches += 1
    return score, keep, blur


fast_nms.launches = 0
blur7.launches = 0
frontend_pass.launches = 0
frontend_pass_lite.launches = 0
