"""Per-level frontend: FAST score + NMS, 7x7 blur and IC moment maps of one
pyramid level.

Port of the per-level ops of `orb_slam3_ros2_tpu/ops/pallas_kernels.py`:
`fast_nms` (:595, kernel `_fast_nms_call` :161), `blur7` (:611, `_blur_call`
:182), and `frontend_pass` / `frontend_pass_lite` (:375, :395, both
`_frontend_call` :340 with and without the moment maps). The signatures are
the JAX ones minus `interpret`.

Each function launches `csrc/frontend_level.cu` for a CUDA tensor (one
launch: the wrapper allocates the outputs with `torch.empty` and passes
their pointers) and takes its plain version (`*_ref`, built from
`fast.fast_score`, `fast.nms3x3`, `pyramid.gaussian_blur` and
`orb_descriptor.moment_maps`, the JAX package's CPU fallback) for a CPU
tensor.

The kernels compute the Pallas kernels' function on the whole image: zero
padding (NMS against 0 outside, the blur zero-padded). `*_zero` are plain
versions of exactly that (score equal, blur bit-equal, moments in float64),
which the tests and `chip_smoke.py` hold the kernels to; the `*_ref`
versions agree with them on the interior only (reflect-padded blur, NMS
against -1 outside), within 4 px of the border for score, keep and blur.

`launch_grid` and `store_counts` restate the kernels' launch plans (tile,
grid, which thread stores which cell; blur7's strips and lanes too) for the
CPU tests.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.ops import cuda_lib
from orb_slam3_ros2_tpu_torch.ops import fast as fast_ops
from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as desc_ops
from orb_slam3_ros2_tpu_torch.ops import pyramid as pyr_ops

_C = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fast_nms_level_launch": (_I, [_C, _I, _I, _C, _C, _C]),
    "blur7_level_launch": (_I, [_C, _I, _I, _C, _C]),
    "frontend_level_launch": (_I, [_C, _I, _I, _I] + [_C] * 6),
}

# csrc/frontend_level.cu: the output tile (width, height) of a block with
# the moment maps (MTW x MTH) and without (LTW x LTH), and the outputs a
# moment thread owns (MC columns x MK rows of one map, 128 threads a map
# and tile); blur7's rows a warp (BRW) and warps a block (BNW): a warp's
# strip is one column a lane less the 3 lanes of halo on either side, the
# block's tile that strip by BNW x BRW rows
BLUR_ROWS, BLUR_WARPS = 8, 2
MOM_TILE = (96, 16)
LITE_TILE = (64, 16)
BLUR_TILE = (32 - 6, BLUR_WARPS * BLUR_ROWS)
MOM_COLS, MOM_ROWS = 3, 4


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


# ------------------------------------- plain zero-padding mirror of the kernels

def fast_nms_zero(img: torch.Tensor):
    """FAST score (its ring never leaves the image at an interior pixel, so
    the score is `fast_score`'s) and NMS against 0 outside the image."""
    score = fast_ops.fast_score(img)
    return score, fast_ops.nms3x3(score, pad_value=0.0)


def blur7_zero(img: torch.Tensor) -> torch.Tensor:
    return pyr_ops.gaussian_blur(img, mode="constant")


def frontend_pass_zero(img: torch.Tensor):
    """(score, keep, m01, m10, blurred) with the kernels' zero padding; the
    moment maps are `moment_maps`, whose edge-extended prefix sums are the
    sums of a zero-padded image."""
    score, keep = fast_nms_zero(img)
    m01, m10 = desc_ops.moment_maps(img)
    return score, keep, m01, m10, blur7_zero(img)


def frontend_pass_lite_zero(img: torch.Tensor):
    score, keep = fast_nms_zero(img)
    return score, keep, blur7_zero(img)


# ------------------------------------------------------------ launch plan

def _tile(moments: bool, blur7: bool):
    return BLUR_TILE if blur7 else MOM_TILE if moments else LITE_TILE


def launch_grid(H: int, W: int, moments: bool = False, blur7: bool = False):
    """(blocks across, blocks down) of a per-level launch: `blur7`'s, or
    the level kernel's with or without `moments`."""
    tw, th = _tile(moments, blur7)
    return -(-W // tw), -(-H // th)


def store_counts(H: int, W: int, moments: bool = False, blur7: bool = False):
    """How many times a launch (`blur7`; `frontend_pass` with `moments`,
    else `fast_nms` / `frontend_pass_lite`) stores each cell of score /
    keep / blur and, with `moments`, of m01 / m10, as (H, W) int arrays,
    restating the kernel's stores: a tile row's cells [x0, min(x0 + TW,
    W)) in groups of 4 on the output's 16-byte grid (a group that starts
    at x0 - ((y W + x0) & 3) + 4 g; blur7: each of a warp's lanes 3-28 its
    own column of the warp's BRW rows, cell by cell), and a moment
    thread's MC x MK outputs of its map inside the image (the counts of
    one map). Also returns the share of score (blur) cells written by
    16-byte stores."""
    tw, th = _tile(moments, blur7)
    gx, gy = launch_grid(H, W, moments, blur7)
    ng = tw // 4 + 1
    counts = np.zeros((H, W), np.int64)
    vector = 0
    y = np.arange(H)[:, None]
    # blur7's rows: block row b, warp w, row i
    b, w, i = np.ix_(np.arange(gy), np.arange(BLUR_WARPS), np.arange(BLUR_ROWS))
    yb = (b * th + w * BLUR_ROWS + i).ravel()
    yb = yb[yb < H]
    for bx in range(gx):
        x0 = bx * tw
        xe = min(x0 + tw, W)
        xs0 = x0 - ((y * W + x0) & 3)
        if blur7:
            x = x0 + np.arange(32)[3:29] - 3  # lanes 3-28
            np.add.at(counts, np.ix_(yb, x[x < xe]), 1)
            continue
        for g in range(ng):
            xs = xs0 + 4 * g  # (H, 1): each row's group start
            lo = np.maximum(xs, x0)
            hi = np.minimum(xs + 4, xe)
            for j in range(4):
                x = xs + j
                hit = (x >= lo) & (x < hi)
                rows, _ = np.nonzero(hit)
                np.add.at(counts, (rows, x[rows, 0]), 1)
            vector += 4 * int(((xs >= x0) & (xs + 4 <= xe)).sum())
    mom = None
    if moments:
        # block (by, bx), warp w, row k, lane l, column j
        by, bx, w, k, l, j = np.ix_(
            np.arange(gy), np.arange(gx), np.arange(th // MOM_ROWS),
            np.arange(MOM_ROWS), np.arange(tw // MOM_COLS),
            np.arange(MOM_COLS))
        yy = np.broadcast_to(by * th + MOM_ROWS * w + k, (gy, gx) + (
            th // MOM_ROWS, MOM_ROWS, tw // MOM_COLS, MOM_COLS))
        xx = np.broadcast_to(bx * tw + MOM_COLS * l + j, yy.shape)
        inside = (yy < H) & (xx < W)
        mom = np.bincount((yy * W + xx)[inside], minlength=H * W).reshape(H, W)
    return counts, mom, vector / (H * W)


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
    err = lib.blur7_level_launch(cuda_lib.ptr(img), H, W, cuda_lib.ptr(out),
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
        cuda_lib.ptr(img), H, W, int(with_moments), ptr(score), ptr(keep),
        ptr(m01), ptr(m10), ptr(blur), cuda_lib.stream_handle(img.device))
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
