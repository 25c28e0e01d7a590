"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc for
Hopper (`sm_90a`) into `build/kernels/` at the root of the checkout the
first time a wrapper needs it, then loaded with ctypes. The library name
carries a hash of the source and the flags, so an edited source is rebuilt.
Nothing is built when a module is imported; on a machine without nvcc only
a call with a CUDA tensor fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
# --fmad=false: no multiply-add contraction, so a kernel rounds each product
# and sum as its plain PyTorch version does (the frontend's blur is then
# bit-identical to the plain blur on every level's interior).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs: dict = {}
build_log: dict = {}  # name -> nvcc's output (ptxas register/smem report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def load(name: str, signatures=None) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if needed and return the loaded library,
    with each C function's (restype, argtypes) in `signatures` declared."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = _build_and_open(name)
    for fn_name, (restype, argtypes) in (signatures or {}).items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.restype = restype
            fn.argtypes = argtypes
    return lib


def _build_and_open(name: str) -> ctypes.CDLL:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        build_log[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require_cuda(*tensors) -> None:
    """Every tensor a kernel reads must be a contiguous CUDA tensor."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
