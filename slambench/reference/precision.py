"""The precisions a reference is computed in: the reference itself in
float64, and the controls a step below the program's float32 with TF32 off
(TF32 for matrix products, bfloat16 for elementwise arithmetic)."""

from __future__ import annotations

import contextlib

import torch

DTYPES = {"f64": torch.float64, "f32": torch.float32,
          "tf32": torch.float32, "bf16": torch.bfloat16}


@contextlib.contextmanager
def precision(mode: str):
    """Set TF32 for the enclosed matrix products as `mode` asks (on only
    for "tf32"), and restore the process's settings after."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield DTYPES[mode]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
