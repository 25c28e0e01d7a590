"""orb_slam3_ros2_tpu_torch — the PyTorch/CUDA port of `orb_slam3_ros2_tpu`.

The JAX package beside this one is the reference. Each module here mirrors
one module there (same subpackage layout, same function names), written as
plain PyTorch functions on tensors with an explicit device. Every Pallas
kernel on the ported path has a CUDA C++ kernel written for Hopper
(`csrc/`), built with nvcc at first use and bound with ctypes; beside each
kernel sits its plain PyTorch version, which CPU tensors take.

This package imports `torch` and never `jax`.
"""

__version__ = "0.1.0"

import torch as _torch

# f32 everywhere, as the reference pins `jax_default_matmul_precision` to
# "highest" (`orb_slam3_ros2_tpu/__init__.py:22-28`: bf16 matmuls made the
# synthetic mono ATE 4.7x worse). cuDNN's TF32 default would also put a
# convolution-based blur outside the blur oracle's atol=1e-3.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
