"""Unrolled Cholesky solve for tiny SPD systems, plain torch.

Port of `cholesky_solve_small` (`orb_slam3_ros2_tpu/ops/chol_small.py:46`).
The factorization is unrolled over 0-d tensors, with the same 1e-12 floor on
the pivots, so the plain pose LM takes the same arithmetic path as the
kernel's single-thread solve.
"""

from __future__ import annotations

import torch


def cholesky_solve_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD A (n, n) of small size; b (n,) -> x (n,)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-12))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)
