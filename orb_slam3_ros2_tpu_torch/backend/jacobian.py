"""Forward-mode Jacobians in one pass (the JAX package's `jax.jacfwd`).

`jacobian(f, x)` evaluates `f` once, under `torch.autograd.forward_ad`, on
n stacked copies of x, copy k carrying the tangent e_k along x's last
dimension (n entries): the output tangent of copy k is column k of the
Jacobian. That takes as many launches as two evaluations of `f`, where
functorch's `jacfwd` takes about 1.5x the host time. Under forward-mode AD
torch 2.13 gives a Python scalar's arithmetic with a 0-dim tensor a
float64 tangent, so `f` differentiates nothing unbatched: it takes the
copies as a leading dimension.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD


def jacobian(f, x: torch.Tensor):
    """(f(x), J) for an `f` that maps a stack of copies (C, *x.shape) to
    (C, *S), each copy on its own.

    For a vector x (n,), J (*S, n) is the Jacobian. For x (R, n) whose rows
    `f` treats independently (row r of the output depends on row r of x
    alone), J (R, ..., n) holds each row's own Jacobian, ∂f_r / ∂x_r: every
    row of a copy carries the same direction."""
    n = x.shape[-1]
    seeds = torch.eye(n, dtype=x.dtype, device=x.device).reshape(
        (n,) + (1,) * (x.dim() - 1) + (n,)).expand((n,) + tuple(x.shape))
    with fwAD.dual_level():
        out = f(fwAD.make_dual(x.expand_as(seeds).contiguous(),
                               seeds.contiguous()))
        y, dy = fwAD.unpack_dual(out)
    return y[0], dy.movedim(0, -1)
