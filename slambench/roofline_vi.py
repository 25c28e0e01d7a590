"""The algorithmic work of one LM iteration of the inertial global BA,
counted from the generated map and its intervals, never from the
program's layout, at the peaks of `roofline.py`.

- The visual part as `roofline.ba_iter_cost` counts it (per observation,
  landmark and pair of observations of a landmark), without its reduced
  camera solve: the solve here is the whole state's.
- Per interval: the whitened 9-dimensional residual at the linearization
  point and at the candidate (two body states, the first-order bias
  correction with its rotation exponential, r_ΔR's two products and
  logarithm, r_Δv, r_Δp and the triangular whitening: ~600 operations
  each), its analytic 9 x 26 Jacobian (~10 operations an entry), the
  symmetric JᵀJ over the 26 tangent columns (351 entries of 9 products
  and sums) and Jᵀr (26 x 9 x 2).
- The dense (9K + 8)² solve: the LU's (2/3) D³ and the two triangular
  solves' 2 D².

Bytes: the visual part's, each interval's deltas, bias Jacobians,
covariance and whitener (~1 KB, f32) read once, and the dense system D²
f32 written and read once.
"""

from __future__ import annotations

from slambench import roofline

N_TAN = 26
OPS_RESIDUAL = 600
OPS_INTERVAL = (2 * OPS_RESIDUAL + 10 * 9 * N_TAN
                + 18 * N_TAN * (N_TAN + 1) // 2 + 2 * 9 * N_TAN)
BYTES_INTERVAL = 1024


def vi_iter_cost(problem, n_intervals: int) -> dict:
    """One iteration's work: `problem` the map's observations
    (`reference.ba.Problem`), `n_intervals` the inertial intervals."""
    vis = roofline.ba_iter_cost(problem)
    K, E = vis["keyframes"], int(n_intervals)
    D = 9 * K + 8
    n_ops = (vis["ops"] - (6 * K) ** 3 / 3 + OPS_INTERVAL * E
             + 2 * D ** 3 / 3 + 2 * D ** 2)
    n_bytes = (vis["bytes"] - 2 * 4 * (6 * K) ** 2 + BYTES_INTERVAL * E
               + 2 * 4 * D ** 2)
    return dict(bytes=n_bytes, ops=n_ops,
                bound_ms=roofline.bound_ms(n_bytes, n_ops), intervals=E,
                state_dim=D, keyframes=K, observations=vis["observations"],
                pairs=vis["pairs"])
