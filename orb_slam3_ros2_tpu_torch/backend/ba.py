"""Bundle adjustment with Schur-complement reduction.

Port of `orb_slam3_ros2_tpu/backend/ba.py`: robust (Huber) Levenberg-
Marquardt over a fixed-capacity dense masked problem, K poses x L landmarks
with an observation mask. Each iteration linearizes once through
`backend/schur.py`, solves the reduced camera system, back-substitutes the
landmarks, and accepts the step only if the robust cost drops. Gauge
freedom is fixed by a large diagonal prior on the `fixed` poses.

The JAX `lax.scan` over iterations is a Python loop; its `lax.cond` on the
iteration index (every `reclassify_every` iterations) is a Python branch on
that static index, and the LM accept is a `torch.where`, so the loop makes
no host sync.

While a profiler runs, each iteration is a `ba.iteration` span holding
`ba.refresh_weights` (on the gated iterations), `ba.reduce`,
`ba.solve_cameras`, `ba.back_substitute` and `ba.cost`, and the final cost
is one more `ba.cost` (`utils/tracing.span`).

On a CUDA device each of those stages is a CUDA graph, captured the second
time its shapes and scalars are seen in the process and replayed after
(`backend/stage_graphs.py`; a capture is a `ba.graph_capture` span): the
LM accept stays eager, so each stage is still called once an iteration,
through `schur.*` as before. `bundle_adjust.graph_captures`,
`.graph_replays` and `.eager_stages` count the stage calls on CUDA.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from orb_slam3_ros2_tpu_torch.backend import residuals as res
from orb_slam3_ros2_tpu_torch.backend import schur
from orb_slam3_ros2_tpu_torch.backend import stage_graphs
from orb_slam3_ros2_tpu_torch.geom import lie
from orb_slam3_ros2_tpu_torch.utils import tracing

HUBER = math.sqrt(res.CHI2_MONO)
FIXED_PRIOR = 1e12  # diagonal prior that pins gauge-fixed poses


class BAProblem(NamedTuple):
    """Dense masked BA problem. K poses, L landmarks."""

    R: torch.Tensor  # (K, 3, 3) T_cw rotations
    t: torch.Tensor  # (K, 3)
    X: torch.Tensor  # (L, 3) world points
    uv: torch.Tensor  # (K, L, 2) undistorted pixel observations
    w: torch.Tensor  # (K, L) information weight; 0 = no observation
    fixed: torch.Tensor  # (K,) bool — poses held constant (gauge anchors)
    point_valid: torch.Tensor  # (L,) bool


class BAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    cost: torch.Tensor  # robust cost after the last accepted step
    inlier_w: torch.Tensor  # (K, L) final effective weights (post chi² gate)


def _update(R, t, X, dxc, V, M6, bl_t, point_valid):
    """The landmark step and the pose update: the proposed (R, t, X)."""
    dxl = schur.landmark_step(V, M6, bl_t, dxc, point_valid)
    R_new, t_new = lie.se3_retract(R, t, dxc)
    return lie.se3_normalize(R_new), t_new, X + dxl


def _step(R, t, X, uv, w_active, fixed, point_valid, fx, fy, cx, cy, lam,
          graphs=None):
    """One damped Gauss-Newton step: (R_new, t_new, X_new, cost0)."""
    with tracing.span("ba.reduce"):
        terms = schur.schur_reduce(R, t, X, uv, w_active, fx, fy, cx, cy,
                                   lam, graphs=graphs)
    with tracing.span("ba.solve_cameras"):
        dxc = schur.solve_cameras(terms.Hcc_p, terms.S_off, terms.rhs_p,
                                  fixed, lam, FIXED_PRIOR, graphs=graphs)
    with tracing.span("ba.back_substitute"):
        R_new, t_new, X_new = stage_graphs.run(
            graphs, "update", _update, R, t, X, dxc, terms.V, terms.M6,
            terms.bl_t, point_valid)
    return R_new, t_new, X_new, terms.cost0


def ba_iteration(p: BAProblem, fx, fy, cx, cy, w_active, lam):
    """One damped GN (LM) step; returns the proposed (R, t, X)."""
    R_new, t_new, X_new, _ = _step(p.R, p.t, p.X, p.uv, w_active, p.fixed,
                                   p.point_valid, fx, fy, cx, cy, lam)
    return R_new, t_new, X_new


def bundle_adjust(
    p: BAProblem,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    n_iters: int = 10,
    chi2_th: float = res.CHI2_MONO,
    reclassify_every: int = 5,
) -> BAResult:
    """Robust LM bundle adjustment over a fixed-size window; the chi² gate
    is refreshed every `reclassify_every` iterations, never before the
    first (optimize on all observations first, then gate). On a CUDA
    device the stages replay their graphs (the module's docstring)."""
    graphs = _GRAPHS.solve(p.R, p.X, fx, fy, cx, cy, chi2_th)
    w_base = p.w
    R, t, X, w_active = p.R, p.t, p.X, w_base
    # a fill on the device: `torch.tensor(1e-4, device=...)` copies from
    # pageable host memory and waits for the stream
    lam = torch.full((), 1e-4, dtype=torch.float32, device=X.device)
    for it in range(n_iters):
        with tracing.span("ba.iteration"):
            if it > 0 and it % reclassify_every == 0:
                with tracing.span("ba.refresh_weights"):
                    w_active = schur.refresh_weights(R, t, X, p.uv, w_base,
                                                     fx, fy, cx, cy, chi2_th,
                                                     graphs=graphs)
            R_new, t_new, X_new, cost0 = _step(R, t, X, p.uv, w_active,
                                               p.fixed, p.point_valid, fx,
                                               fy, cx, cy, lam, graphs)
            with tracing.span("ba.cost"):
                cost1 = schur.robust_cost(R_new, t_new, X_new, p.uv,
                                          w_active, fx, fy, cx, cy,
                                          graphs=graphs)
                better = cost1 < cost0
                R = torch.where(better, R_new, R)
                t = torch.where(better, t_new, t)
                X = torch.where(better, X_new, X)
                lam = torch.where(better, lam * 0.3, lam * 5.0).clamp(1e-9,
                                                                      1e3)
    with tracing.span("ba.cost"):
        cost = schur.robust_cost(R, t, X, p.uv, w_active, fx, fy, cx, cy,
                                 graphs=graphs)
    return BAResult(R=R, t=t, X=X, cost=cost, inlier_w=w_active)


def _count(event: str) -> None:
    """Bump `bundle_adjust.<event>` through the module's name, as the
    kernel wrappers bump `launches` (a wrapper set there counts)."""
    setattr(bundle_adjust, event, getattr(bundle_adjust, event) + 1)


bundle_adjust.graph_captures = 0
bundle_adjust.graph_replays = 0
bundle_adjust.eager_stages = 0
# one per process: a stage's capture pays off over every later solve of
# its shape, whoever calls `bundle_adjust`
_GRAPHS = stage_graphs.StageGraphs(_count)
