"""Distributed global BA as the engine's operating mode.

Port of `orb_slam3_ros2_tpu/parallel/distributed_map.py`: assembles the
live map's observation table into a BAProblem, solves it with the
landmark-sharded Schur BA (`parallel/sharded_ba.py`) and writes the result
back into the MapState with the duplicate-id and fixed-mask semantics of
`frontend/tracking.local_ba`. `System(mesh=...)._run_global_ba` runs it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod
from orb_slam3_ros2_tpu_torch.parallel import mesh as mesh_mod
from orb_slam3_ros2_tpu_torch.parallel import sharded_ba

# solver cache: (mesh, intrinsics, n_iters) -> sharded BA
_SOLVERS: Dict[Tuple, object] = {}


def _solver(mesh, fx, fy, cx, cy, n_iters):
    key = (mesh, float(fx), float(fy), float(cx), float(cy), int(n_iters))
    if key not in _SOLVERS:
        _SOLVERS[key] = sharded_ba.make_sharded_ba(
            mesh, fx, fy, cx, cy, n_iters=n_iters)
    return _SOLVERS[key]


def _assemble(m: ms.MapState, window_ids: torch.Tensor):
    """Observation table + dedupe, identical to local_ba's preamble:
    (uv (W, L, 2), effective weights (W, L), active (W,))."""
    W = window_ids.shape[0]
    dev = window_ids.device
    same = window_ids[None, :] == window_ids[:, None]
    earlier = torch.ones((W, W), dtype=torch.bool, device=dev).tril(-1)
    first_occurrence = ~(same & earlier).any(dim=1)
    uv_t, w_t, kf_ok = ms.observation_table(m, window_ids)
    active = kf_ok & first_occurrence
    return uv_t, w_t * active[:, None], active


def _write_back(m: ms.MapState, window_ids, active, w_eff, R_new, t_new,
                X_new) -> ms.MapState:
    K = m.kf_R.shape[0]
    write_ids = torch.where(active, window_ids.long(), K)
    kf_R = ms._scatter_drop(m.kf_R, write_ids, R_new)
    kf_t = ms._scatter_drop(m.kf_t, write_ids, t_new)
    moved = w_eff.sum(0) > 0
    lm_X = torch.where(moved[:, None], X_new, m.lm_X)
    return m._replace(kf_R=kf_R, kf_t=kf_t, lm_X=lm_X)


def distributed_map_ba(
    m: ms.MapState,
    window_ids: torch.Tensor,  # (W,) keyframe ids (pad by repeating an id)
    fix_mask: torch.Tensor,  # (W,) bool: poses held fixed
    mesh: mesh_mod.Mesh,
    fx, fy, cx, cy,
    n_iters: int = 8,
) -> ms.MapState:
    """Global/windowed BA over the live map on a shard mesh. Landmarks are
    sharded over the mesh's `lm` axis (the capacity must divide evenly:
    MapConfig.max_lm is a power of two, mesh sizes are 2^k); poses are
    replicated."""
    n_shards = mesh.shape[mesh_mod.LM_AXIS]
    L = m.lm_X.shape[0]
    if L % n_shards:
        raise ValueError(f"landmark capacity {L} not divisible by lm-axis "
                         f"size {n_shards}")
    uv_t, w_eff, active = _assemble(m, window_ids)
    ids = window_ids.long()
    p = ba_mod.BAProblem(
        R=m.kf_R[ids], t=m.kf_t[ids], X=m.lm_X, uv=uv_t, w=w_eff,
        fixed=fix_mask | ~active, point_valid=m.lm_valid)
    out = _solver(mesh, fx, fy, cx, cy, n_iters)(
        sharded_ba.shard_problem(p, mesh))
    dev = m.lm_X.device
    return _write_back(m, window_ids, active, w_eff, out.R.to(dev),
                       out.t.to(dev), out.X.to(dev))
