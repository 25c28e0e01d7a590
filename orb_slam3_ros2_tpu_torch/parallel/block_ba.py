"""Map-block-parallel distributed BA over a 2-D ("kf", "lm") shard mesh.

Port of `orb_slam3_ros2_tpu/parallel/block_ba.py`. Independent map blocks
(Atlas maps, covisibility-disjoint windows, per-session submaps; see
`parallel/partition.py`) are split over the "kf" axis, each block running
the landmark-sharded solver (`sharded_ba._shard_step`) over its row's "lm"
shards: B blocks on an (nk, nl) mesh, each nl-way landmark-sharded. Blocks
never communicate; a psum reduces only over the block's lm shards. The
JAX version vmaps a row's blocks; here they run one after another.
"""

from __future__ import annotations

import torch

from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod
from orb_slam3_ros2_tpu_torch.parallel import mesh as mesh_mod
from orb_slam3_ros2_tpu_torch.parallel import sharded_ba


def _block_run(R, t, X, uv, w, fixed, point_valid, fx, fy, cx, cy,
               n_iters: int):
    """One block's lm shard: n_iters steps, no chi2 refresh (JAX
    `one_block`). Returns (R, t, X, cost of the last step)."""
    lam = torch.tensor(1e-4, dtype=torch.float32, device=X.device)
    cost = None
    for _ in range(n_iters):
        R, t, X, lam, cost = yield from sharded_ba._shard_step(
            R, t, X, uv, w, fixed, point_valid, lam, fx, fy, cx, cy)
    return R, t, X, cost


def make_block_sharded_ba(mesh: mesh_mod.Mesh, fx, fy, cx, cy,
                          n_iters: int = 10):
    """The block x landmark sharded BA.

    Expects a batched BAProblem whose leaves carry a leading block axis B:
    R (B,K,3,3), t (B,K,3), X (B,L,3), uv (B,K,L,2), w (B,K,L), fixed
    (B,K), point_valid (B,L). B must divide by mesh axis "kf", L by axis
    "lm"."""
    kf, lm = mesh_mod.KF_AXIS, mesh_mod.LM_AXIS

    def ba(problem: ba_mod.BAProblem) -> ba_mod.BAResult:
        B, L = problem.X.shape[0], problem.X.shape[1]
        nk, nl = mesh.shape[kf], mesh.shape[lm]
        if B % nk:
            raise ValueError(f"block count {B} not divisible by kf axis {nk}")
        if L % nl:
            raise ValueError(f"landmarks {L} not divisible by lm axis {nl}")
        per_row = B // nk
        outs = []
        for b in range(B):
            row = mesh.devices[b // per_row]
            p = ba_mod.BAProblem(*(f[b] for f in problem))
            shards = sharded_ba.shard_problem(p, mesh, shards=range(nl),
                                              devices=row)
            res = mesh_mod.run_shards(mesh, (
                _block_run(*fields, fx, fy, cx, cy, n_iters)
                for fields in zip(*shards)), devices=row)
            home = problem.X.device
            outs.append((res[0][0].to(home), res[0][1].to(home),
                         torch.cat([r[2].to(home) for r in res]),
                         res[0][3].to(home)))
        R, t, X, cost = (torch.stack(f) for f in zip(*outs))
        return ba_mod.BAResult(R=R, t=t, X=X, cost=cost, inlier_w=problem.w)

    return ba


def shard_block_problem(problem: ba_mod.BAProblem, mesh: mesh_mod.Mesh
                        ) -> ba_mod.BAProblem:
    """The batched problem with the (kf, lm) layout checked. The blocks'
    slices are cut per block when the solve runs, so the problem is
    returned as it is."""
    B, L = problem.X.shape[0], problem.X.shape[1]
    nk, nl = mesh.shape[mesh_mod.KF_AXIS], mesh.shape[mesh_mod.LM_AXIS]
    if B % nk or L % nl:
        raise ValueError(f"blocks {B} / landmarks {L} do not divide the "
                         f"({nk}, {nl}) mesh")
    return problem
