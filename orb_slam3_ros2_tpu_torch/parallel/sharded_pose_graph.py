"""Distributed essential-graph (pose-graph) optimization over a shard mesh.

Port of `orb_slam3_ros2_tpu/parallel/sharded_pose_graph.py`. EDGES are
sharded over the 1-D mesh axis: each shard evaluates the Sim3 residuals
and Jacobians of its edges (`loop/pose_graph.edge_terms`) and adds the
weighted 7x7 blocks into a local dense (K,7,K,7) system
(`pose_graph.assemble_system`); one psum reduces it, and the (7K, 7K)
solve and the pose update run replicated. Per-iteration communication is
the H/b reduction, independent of the edge count. The JAX `gn_step` body
is `_shard_run`, a generator over one shard's edges whose yields are its
psums (`parallel/mesh.run_shards`).
"""

from __future__ import annotations

import torch

from orb_slam3_ros2_tpu_torch.geom import lie
from orb_slam3_ros2_tpu_torch.loop import pose_graph as pg
from orb_slam3_ros2_tpu_torch.parallel import mesh as mesh_mod


def _shard_run(R, t, s, edges_i, edges_j, R_meas, t_meas, s_meas, w_e,
               fixed, K: int, n_iters: int, fix_scale: bool):
    """n_iters LM steps on one edge shard; poses replicated. Returns
    (R, t, s, cost of the last trial step)."""
    dev = R.device
    ei, ej = edges_i.long(), edges_j.long()
    prior = torch.repeat_interleave(
        torch.where(fixed, 1e12, 1e-8).to(torch.float32), 7)
    if fix_scale:
        prior[torch.arange(K, device=dev) * 7 + 6] += 1e12

    def edge_cost(Rx, tx, sx):
        rr = pg._edge_residual(Rx[ei], tx[ei], sx[ei], Rx[ej], tx[ej],
                               sx[ej], R_meas, t_meas, s_meas)
        return torch.sum(w_e * torch.sum(rr * rr, dim=-1))

    lam = torch.tensor(1e-6, dtype=torch.float32, device=dev)
    cost1 = None
    for _ in range(n_iters):
        r, Ji, Jj = pg.edge_terms(R, t, s, edges_i, edges_j, R_meas, t_meas,
                                  s_meas)
        H, b = pg.assemble_system(K, edges_i, edges_j, r, Ji, Jj, w_e)
        # <- the only cross-shard traffic
        cost0, H, b = yield (torch.sum(w_e * torch.sum(r * r, dim=-1)), H, b)
        Hf = H.reshape(K * 7, K * 7)
        Hf = Hf + torch.diag(lam * torch.diag(Hf).abs() + prior)
        dx = -torch.linalg.solve(Hf, b.reshape(-1)).reshape(K, 7)
        dR, dt, ds = lie.sim3_exp(dx)
        R_new, t_new, s_new = lie.sim3_compose(dR, dt, ds, R, t, s)
        cost1, = yield (edge_cost(R_new, t_new, s_new),)
        better = cost1 < cost0
        R = torch.where(better, R_new, R)
        t = torch.where(better, t_new, t)
        s = torch.where(better, s_new, s)
        lam = torch.where(better, lam * 0.5, lam * 4.0).clamp(1e-9, 1e3)
    return R, t, s, cost1


def make_sharded_pose_graph(mesh: mesh_mod.Mesh, K: int, n_iters: int = 12,
                            fix_scale: bool = False):
    """The distributed pose-graph optimizer for a fixed K. The returned
    function mirrors `loop.pose_graph.optimize_pose_graph`; the edge count
    E must divide by the mesh size (pad with edge_valid=False entries)."""
    n_shards = mesh.shape[mesh_mod.LM_AXIS]

    def optimize(R, t, s, edges_i, edges_j, R_meas, t_meas, s_meas,
                 edge_valid, fixed, edge_weight=None) -> pg.PoseGraphResult:
        E = edges_i.shape[0]
        if E % n_shards:
            raise ValueError(
                f"edge count {E} not divisible by mesh size {n_shards}; "
                "pad with edge_valid=False entries")
        w_e = (edge_valid.to(torch.float32) if edge_weight is None
               else edge_weight * edge_valid)
        Es = E // n_shards
        gens = []
        for sh, d in zip(mesh.local_shards(), mesh.devices.reshape(-1)):
            d = torch.device(d)
            sl = slice(sh * Es, (sh + 1) * Es)
            gens.append(_shard_run(
                R.to(d), t.to(d), s.to(d), edges_i[sl].to(d),
                edges_j[sl].to(d), R_meas[sl].to(d), t_meas[sl].to(d),
                s_meas[sl].to(d), w_e[sl].to(d), fixed.to(d), K, n_iters,
                fix_scale))
        R2, t2, s2, cost = mesh_mod.run_shards(mesh, gens)[0]
        return pg.PoseGraphResult(R=R2, t=t2, s=s2, cost=cost)

    return optimize
