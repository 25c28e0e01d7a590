"""Essential-graph (pose-graph) optimization over Sim(3) keyframe poses.

Port of `orb_slam3_ros2_tpu/loop/pose_graph.py`: a fixed-capacity edge
list (i, j, S_meas) with weights; each Gauss-Newton/LM iteration evaluates
every edge residual r_e = log_sim3(S_meas⁻¹ ∘ S_i ∘ S_j⁻¹) and its two 7×7
Jacobians by forward-mode differentiation over the 14 tangent coordinates
(`torch.func.jvp` along each basis direction, batched over the edges, as
the JAX version's vmapped `jacfwd`), accumulates the blocks into a dense
(7K, 7K) system and solves it. Gauge anchors and unused slots carry a
1e12 prior; `fix_scale` pins every scale coordinate (6-DoF).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import func as tfunc

from orb_slam3_ros2_tpu_torch.geom import lie


class PoseGraphResult(NamedTuple):
    R: torch.Tensor  # (K, 3, 3)
    t: torch.Tensor  # (K, 3)
    s: torch.Tensor  # (K,)
    cost: torch.Tensor


def _edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """r = log_sim3(S_meas⁻¹ ∘ S_i ∘ S_j⁻¹), batched: (..., 7)."""
    Rji, tji, sji = lie.sim3_compose(Ri, ti, si,
                                     *lie.sim3_inverse(Rj, tj, sj))
    Rmi, tmi, smi = lie.sim3_inverse(Rm, tm, sm)
    Re, te, se = lie.sim3_compose(Rmi, tmi, smi, Rji, tji, sji)
    return lie.sim3_log(Re, te, se)


def _edge_residual_tangent(xi, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """The residual after left-retracting xi[..., :7] onto pose i and
    xi[..., 7:] onto pose j."""
    dRi, dti, dsi = lie.sim3_exp(xi[..., :7])
    dRj, dtj, dsj = lie.sim3_exp(xi[..., 7:])
    Ri2, ti2, si2 = lie.sim3_compose(dRi, dti, dsi, Ri, ti, si)
    Rj2, tj2, sj2 = lie.sim3_compose(dRj, dtj, dsj, Rj, tj, sj)
    return _edge_residual(Ri2, ti2, si2, Rj2, tj2, sj2, Rm, tm, sm)


def edge_terms(R, t, s, edges_i, edges_j, R_meas, t_meas, s_meas):
    """Residual and both pose-block Jacobians of every edge: r (E, 7),
    Ji (E, 7, 7), Jj (E, 7, 7), by forward-mode differentiation."""
    ei, ej = edges_i.long(), edges_j.long()
    args = (R[ei], t[ei], s[ei], R[ej], t[ej], s[ej], R_meas, t_meas,
            s_meas)
    E = ei.shape[0]
    x0 = torch.zeros((E, 14), dtype=R.dtype, device=R.device)

    def f(xi):
        return _edge_residual_tangent(xi, *args)

    basis = torch.eye(14, dtype=R.dtype, device=R.device)[:, None, :].expand(
        14, E, 14)
    cols = tfunc.vmap(lambda v: tfunc.jvp(f, (x0,), (v,))[1])(basis)
    J = cols.permute(1, 2, 0)  # (E, 7, 14)
    return f(x0), J[..., :7], J[..., 7:]


def assemble_system(K, edges_i, edges_j, r, Ji, Jj, w_e):
    """Accumulate the weighted 7×7 edge blocks into dense H (K, 7, K, 7)
    and b (K, 7)."""
    ei, ej = edges_i.long(), edges_j.long()
    dev = r.device
    wJi = Ji * w_e[:, None, None]
    wJj = Jj * w_e[:, None, None]
    H = torch.zeros((K, K, 7, 7), dtype=r.dtype, device=dev)
    for a, c, blk in ((ei, ei, torch.einsum("eai,eaj->eij", wJi, Ji)),
                      (ej, ej, torch.einsum("eai,eaj->eij", wJj, Jj)),
                      (ei, ej, torch.einsum("eai,eaj->eij", wJi, Jj)),
                      (ej, ei, torch.einsum("eai,eaj->eij", wJj, Ji))):
        H.index_put_((a, c), blk, accumulate=True)
    b = torch.zeros((K, 7), dtype=r.dtype, device=dev)
    b.index_add_(0, ei, torch.einsum("eai,ea->ei", wJi, r))
    b.index_add_(0, ej, torch.einsum("eai,ea->ei", wJj, r))
    return H.permute(0, 2, 1, 3), b


def optimize_pose_graph(
    R: torch.Tensor,  # (K, 3, 3) Sim3 poses S_iw (world-to-frame)
    t: torch.Tensor,  # (K, 3)
    s: torch.Tensor,  # (K,)
    edges_i: torch.Tensor,  # (E,)
    edges_j: torch.Tensor,  # (E,)
    R_meas: torch.Tensor,  # (E, 3, 3) measured S_ij = S_i ∘ S_j⁻¹
    t_meas: torch.Tensor,  # (E, 3)
    s_meas: torch.Tensor,  # (E,)
    edge_valid: torch.Tensor,  # (E,) bool
    fixed: torch.Tensor,  # (K,) bool gauge anchors
    edge_weight: Optional[torch.Tensor] = None,
    n_iters: int = 12,
    fix_scale: bool = False,
) -> PoseGraphResult:
    K = R.shape[0]
    dev = R.device
    w_e = (edge_valid.to(torch.float32) if edge_weight is None
           else edge_weight * edge_valid)
    ei, ej = edges_i.long(), edges_j.long()
    prior = torch.repeat_interleave(
        torch.where(fixed, 1e12, 1e-8).to(torch.float32), 7)
    if fix_scale:
        prior[torch.arange(K, device=dev) * 7 + 6] += 1e12

    def edge_cost(Rx, tx, sx):
        rr = _edge_residual(Rx[ei], tx[ei], sx[ei], Rx[ej], tx[ej], sx[ej],
                            R_meas, t_meas, s_meas)
        return torch.sum(w_e * torch.sum(rr * rr, dim=-1))

    lam = torch.tensor(1e-6, dtype=torch.float32, device=dev)
    cost1 = edge_cost(R, t, s)
    for _ in range(n_iters):
        r, Ji, Jj = edge_terms(R, t, s, edges_i, edges_j, R_meas, t_meas,
                               s_meas)
        cost0 = torch.sum(w_e * torch.sum(r * r, dim=-1))
        H, b = assemble_system(K, edges_i, edges_j, r, Ji, Jj, w_e)
        Hf = H.reshape(K * 7, K * 7)
        Hf = Hf + torch.diag(lam * torch.diag(Hf).abs() + prior)
        dx = -torch.linalg.solve(Hf, b.reshape(-1)).reshape(K, 7)
        dR, dt, ds = lie.sim3_exp(dx)
        R_new, t_new, s_new = lie.sim3_compose(dR, dt, ds, R, t, s)
        cost1 = edge_cost(R_new, t_new, s_new)
        better = cost1 < cost0
        R = torch.where(better, R_new, R)
        t = torch.where(better, t_new, t)
        s = torch.where(better, s_new, s)
        lam = torch.where(better, lam * 0.5, lam * 4.0).clamp(1e-9, 1e3)
    return PoseGraphResult(R=R, t=t, s=s, cost=cost1)
