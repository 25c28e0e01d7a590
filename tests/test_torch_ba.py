"""Parity of the port's bundle adjustment (`backend/schur.py`,
`backend/ba.py`, `frontend/tracking.local_ba`) with the JAX package on the
CPU, on the same problems."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_ros2_tpu.backend import ba as jba
from orb_slam3_ros2_tpu.backend import schur as jschur
from orb_slam3_ros2_tpu.frontend import tracking as jtrk
from orb_slam3_ros2_tpu_torch.atlas import map_state as tms
from orb_slam3_ros2_tpu_torch.backend import ba as tba
from orb_slam3_ros2_tpu_torch.backend import schur as tschur
from orb_slam3_ros2_tpu_torch.frontend import tracking as ttrk
from tests.test_torch_map_state import (CX, CY, FX, FY, _so3,
                                        assert_maps_equal, jax_map,
                                        synthetic_map)

POSE_ATOL, POINT_ATOL = 1e-4, 1e-3  # BA result, port vs JAX


def _problem(seed=0, K=4, L=60, noise=0.5, single_obs=(7,)):
    """A BA problem with perturbed poses/points; the landmarks in
    `single_obs` are seen by one keyframe only (rank-2 Hessian block).
    Keyframes 0 and 1 are fixed, which pins the gauge including scale, as
    a local-BA window's fixed ring does."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L),
                  rng.uniform(5, 9, L)], -1)
    Rs, ts = [], []
    for k in range(K):
        R = _so3(np.array([0.01, -0.02, 0.01]) * k)
        Rs.append(R)
        ts.append(-R @ np.array([0.3 * k, 0.05 * k, 0.02 * k]))
    Rs, ts = np.stack(Rs), np.stack(ts)
    xc = np.einsum("kab,lb->kla", Rs, X) + ts[:, None]
    uv = np.stack([FX * xc[..., 0] / xc[..., 2] + CX,
                   FY * xc[..., 1] / xc[..., 2] + CY], -1)
    uv = uv + rng.normal(0, noise, uv.shape)
    w = (rng.random((K, L)) < 0.85).astype(np.float32)
    for l in single_obs:
        w[:, l] = 0.0
        w[2, l] = 1.0
    w[:, 0] = 1.0
    uv[3, 3] += 40.0  # an outlier observation for the chi2 gate
    R0 = np.stack([_so3(rng.normal(0, 3e-3, 3)) @ R for R in Rs])
    t0 = ts + rng.normal(0, 0.02, ts.shape)
    X0 = X + rng.normal(0, 0.05, X.shape)
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    valid = np.ones(L, bool)
    valid[-2] = False
    f32 = np.float32
    return dict(R=R0.astype(f32), t=t0.astype(f32), X=X0.astype(f32),
                uv=uv.astype(f32), w=w, fixed=fixed, point_valid=valid)


def _j(p):
    return jba.BAProblem(**{k: jnp.asarray(v) for k, v in p.items()})


def _t(p):
    return tba.BAProblem(**{k: torch.from_numpy(v) for k, v in p.items()})


def test_single_observation_landmark_hits_the_pivot_floor(monkeypatch):
    """Landmark 7 is seen once. At the LM's smallest damping (1e-9; at
    1e-4 the damping alone keeps the pivot above the floor), lowering the
    floor from 1e-6 to 1e-12 changes its M by orders of magnitude and
    leaves every landmark seen twice or more within 1e-3 relative."""
    p = _problem()
    args = [torch.from_numpy(p[k]) for k in ("R", "t", "X", "uv", "w")]
    lam = torch.tensor(1e-9)
    M = tschur.schur_reduce(*args, FX, FY, CX, CY, lam).M6
    monkeypatch.setattr(tschur, "_CHOL_PIVOT_FLOOR", 1e-12)
    M_low = tschur.schur_reduce(*args, FX, FY, CX, CY, lam).M6
    assert M_low[:, 7].abs().max() > 30 * M[:, 7].abs().max()
    seen = torch.from_numpy(p["w"].sum(0) >= 2)
    np.testing.assert_allclose(M_low[:, seen].numpy(), M[:, seen].numpy(),
                               rtol=1e-3, atol=1e-3 * M.abs().max().item())


@pytest.mark.parametrize("lam", [1e-9, 1e-4, 0.5])
def test_schur_reduce_matches_jax(lam):
    """Every term of the reduced system (rtol 1e-4, relative to each term's
    largest entry), including the landmark seen once, whose normalized
    pivot hits the modified-Cholesky floor; then the camera solve (atol
    1e-5) and the back-substitution (atol 1e-4 on landmarks seen twice or
    more)."""
    p = _problem()
    args = ("R", "t", "X", "uv", "w")
    tj = jschur.schur_reduce(*(jnp.asarray(p[k]) for k in args), FX, FY, CX,
                             CY, jnp.float32(lam))
    tt = tschur.schur_reduce(*(torch.from_numpy(p[k]) for k in args), FX, FY,
                             CX, CY, torch.tensor(lam))
    for name in tschur.SchurTerms._fields:
        a = getattr(tt, name).numpy()
        b = np.asarray(getattr(tj, name))
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=name)
    dxc_j = jschur.solve_cameras(tj.Hcc_p, tj.S_off, tj.rhs_p,
                                 jnp.asarray(p["fixed"]), lam, jba.FIXED_PRIOR)
    dxc_t = tschur.solve_cameras(tt.Hcc_p, tt.S_off, tt.rhs_p,
                                 torch.from_numpy(p["fixed"]), lam,
                                 tba.FIXED_PRIOR)
    np.testing.assert_allclose(dxc_t.numpy(), np.asarray(dxc_j), atol=1e-5)
    dxl_j = jschur.back_substitute(tj, dxc_j, jnp.asarray(p["point_valid"]))
    dxl_t = tschur.back_substitute(tt, dxc_t,
                                   torch.from_numpy(p["point_valid"]))
    # landmarks seen once: their step along the unobserved ray direction is
    # set by the floored pivot, which amplifies f32 rounding; finite only
    seen = p["w"].sum(0) >= 2
    assert np.isfinite(dxl_t.numpy()).all()
    np.testing.assert_allclose(dxl_t.numpy()[seen], np.asarray(dxl_j)[seen],
                               atol=1e-4)


def test_pivot_floor_bounds_a_rank_deficient_block():
    """A rank-1 landmark block plus the caller's 1e-8 damping: the floored
    factor stays finite, equals the JAX one (rtol 1e-5), and is bounded by
    the floor. Each entry of M is at most max(d) * |l21| / floor, with
    d = diag^-1/2 <= 0.02, |l21| <= 2 (the clip) and floor = 1e-6: 4e4."""
    g = torch.tensor([200.0, 50.0, 100.0])
    H = torch.outer(g, g) + 1e-8 * torch.eye(3)
    planes = [H[0, 0:1], H[0, 1:2], H[0, 2:3], H[1, 1:2], H[1, 2:3],
              H[2, 2:3]]
    M = tschur._chol3_invT_planes(*planes)
    Mj = jschur._chol3_invT_planes(*(jnp.asarray(v.numpy()) for v in planes))
    for x, y in zip(M, Mj):
        assert torch.isfinite(x).all()
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5)
    assert max(abs(float(v)) for v in M) <= 4e4


@pytest.mark.parametrize("seed,n_iters", [(0, 10), (3, 6)])
def test_bundle_adjust_matches_jax(seed, n_iters):
    p = _problem(seed=seed)
    rj = jba.bundle_adjust(_j(p), FX, FY, CX, CY, n_iters=n_iters)
    rt = tba.bundle_adjust(_t(p), FX, FY, CX, CY, n_iters=n_iters)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=POSE_ATOL)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=POSE_ATOL)
    np.testing.assert_allclose(rt.X.numpy(), np.asarray(rj.X),
                               atol=POINT_ATOL)
    np.testing.assert_array_equal(rt.inlier_w.numpy(),
                                  np.asarray(rj.inlier_w))
    np.testing.assert_allclose(rt.cost.item(), float(rj.cost), rtol=1e-4)
    assert rt.cost.item() < 0.5 * float(jba.bundle_adjust(
        _j(p), FX, FY, CX, CY, n_iters=1).cost) + 1e3


def test_ba_iteration_matches_jax():
    p = _problem(seed=2)
    got = tba.ba_iteration(_t(p), FX, FY, CX, CY, torch.from_numpy(p["w"]),
                           torch.tensor(1e-3))
    want = jba.ba_iteration(_j(p), FX, FY, CX, CY, jnp.asarray(p["w"]),
                            jnp.float32(1e-3))
    for a, b, tol in zip(got, want, (POSE_ATOL, POSE_ATOL, POINT_ATOL)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol)


@pytest.mark.parametrize("window,fixed", [
    ([3, 2, 1, 0, 3, 3], [False, False, True, True, False, False]),
    ([3, 2, 2, 1, 0, 3], [False, False, False, True, True, True])])
def test_local_ba_matches_jax(window, fixed):
    """local_ba on the same JAX-built map, duplicate window ids included,
    with two fixed keyframes as a window with a fixed ring has: poses
    within 1e-4, points within 1e-3, every other field equal."""
    f, _ = synthetic_map(seed=2)
    rng = np.random.default_rng(9)
    f["lm_X"][:120] += rng.normal(0, 0.03, (120, 3)).astype(np.float32)
    f["kf_t"][1:4] += rng.normal(0, 0.01, (3, 3)).astype(np.float32)
    mj = jax_map(f)
    mt = tms.from_numpy(f)
    ids = np.asarray(window, np.int32)
    fx_ = np.asarray(fixed)
    outj = jtrk.local_ba(mj, jnp.asarray(ids), jnp.asarray(fx_), FX, FY, CX,
                         CY, n_iters=8)
    outt = ttrk.local_ba(mt, torch.from_numpy(ids), torch.from_numpy(fx_),
                         FX, FY, CX, CY, n_iters=8)
    for name, tol in (("kf_R", POSE_ATOL), ("kf_t", POSE_ATOL),
                      ("lm_X", POINT_ATOL)):
        np.testing.assert_allclose(getattr(outt, name).numpy(),
                                   np.asarray(getattr(outj, name)), atol=tol,
                                   err_msg=name)
    assert_maps_equal(outt, outj, skip=("kf_R", "kf_t", "lm_X"))
    moved = np.abs(outt.lm_X.numpy() - f["lm_X"]).max()
    assert moved > 1e-3  # the solve did something
