"""`backend/jacobian.jacobian`, the one forward-mode pass that the VI
initialization and the VI BA take their Jacobians with, against torch's
reverse-mode `torch.autograd.functional.jacobian` (f64, so the two agree
to rounding: 1e-12)."""

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.backend import jacobian as jac_mod
from orb_slam3_ros2_tpu_torch.geom import lie

TOL = 1e-12


def _rotate(x):
    """(B, 6) -> (B, 3): exp(x[:3]) applied to x[3:] plus a square."""
    return (lie.so3_exp(x[:, :3]) @ x[:, 3:, None])[..., 0] + x[:, :3] ** 2


def test_vector_input_gives_the_full_jacobian():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=6))
    y, J = jac_mod.jacobian(_rotate, x)
    ref = torch.autograd.functional.jacobian(lambda v: _rotate(v[None])[0],
                                             x)
    assert J.shape == (3, 6)
    assert torch.allclose(y, _rotate(x[None])[0], atol=TOL, rtol=0)
    assert torch.allclose(J, ref, atol=TOL, rtol=0)


def test_row_input_gives_each_rows_own_jacobian():
    """Rows that `f` treats independently (the VI BA's intervals): every
    row's block, and at the identity (so3 at θ = 0) finite."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 6)))
    x[2, :3] = 0.0

    def f(copies):
        return _rotate(copies.reshape(-1, 6)).reshape(copies.shape[0], 4, 3)

    y, J = jac_mod.jacobian(f, x)
    assert J.shape == (4, 3, 6)
    assert torch.isfinite(J).all()
    for r in range(4):
        ref = torch.autograd.functional.jacobian(
            lambda v: _rotate(v[None])[0], x[r])
        assert torch.allclose(J[r], ref, atol=TOL, rtol=0), r
        assert torch.allclose(y[r], _rotate(x[r:r + 1])[0], atol=TOL,
                              rtol=0)
