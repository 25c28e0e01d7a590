"""Parity of the port's two-view initializer with the JAX one on the CPU.

The two packages cannot draw the same random samples, so the parity cases
feed the port's `initialize_from_samples` the JAX package's own RANSAC
samples (drawn as `initializer.initialize` draws them) and compare the
winning motion. The parity seeds are ones whose winning F hypothesis has 8
distinct sample indices: a sample drawn with a repeated index leaves its
8x9 system with a two-dimensional null space, from which the two SVD
implementations pick different (equally valid) vectors. The port's own
sampling is checked against ground truth and against the two rejection
cases of `tests/test_initializer.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.frontend import initializer as jinit
from orb_slam3_ros2_tpu_torch.frontend import initializer as tinit
from orb_slam3_ros2_tpu_torch.geom import lie

FX = FY = 400.0
CX, CY = 320.0, 240.0
R_TOL = T_TOL = 1e-4  # winning motion, port vs JAX on the same samples


def _proj(Xc):
    return np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX,
                     FY * Xc[:, 1] / Xc[:, 2] + CY], axis=-1)


def _rot(phi):
    return lie.so3_exp(torch.tensor(phi, dtype=torch.float32)).numpy()


def _two_view(planar, seed, n=300, noise=0.4, outlier_frac=0.0,
              phi=(0.03, -0.08, 0.02), t=(0.6, 0.05, 0.1), zr=(4, 9)):
    """The scene of tests/test_initializer.py:_two_view."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-3, 3, n), rng.uniform(-2, 2, n)
    z = np.full(n, 6.0) if planar else rng.uniform(*zr, n)
    X = np.stack([x, y, z], axis=-1)
    R = _rot(phi)
    t = np.asarray(t, np.float64)
    uv1 = _proj(X) + rng.normal(0, noise, (n, 2))
    uv2 = _proj(X @ R.T + t) + rng.normal(0, noise, (n, 2))
    if outlier_frac:
        out = rng.random(n) < outlier_frac
        uv2[out] += rng.uniform(-80, 80, (out.sum(), 2))
    return (uv1.astype(np.float32), uv2.astype(np.float32), np.ones(n, bool),
            R, t)


def _jax_samples(seed, mask):
    kh, kf = jax.random.split(jax.random.PRNGKey(seed))
    m = jnp.asarray(mask)
    return (np.array(jinit._sample_indices(kh, m, jinit.N_HYPO, 4)),
            np.array(jinit._sample_indices(kf, m, jinit.N_HYPO, 8)))


@pytest.mark.parametrize("planar,seed,outliers", [
    (False, 1, 0.0), (True, 2, 0.0), (False, 6, 0.2), (True, 10, 0.2),
    (False, 9, 0.3)])
def test_initializer_matches_jax_on_jax_samples(planar, seed, outliers):
    uv1, uv2, mask, R_gt, t_gt = _two_view(planar, seed,
                                           outlier_frac=outliers)
    ref = jinit.initialize(jax.random.PRNGKey(seed), jnp.asarray(uv1),
                           jnp.asarray(uv2), jnp.asarray(mask), FX, FY, CX,
                           CY)
    idx_h, idx_f = _jax_samples(seed, mask)
    got = tinit.initialize_from_samples(
        torch.from_numpy(uv1), torch.from_numpy(uv2), torch.from_numpy(mask),
        torch.from_numpy(idx_h), torch.from_numpy(idx_f), FX, FY, CX, CY)
    assert bool(got.ok) == bool(ref.ok) is True
    assert bool(got.used_h) == bool(ref.used_h) == planar
    np.testing.assert_array_equal(got.good.numpy(), np.asarray(ref.good))
    assert int(got.n_good) == int(ref.n_good)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=R_TOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=T_TOL)
    g = got.good.numpy()
    # triangulated points within 1e-3 relative of JAX's (unit baseline)
    np.testing.assert_allclose(got.X.numpy()[g], np.asarray(ref.X)[g],
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("planar,seed,outliers", [
    (False, 1, 0.0), (True, 2, 0.0), (False, 3, 0.2)])
def test_initializer_own_samples_recover_motion(planar, seed, outliers):
    """The port's own sampling, the bounds of tests/test_initializer.py
    `_check`: |R - R_gt|_F < 0.03, |cos(t, t_gt)| > 0.995, > 100 good."""
    uv1, uv2, mask, R_gt, t_gt = _two_view(planar, seed,
                                           outlier_frac=outliers)
    gen = torch.Generator().manual_seed(seed)
    out = tinit.initialize(gen, torch.from_numpy(uv1), torch.from_numpy(uv2),
                           torch.from_numpy(mask), FX, FY, CX, CY)
    assert bool(out.ok)
    assert bool(out.used_h) == planar
    assert np.linalg.norm(out.R.numpy() - R_gt) < 0.03
    assert abs(out.t.numpy() @ (t_gt / np.linalg.norm(t_gt))) > 0.995
    assert int(out.good.sum()) > 100


def test_init_rejects_low_parallax_baseline():
    """Port-side copy of tests/test_initializer.py: a real but tiny baseline
    (~0.4 deg parallax at z=7) must be refused. The gate depends on the
    samples in both packages (the JAX initializer accepts this scene for 7
    of the first 60 keys; its test uses key 0), so the port is held to the
    JAX decision on the JAX samples of keys 0-3, all refusals, and to a
    refusal with its own generator at seed 0, as the JAX test is at key 0."""
    uv1, uv2, mask, _, _ = _two_view(False, 7, phi=(0.0, 0.01, 0.0),
                                     t=(0.05, 0.005, 0.01), zr=(5, 9))
    args = (torch.from_numpy(uv1), torch.from_numpy(uv2),
            torch.from_numpy(mask))
    for key in range(4):
        idx_h, idx_f = _jax_samples(key, mask)
        out = tinit.initialize_from_samples(
            *args, torch.from_numpy(idx_h), torch.from_numpy(idx_f), FX, FY,
            CX, CY)
        assert not bool(out.ok)
    out = tinit.initialize(torch.Generator().manual_seed(0), *args, FX, FY,
                           CX, CY)
    assert not bool(out.ok)


def test_init_rejects_pure_rotation():
    """Port-side copy of tests/test_initializer.py: no parallax, no init
    (neither package accepted this scene for any of 60 seeds)."""
    uv1, uv2, mask, _, _ = _two_view(False, 4, phi=(0.0, 0.05, 0.0),
                                     t=(0.0, 0.0, 0.0))
    for seed in range(4):
        out = tinit.initialize(torch.Generator().manual_seed(seed),
                               torch.from_numpy(uv1), torch.from_numpy(uv2),
                               torch.from_numpy(mask), FX, FY, CX, CY)
        assert not bool(out.ok)
