"""Parity of the port's matcher and windowed match with the JAX package on
the CPU (the bounds of tests/test_fused_kernels.py:43-76: idx and valid
exact), and of the match CUDA kernel with its plain version on a GPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_ros2_tpu.ops import fused_match as jfm
from orb_slam3_ros2_tpu.ops import matcher as jm
from orb_slam3_ros2_tpu_torch.ops import fused_match as tfm
from orb_slam3_ros2_tpu_torch.ops import matcher as tm
from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as tdesc


def _match_case(seed=0, N=300, M=700, spread=5.0):
    """tests/test_fused_kernels.py's case: random ±1 descriptors, planted
    near-duplicates within `spread` px and an exact-duplicate landmark
    pair."""
    rng = np.random.default_rng(seed)
    sa = np.where(rng.integers(0, 2, (N, 256)), 1.0, -1.0).astype(np.float32)
    sb = np.where(rng.integers(0, 2, (M, 256)), 1.0, -1.0).astype(np.float32)
    uva = rng.uniform(0, 640, (N, 2)).astype(np.float32)
    uvb = rng.uniform(0, 640, (M, 2)).astype(np.float32)
    ma = rng.random(N) > 0.1
    mb = rng.random(M) > 0.1
    for i in range(0, min(40, N, M // 2)):
        j = 2 * i
        sb[j] = sa[i]
        flips = rng.choice(256, size=rng.integers(0, 8), replace=False)
        sb[j, flips] *= -1.0
        uvb[j] = uva[i] + rng.uniform(-spread, spread, 2)
        ma[i] = mb[j] = True
    sb[M - 1] = sb[M - 2] = sa[7]
    uvb[M - 1] = uvb[M - 2] = uva[7]
    mb[M - 2] = mb[M - 1] = True
    return sa, ma, uva, sb, mb, uvb


def _bits(signs):
    return tdesc.pack_bits(torch.from_numpy(signs) > 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def test_hamming_matrix_exact():
    sa, _, _, sb, _, _ = _match_case(N=64, M=80)
    got = tm.hamming_matrix(torch.from_numpy(sa), torch.from_numpy(sb))
    ref = np.asarray(jm.hamming_matrix(jnp.asarray(sa), jnp.asarray(sb)))
    np.testing.assert_array_equal(got.numpy(), ref)
    ua = tdesc.unpack_bits(_bits(sa)).numpy()
    ub = tdesc.unpack_bits(_bits(sb)).numpy()
    np.testing.assert_array_equal(
        got.numpy(), (ua[:, None, :] != ub[None, :, :]).sum(-1))


@pytest.mark.parametrize("ratio,mutual", [(0.9, True), (0.9, False),
                                          (None, True), (None, False)])
def test_match_window_matches_jax(ratio, mutual):
    """Port match_window (plain on CPU) vs the Pallas kernel in interpret
    mode and vs the JAX dense matcher."""
    sa, ma, uva, sb, mb, uvb = _match_case()
    radius = 8.0
    got = tfm.match_window(_bits(sa), torch.from_numpy(ma),
                           torch.from_numpy(uva), _bits(sb),
                           torch.from_numpy(mb), torch.from_numpy(uvb),
                           radius=radius, max_dist=50.0, ratio=ratio,
                           mutual=mutual)
    jargs = [jnp.asarray(a) for a in (sa, ma, uva, sb, mb, uvb)]
    ref_k = jfm.match_window(*jargs, radius=radius, max_dist=50.0,
                             ratio=ratio, mutual=mutual, interpret=True)
    ref_d = jm.match(jargs[0], jargs[1], jargs[3], jargs[4], max_dist=50.0,
                     ratio=ratio, gate=jm.window_gate(jargs[2], jargs[5],
                                                      radius), mutual=mutual)
    assert int(ref_d.valid.sum()) > 20
    for ref in (ref_k, ref_d):
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
        v = np.asarray(ref.valid)
        np.testing.assert_array_equal(got.dist.numpy()[v],
                                      np.asarray(ref.dist)[v])


# SearchAndFuse's call: every landmark slot of the map, a 4-px window,
# max_dist 45, no ratio test, not mutual (frontend/tracking.py)
FUSE = dict(radius=4.0, max_dist=45.0, ratio=None, mutual=False)


def test_match_window_at_fuse_settings_matches_jax():
    """Port match_window (plain on CPU) vs the JAX dense matcher, 8192
    landmark slots: idx, valid and dist exact."""
    sa, ma, uva, sb, mb, uvb = _match_case(seed=4, N=200, M=8192, spread=3.0)
    got = tfm.match_window(_bits(sa), torch.from_numpy(ma),
                           torch.from_numpy(uva), _bits(sb),
                           torch.from_numpy(mb), torch.from_numpy(uvb), **FUSE)
    j = [jnp.asarray(a) for a in (sa, ma, uva, sb, mb, uvb)]
    ref = jm.match(j[0], j[1], j[3], j[4], max_dist=FUSE["max_dist"],
                   ratio=None, gate=jm.window_gate(j[2], j[5], FUSE["radius"]),
                   mutual=False)
    assert int(ref.valid.sum()) > 20
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.dist.numpy()[v], np.asarray(ref.dist)[v])


def test_match_window_nonmultiple_shapes():
    sa, ma, uva, sb, mb, uvb = _match_case(seed=3, N=77, M=131)
    got = tfm.match_window(_bits(sa), torch.from_numpy(ma),
                           torch.from_numpy(uva), _bits(sb),
                           torch.from_numpy(mb), torch.from_numpy(uvb),
                           radius=10.0, max_dist=60.0)
    ref = jfm.match_window(*[jnp.asarray(a) for a in (sa, ma, uva, sb, mb,
                                                      uvb)],
                           radius=10.0, max_dist=60.0, interpret=True)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))


def test_fully_masked_rows_and_columns_resolve_to_zero():
    """A row or column with nothing allowed takes index 0 in both packages,
    and never matches."""
    sa, ma, uva, sb, mb, uvb = _match_case(seed=5, N=40, M=60)
    ma[:5] = False
    mb[:] = False
    mb[10] = True
    d = tm.hamming_matrix(torch.from_numpy(sa), torch.from_numpy(sb))
    allowed = torch.from_numpy(ma)[:, None] & torch.from_numpy(mb)[None, :]
    d = torch.where(allowed, d, tm.INF)
    np.testing.assert_array_equal(tm.first_argmin(d, 1)[:5].numpy(), 0)
    np.testing.assert_array_equal(tm.first_argmin(d, 0)[11:].numpy(), 0)
    got = tm.match(torch.from_numpy(sa), torch.from_numpy(ma),
                   torch.from_numpy(sb), torch.from_numpy(mb), mutual=True)
    ref = jm.match(jnp.asarray(sa), jnp.asarray(ma), jnp.asarray(sb),
                   jnp.asarray(mb), mutual=True)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    assert not got.valid[:5].any()


def test_match_rotation_check_matches_jax():
    rng = np.random.default_rng(9)
    sa, ma, _, sb, mb, _ = _match_case(seed=9, N=120, M=150)
    aa = rng.uniform(-np.pi, np.pi, 120).astype(np.float32)
    ab = rng.uniform(-np.pi, np.pi, 150).astype(np.float32)
    ab[0:80:2] = aa[:40] - 0.3  # planted pairs share one rotation
    kw = dict(max_dist=60.0, ratio=None, mutual=False, rotation_check=True)
    got = tm.match(torch.from_numpy(sa), torch.from_numpy(ma),
                   torch.from_numpy(sb), torch.from_numpy(mb),
                   angles_a=torch.from_numpy(aa),
                   angles_b=torch.from_numpy(ab), **kw)
    ref = jm.match(jnp.asarray(sa), jnp.asarray(ma), jnp.asarray(sb),
                   jnp.asarray(mb), angles_a=jnp.asarray(aa),
                   angles_b=jnp.asarray(ab), **kw)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))


@pytest.mark.cuda
@pytest.mark.parametrize("M,kw", [
    (4096, dict(radius=15.0, ratio=0.9, mutual=True)),  # tracking
    (4096, dict(radius=15.0, ratio=None, mutual=False)),
    (8192, FUSE)])  # SearchAndFuse: every landmark slot of the map
def test_match_kernel_matches_plain_on_gpu(cuda_device, M, kw):
    sa, ma, uva, sb, mb, uvb = _match_case(seed=1, N=1000, M=M, spread=3.0)
    args = [_bits(sa), torch.from_numpy(ma), torch.from_numpy(uva),
            _bits(sb), torch.from_numpy(mb), torch.from_numpy(uvb)]
    args = [a.to(cuda_device) for a in args]
    n = tfm.match_window.launches
    got = tfm.match_window(*args, **kw)
    ref = tfm.match_window_ref(*args, **kw)
    assert tfm.match_window.launches == n + 1
    assert int(ref.valid.sum()) > 20
    np.testing.assert_array_equal(got.idx.cpu().numpy(), ref.idx.cpu().numpy())
    np.testing.assert_array_equal(got.valid.cpu().numpy(),
                                  ref.valid.cpu().numpy())
    v = ref.valid
    np.testing.assert_array_equal(got.dist[v].cpu().numpy(),
                                  ref.dist[v].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("M,kw", [
    (4096, dict(radius=15.0, ratio=0.9, mutual=True)),  # tracking
    (8192, FUSE)])  # SearchAndFuse
def test_match_kernel_matches_plain_on_gpu_at_2000_features(cuda_device, M,
                                                            kw):
    """KITTI's 2000 features per frame (`config/Stereo/KITTI00-02.yaml`)
    against the visible cap and against every landmark slot."""
    sa, ma, uva, sb, mb, uvb = _match_case(seed=3, N=2000, M=M, spread=3.0)
    args = [_bits(sa), torch.from_numpy(ma), torch.from_numpy(uva),
            _bits(sb), torch.from_numpy(mb), torch.from_numpy(uvb)]
    args = [a.to(cuda_device) for a in args]
    got = tfm.match_window(*args, **kw)
    ref = tfm.match_window_ref(*args, **kw)
    assert int(ref.valid.sum()) > 20
    np.testing.assert_array_equal(got.idx.cpu().numpy(), ref.idx.cpu().numpy())
    np.testing.assert_array_equal(got.valid.cpu().numpy(),
                                  ref.valid.cpu().numpy())
    v = ref.valid
    np.testing.assert_array_equal(got.dist[v].cpu().numpy(),
                                  ref.dist[v].cpu().numpy())


def test_match_wrapper_raises_off_cpu_without_a_kernel():
    """A non-CPU, non-CUDA tensor is refused, never matched by the plain
    version."""
    meta = dict(device="meta")
    args = (torch.zeros((4, 8), dtype=torch.int32, **meta),
            torch.ones(4, dtype=torch.bool, **meta), torch.zeros((4, 2), **meta),
            torch.zeros((6, 8), dtype=torch.int32, **meta),
            torch.ones(6, dtype=torch.bool, **meta), torch.zeros((6, 2), **meta))
    n = tfm.match_window.launches
    with pytest.raises(ValueError, match="CUDA"):
        tfm.match_window(*args, radius=15.0)
    assert tfm.match_window.launches == n
