"""Parity of the port's matcher and windowed match with the JAX package on
the CPU (the bounds of tests/test_fused_kernels.py:43-76: idx and valid
exact), and of the match CUDA kernel with its plain version on a GPU."""

import re
from pathlib import Path

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


# relocalization's tries (runtime/system.py `_reloc_try`): from the last
# pose at 80 px and from a BoW keyframe at 60 px, max_dist 45, ratio 0.9,
# mutual
RELOC = {r: dict(radius=r, max_dist=45.0, ratio=0.9, mutual=True)
         for r in (80.0, 60.0)}


@pytest.mark.parametrize("radius", [80.0, 60.0])
def test_match_window_at_reloc_settings_matches_jax(radius):
    """Port match_window (plain on CPU) vs the JAX dense matcher at
    relocalization's windows, 1000 x 4096: idx, valid and dist exact."""
    kw = RELOC[radius]
    sa, ma, uva, sb, mb, uvb = _match_case(seed=6, N=1000, M=4096,
                                           spread=20.0)
    got = tfm.match_window(_bits(sa), torch.from_numpy(ma),
                           torch.from_numpy(uva), _bits(sb),
                           torch.from_numpy(mb), torch.from_numpy(uvb), **kw)
    j = [jnp.asarray(a) for a in (sa, ma, uva, sb, mb, uvb)]
    ref = jm.match(j[0], j[1], j[3], j[4], max_dist=kw["max_dist"],
                   ratio=kw["ratio"], gate=jm.window_gate(j[2], j[5], radius),
                   mutual=True)
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
    (8192, FUSE),  # SearchAndFuse: every landmark slot of the map
    (4096, RELOC[80.0]), (4096, RELOC[60.0])])  # relocalization's tries
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


# ------------------------------------------------------------ edge cases

TRACK = dict(radius=15.0, max_dist=50.0, ratio=0.9, mutual=True)


def _edge_case(name):
    """numpy (signs_a, mask_a, uv_a, signs_b, mask_b, uv_b) and the call's
    keyword arguments of one edge case of the windowed match."""
    if name == "one_by_one":  # N = M = 1, a match 3 bits and 3 px away
        rng = np.random.default_rng(11)
        sa = np.where(rng.integers(0, 2, (1, 256)), 1.0, -1.0)
        sb = sa.copy()
        sb[0, [3, 90, 200]] *= -1.0
        return (sa.astype(np.float32), np.ones(1, bool),
                np.array([[100.0, 100.0]], np.float32), sb.astype(np.float32),
                np.ones(1, bool), np.array([[103.0, 98.0]], np.float32),
                TRACK)
    if name == "ragged":  # neither side a multiple of any block
        return (*_match_case(seed=3, N=77, M=131),
                dict(radius=10.0, max_dist=60.0, ratio=0.9, mutual=True))
    if name in ("rows_masked", "cols_masked"):
        sa, ma, uva, sb, mb, uvb = _match_case(seed=5, N=40, M=60)
        (ma if name == "rows_masked" else mb)[:] = False
        return sa, ma, uva, sb, mb, uvb, TRACK
    if name == "duplicate_pair":  # row 7's argmin tie (columns M-2, M-1)
        return (*_match_case(seed=6, N=50, M=90),
                dict(TRACK, ratio=None))
    if name == "rows_tie":  # rows 0 and 1 at one distance to column 0
        sa, ma, uva, sb, mb, uvb = _match_case(seed=8, N=50, M=90)
        sa[1] = sa[0]
        uva[1] = uva[0] + 1.0
        ma[:2] = True
        uvb[2] = (uva[0] + 300.0) % 640.0
        return sa, ma, uva, sb, mb, uvb, dict(TRACK, ratio=None)
    if name == "radius_30":  # tracking's widened retry
        return (*_match_case(seed=12, N=300, M=700, spread=20.0),
                dict(TRACK, radius=30.0))
    if name == "fuse_ragged":  # SearchAndFuse, M not a multiple of a block
        return (*_match_case(seed=13, N=100, M=8191, spread=3.0), FUSE)
    if name == "n_2000":  # KITTI's feature count
        return (*_match_case(seed=14, N=2000, M=4096, spread=3.0), TRACK)
    raise KeyError(name)


EDGE_CASES = ("one_by_one", "ragged", "rows_masked", "cols_masked",
              "duplicate_pair", "rows_tie", "radius_30", "fuse_ragged")


def _assert_same(got, ref):
    """idx and valid exact, dist exact on the valid rows."""
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(ref.valid))
    np.testing.assert_array_equal(np.asarray(got.idx), np.asarray(ref.idx))
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(np.asarray(got.dist)[v],
                                  np.asarray(ref.dist)[v])


def _check_edge_case(name, ref):
    """What each case is built to show, on the reference's result."""
    idx, valid = np.asarray(ref.idx), np.asarray(ref.valid)
    if name == "one_by_one":
        assert idx.tolist() == [0] and float(np.asarray(ref.dist)[0]) == 3.0
    elif name in ("rows_masked", "cols_masked"):
        assert not valid.any()
    elif name == "duplicate_pair":
        assert idx[7] == 88  # the lower of the two tied columns
    elif name == "rows_tie":
        assert idx[0] == 0 and not valid[1]  # the lower row wins column 0
    else:
        assert valid.sum() > 20


@pytest.mark.parametrize("name", EDGE_CASES)
def test_match_window_edge_cases_match_jax(name):
    """Port match_window (plain on the CPU) against the JAX dense matcher
    under the window gate: idx and valid exact, dist exact where valid."""
    sa, ma, uva, sb, mb, uvb, kw = _edge_case(name)
    got = tfm.match_window(_bits(sa), torch.from_numpy(ma),
                           torch.from_numpy(uva), _bits(sb),
                           torch.from_numpy(mb), torch.from_numpy(uvb), **kw)
    j = [jnp.asarray(a) for a in (sa, ma, uva, sb, mb, uvb)]
    ref = jm.match(j[0], j[1], j[3], j[4], max_dist=kw["max_dist"],
                   ratio=kw["ratio"], gate=jm.window_gate(j[2], j[5],
                                                          kw["radius"]),
                   mutual=kw["mutual"])
    _check_edge_case(name, ref)
    _assert_same(got, ref)


# ------------------------------------------------- the launch, on the CPU

def _tensors(name):
    sa, ma, uva, sb, mb, uvb, kw = _edge_case(name)
    return [_bits(sa), torch.from_numpy(ma), torch.from_numpy(uva),
            _bits(sb), torch.from_numpy(mb), torch.from_numpy(uvb)], kw


@pytest.mark.parametrize("name", ["ragged", "one_by_one"])
def test_match_launch_args_view_masks_and_allocate_outputs(name):
    """What one launch is handed: bits and uv as given, each bool mask as a
    uint8 view of the same memory, and idx (N,) int32, dist (N,) f32 and
    valid (N,) bool; nothing dispatched but three `empty` and views."""
    from torch.utils._python_dispatch import TorchDispatchMode

    args, _ = _tensors(name)
    N = args[0].shape[0]

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            self.ops.append(func)
            return func(*a, **(kw or {}))

    with Log() as log:
        inputs, (idx, dist, valid) = tfm.launch_args(*args)
    assert all(op is torch.ops.aten.empty.memory_format or op.is_view
               for op in log.ops), log.ops
    assert sum(op is torch.ops.aten.empty.memory_format
               for op in log.ops) == 3
    for got, given in zip(inputs, args):
        assert got.data_ptr() == given.data_ptr()
    assert inputs[1].dtype == inputs[4].dtype == torch.uint8
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (N,)
    assert dist.dtype == torch.float32 and tuple(dist.shape) == (N,)
    assert valid.dtype == torch.bool and tuple(valid.shape) == (N,)


def test_match_launch_args_copy_only_where_needed():
    """f64 uv becomes f32, a float mask is compared with 0, and bits that
    are not contiguous or not 16-byte aligned are copied; everything else
    passes through."""
    args, _ = _tensors("ragged")
    bits_a, mask_a, uv_a, bits_b, mask_b, uv_b = args
    flat = torch.zeros(77 * 8 + 1, dtype=torch.int32)
    flat[1:] = bits_a.reshape(-1)
    shifted = flat[1:].view(77, 8)  # 4 bytes past an aligned start
    assert shifted.data_ptr() % 16
    inputs, _ = tfm.launch_args(
        shifted, mask_a.to(torch.float32), uv_a.double(),
        bits_b.t().contiguous().t(), mask_b, uv_b)
    assert inputs[0].data_ptr() % 16 == 0
    assert torch.equal(inputs[0], bits_a) and torch.equal(inputs[3], bits_b)
    assert inputs[3].is_contiguous()
    np.testing.assert_array_equal(inputs[1].numpy(),
                                  mask_a.numpy().astype(np.uint8))
    assert inputs[2].dtype == torch.float32
    assert torch.equal(inputs[2], uv_a)
    assert inputs[5].data_ptr() == uv_b.data_ptr()


@pytest.mark.parametrize("bad", ["int64_bits", "four_words", "uv_3",
                                 "short_mask", "no_rows"])
def test_match_launch_args_refuse_what_the_kernel_does_not_take(bad):
    args, _ = _tensors("ragged")
    if bad == "int64_bits":
        args[0] = args[0].long()
    elif bad == "four_words":
        args[3] = args[3][:, :4]
    elif bad == "uv_3":
        args[2] = torch.zeros((77, 3))
    elif bad == "short_mask":
        args[4] = args[4][:-1]
    else:
        args[:3] = [args[0][:0], args[1][:0], args[2][:0]]
    with pytest.raises(ValueError):
        tfm.launch_args(*args)


@pytest.mark.parametrize("N,M,blocks", [
    (1, 1, 1), (1000, 4096, 125), (1000, 8192, 125), (2000, 4096, 250),
    (77, 131, 10)])
def test_match_plan_and_blocks(N, M, blocks):
    """The wrapper's plan is instantiated in the source's MATCH_PLANS;
    blocks of 8 rows (125 at N = 1000 on the 132 SMs); sizes past a 22-bit
    key index raise."""
    src = (Path(tfm.__file__).resolve().parents[1] / "csrc"
           / "fused_match.cu").read_text()
    line = re.search(r"#define MATCH_PLANS\(X\)([^\n]*)", src).group(1)
    inst = {tuple(int(v) for v in m)
            for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", line)}
    assert tfm.plan_for(N, M) in inst
    assert tfm.blocks_for(N, M) == blocks
    with pytest.raises(ValueError):
        tfm.plan_for(tfm.MAX_ENTRIES + 1, M)
    with pytest.raises(ValueError):
        tfm.plan_for(N, 0)


def test_match_ablation_sources_instantiate_every_plan():
    """tools/match_ablation.py rewrites MATCH_PLANS once and appends its
    kernels; the rewrite must still find the macro."""
    from orb_slam3_ros2_tpu_torch.tools import match_ablation as ma

    src = (Path(tfm.__file__).resolve().parents[1] / "csrc"
           / "fused_match.cu").read_text()
    v = ma.variants(src)
    assert v["base"] == ma.with_plans(src, ma.PLANS) != src
    for t, rb, u in ma.PLANS:
        assert f"X({t}, {rb}, {u})" in v["base"]
        assert rb <= 32  # one bit of `hit` an owner
    assert v["grid"].startswith(v["base"])
    for kernel in ("match_handoff_kernel", "match_coop_kernel",
                   "match_atomic_kernel"):
        assert kernel in v["grid"]
    inf_d = int(re.search(r"#define INF_D (\d+)u", src).group(1))
    assert ma.NO_KEY == inf_d << 22


def test_match_timing_case_has_planted_matches_and_a_tie():
    """kernel_timing.match_case (chip_smoke.py's and the ablation's input)
    gives the plain version over 300 matches at tracking's shape, and row 7
    an exact tie between the last two columns."""
    from orb_slam3_ros2_tpu_torch.tools import kernel_timing as kt

    args, kw = kt.match_tensors(1000, 4096, "track", 0, "cpu")
    ref = tfm.match_window_ref(*args, **dict(kw, ratio=None))
    assert int(tfm.match_window_ref(*args, **kw).valid.sum()) > 300
    sa, _, uva, sb, _, uvb = kt.match_case(1000, 4096, 15.0, 0)
    np.testing.assert_array_equal(sb[4094], sb[4095])
    np.testing.assert_array_equal(uvb[4095], uva[7])
    assert int(ref.idx[7]) in (-1, 4094)


# ----------------------------------------------------- the kernel, on a GPU

def _on(device, args):
    return [a.to(device) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("name", EDGE_CASES + ("n_2000",))
def test_match_kernel_edge_cases_on_gpu(cuda_device, name):
    """The kernel against its plain version on the card: idx, valid and
    dist exact, one launch counted."""
    args, kw = _tensors(name)
    args = _on(cuda_device, args)
    n = tfm.match_window.launches
    got = tfm.match_window(*args, **kw)
    ref = tfm.match_window_ref(*args, **kw)
    assert tfm.match_window.launches == n + 1
    _check_edge_case(name, type(ref)(*(t.cpu() for t in ref)))
    assert torch.equal(got.idx, ref.idx) and torch.equal(got.valid, ref.valid)
    assert torch.equal(got.dist, ref.dist)


@pytest.mark.cuda
def test_match_kernel_back_to_back_calls_on_gpu(cuda_device):
    """Three calls in a row on two inputs, mutual and not, with no
    synchronize between: each exactly its plain version's (state left by
    a launch would show)."""
    calls = []
    for seed in (21, 22, 21):
        sa, ma, uva, sb, mb, uvb = _match_case(seed=seed, N=1000, M=4096,
                                               spread=3.0)
        args = _on(cuda_device, [_bits(sa), torch.from_numpy(ma),
                                 torch.from_numpy(uva), _bits(sb),
                                 torch.from_numpy(mb), torch.from_numpy(uvb)])
        calls += [(args, TRACK), (args, FUSE)]
    gots = [tfm.match_window(*a, **kw) for a, kw in calls]
    for (a, kw), got in zip(calls, gots):
        ref = tfm.match_window_ref(*a, **kw)
        assert int(ref.valid.sum()) > 20
        assert torch.equal(got.idx, ref.idx)
        assert torch.equal(got.valid, ref.valid)
        assert torch.equal(got.dist, ref.dist)


@pytest.mark.cuda
def test_match_kernel_call_dispatches_empty_and_views_on_gpu(cuda_device):
    """A CUDA call, mutual or not: three `torch.empty` and views; and its
    latency floor launches on the same arguments."""
    from torch.utils._python_dispatch import TorchDispatchMode

    args, kw = _tensors("ragged")
    args = _on(cuda_device, args)

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, a=(), k=None):
            self.ops.append(func)
            return func(*a, **(k or {}))

    for mutual in (True, False):
        with Log() as log:
            tfm.match_window(*args, **dict(kw, mutual=mutual))
        assert all(op is torch.ops.aten.empty.memory_format or op.is_view
                   for op in log.ops), log.ops
        assert sum(op is torch.ops.aten.empty.memory_format
                   for op in log.ops) == 3
    n = tfm.match_window.launches
    idx, dist, valid = tfm.latency_floor(*args, **kw)
    torch.cuda.synchronize()
    assert tfm.match_window.launches == n and tuple(idx.shape) == (77,)
