"""Parity of the port's extraction path (pyramid, FAST/NMS, packed
frontend, ORB descriptor, extractor) with the JAX package on the CPU, and of
the packed-frontend CUDA kernel with its plain version on a GPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_ros2_tpu.frontend import extractor as jex
from orb_slam3_ros2_tpu.io.synthetic import _texture
from orb_slam3_ros2_tpu.ops import fast as jfast
from orb_slam3_ros2_tpu.ops import orb_descriptor as jdesc
from orb_slam3_ros2_tpu.ops import pallas_kernels as pk
from orb_slam3_ros2_tpu.ops import pyramid as jpyr
from orb_slam3_ros2_tpu_torch.frontend import extractor as tex
from orb_slam3_ros2_tpu_torch.ops import fast as tfast
from orb_slam3_ros2_tpu_torch.ops import frontend_packed as tfp
from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as tdesc
from orb_slam3_ros2_tpu_torch.ops import pyramid as tpyr


def _img(h=96, w=160, seed=0):
    """The JAX oracle tests' image: boxes plus noise."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for _ in range(25):
        y, x = rng.integers(5, h - 15), rng.integers(5, w - 15)
        bh, bw = rng.integers(4, 12, size=2)
        img[y:y + bh, x:x + bw] = rng.uniform(30, 250)
    img += rng.normal(0, 1.5, size=img.shape)
    return np.clip(img, 0, 255).astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape,out", [((240, 320), (200, 267)),
                                       ((480, 752), (400, 627)),
                                       ((139, 185), (116, 154))])
def test_resize_matches_jax_image_resize(shape, out):
    """Same antialiased triangle weights as jax.image.resize. The port is
    within 1e-4 gray levels of the float64 product of those weights; the JAX
    CPU contraction is up to 2.2e-3 off it at 480x752 (see ROADMAP), so the
    bound against JAX is 3e-3 on 0..255 intensities."""
    img = np.random.default_rng(1).uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), out, "bilinear"))
    got = tpyr.resize(torch.from_numpy(img), out).numpy()
    exact = (tpyr._resize_weights(shape[0], out[0]).astype(np.float64)
             @ img.astype(np.float64)
             @ tpyr._resize_weights(shape[1], out[1]).astype(np.float64).T)
    np.testing.assert_allclose(got, exact, atol=1e-4)
    np.testing.assert_allclose(got, ref, atol=3e-3)


def test_pyramid_blur_and_budgets():
    img = _texture(240, 320, seed=5).astype(np.float32)
    lv_j = jpyr.build_pyramid(jnp.asarray(img), 4, 1.2)
    lv_t = tpyr.build_pyramid(torch.from_numpy(img), 4, 1.2)
    assert [tuple(l.shape) for l in lv_t] == [l.shape for l in lv_j]
    for a, b in zip(lv_j, lv_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)
        np.testing.assert_allclose(
            tpyr.gaussian_blur(b).numpy(),
            np.asarray(jpyr.gaussian_blur(jnp.asarray(b.numpy()))),
            rtol=1e-5, atol=1e-4)
    assert tpyr.level_shapes(480, 752, 8, 1.2) == jpyr.level_shapes(480, 752,
                                                                    8, 1.2)
    assert tpyr.features_per_level(1000, 8, 1.2) == [217, 181, 151, 126, 105,
                                                      87, 73, 60]


@pytest.mark.parametrize("seed", [0, 1])
def test_fast_score_and_nms_exact(seed):
    img = _img(seed=seed)
    s_j = np.asarray(jfast.fast_score(jnp.asarray(img)))
    s_t = tfast.fast_score(torch.from_numpy(img))
    np.testing.assert_array_equal(s_t.numpy(), s_j)
    np.testing.assert_array_equal(tfast.nms3x3(s_t).numpy(),
                                  np.asarray(jfast.nms3x3(jnp.asarray(s_j))))


def test_pack_layout_at_full_width():
    shapes = tpyr.level_shapes(480, 752, 8, 1.2)
    assert tfp.pack_layout(shapes) == pk.pack_layout(shapes)
    layout, total = tfp.pack_layout(shapes)
    assert total == 2304
    assert [r0 for r0, _, _ in layout] == [0, 488, 896, 1237, 1523, 1762,
                                           1963, 2132]


@pytest.mark.parametrize("interpret", [True, None])
def test_frontend_packed_plain_matches_jax(interpret):
    """The plain packed frontend against the Pallas kernel in interpret mode
    (interior B=4 as tests/test_pallas_kernels.py) and against the JAX CPU
    fallback (whole canvas)."""
    levels = [_img(96, 160, seed=2), _img(80, 133, seed=3),
              _img(64, 111, seed=4)]
    ref = pk.frontend_pass_packed([jnp.asarray(l) for l in levels],
                                  interpret=interpret)
    got = tfp.frontend_pass_packed([torch.from_numpy(l) for l in levels])
    assert got[4] == ref[4]
    score, keep, blur, raw = (g.numpy() for g in got[:4])
    score_j, keep_j, blur_j, raw_j = (np.asarray(r) for r in ref[:4])
    assert score.shape == score_j.shape
    B = 4 if interpret else 0
    for (r0, h, w) in got[4]:
        sl = np.s_[r0 + B:r0 + h - B, B:w - B]
        np.testing.assert_allclose(score[sl], score_j[sl], atol=1e-4)
        np.testing.assert_array_equal(keep[sl], keep_j[sl])
        np.testing.assert_allclose(blur[sl], blur_j[sl], rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(raw[r0:r0 + h, :w], raw_j[r0:r0 + h, :w])
    for (r0, h, w) in got[4][:-1]:
        assert np.all(score[r0 + h:r0 + h + tfp.PACK_GAP] == 0.0)


def test_brief_pattern_identical():
    np.testing.assert_array_equal(tdesc.brief_pattern(), jdesc.brief_pattern())


def test_gather_patches_and_orientations():
    img = _texture(120, 160, seed=2).astype(np.float32)
    rng = np.random.default_rng(3)
    yx = np.stack([rng.integers(15, 105, 64), rng.integers(15, 145, 64)],
                  -1).astype(np.int32)
    # out-of-range starts wrap and clamp as in lax.dynamic_slice
    yx[:3] = [[2, 3], [119, 159], [0, 80]]
    p_j = np.asarray(jdesc.gather_patches(jnp.asarray(img), jnp.asarray(yx)))
    p_t = tdesc.gather_patches(torch.from_numpy(img), torch.from_numpy(yx))
    np.testing.assert_array_equal(p_t.numpy(), p_j)
    np.testing.assert_allclose(tdesc.orientations(p_t).numpy(),
                               np.asarray(jdesc.orientations(jnp.asarray(p_j))),
                               atol=1e-4)


def test_describe_exact_on_identical_patches():
    """Same patches and angles: identical descriptors, bits and signs."""
    rng = np.random.default_rng(7)
    patches = np.stack([
        np.asarray(jpyr.gaussian_blur(jnp.asarray(
            rng.uniform(0, 255, (31, 31)).astype(np.float32))))
        for _ in range(128)])
    angles = rng.uniform(-np.pi, np.pi, 128).astype(np.float32)
    s_j, b_j = jdesc.describe(jnp.asarray(patches), jnp.asarray(angles),
                              binned=False)
    s_t, b_t = tdesc.describe(torch.from_numpy(patches),
                              torch.from_numpy(angles))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j).view(np.int32))


def test_pack_unpack_bits_roundtrip():
    rng = np.random.default_rng(8)
    bits = rng.random((50, 256)) > 0.5
    packed_j = np.asarray(jdesc.pack_bits(jnp.asarray(bits)))
    packed_t = tdesc.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(packed_t.numpy(), packed_j.view(np.int32))
    np.testing.assert_array_equal(tdesc.unpack_bits(packed_t).numpy(), bits)
    np.testing.assert_array_equal(
        tdesc.signs_from_bits(packed_t).numpy(),
        np.asarray(jdesc.signs_from_bits(jnp.asarray(packed_j))))


@pytest.mark.parametrize("n_levels", [3, 4])
def test_extractor_matches_jax(n_levels):
    """240x320: the same keypoint set on level 0, uv within 1e-3 px and at
    least 99% of level-0 descriptor bits equal (the orientation matmul sums
    in another order, which can flip a near-tied bit). Coarser levels are
    resized by the two packages at ~1e-3 gray-level difference, so only their
    validity counts are held equal."""
    H, W = 240, 320
    img = _texture(H, W, seed=5).astype(np.float32)
    kw = dict(n_features=512, n_levels=n_levels, height=H, width=W)
    fj = jex.make_extractor(jex.ExtractorConfig(**kw))(jnp.asarray(img))
    ft = tex.make_extractor(tex.ExtractorConfig(**kw))(torch.from_numpy(img))
    n0 = tpyr.features_per_level(512, n_levels, 1.2)[0]
    assert ft.uv.shape == (512, 2) and ft.bits.dtype == torch.int32
    mj, mt = np.asarray(fj.mask), ft.mask.numpy()
    np.testing.assert_array_equal(mt[:n0], mj[:n0])
    assert mt.sum() == mj.sum()
    v = mj[:n0]
    np.testing.assert_allclose(ft.uv.numpy()[:n0][v],
                               np.asarray(fj.uv)[:n0][v], atol=1e-3)
    np.testing.assert_array_equal(ft.level.numpy(), np.asarray(fj.level))
    np.testing.assert_allclose(ft.score.numpy()[:n0][v],
                               np.asarray(fj.score)[:n0][v], atol=1e-4)
    same = ft.signs.numpy()[:n0][v] == np.asarray(fj.signs)[:n0][v]
    assert same.mean() >= 0.99, same.mean()


@pytest.mark.cuda
def test_frontend_kernel_matches_plain_on_gpu(cuda_device):
    img = _texture(480, 752, seed=5).astype(np.float32)
    levels = tpyr.build_pyramid(torch.from_numpy(img).to(cuda_device), 8, 1.2)
    n = tfp.frontend_pass_packed.launches
    got = tfp.frontend_pass_packed(levels)
    ref = tfp.frontend_pass_packed_ref(levels)
    torch.cuda.synchronize()
    assert tfp.frontend_pass_packed.launches == n + 1
    B = 4
    for (r0, h, w) in got[4]:
        sl = np.s_[r0 + B:r0 + h - B, B:w - B]
        s, k, b = (x.cpu().numpy() for x in got[:3])
        s_r, k_r, b_r = (x.cpu().numpy() for x in ref[:3])
        np.testing.assert_allclose(s[sl], s_r[sl], atol=1e-4)
        np.testing.assert_array_equal(k[sl], k_r[sl])
        np.testing.assert_allclose(b[sl], b_r[sl], rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got[3].cpu().numpy(), ref[3].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(376, 1241), (512, 512)])
def test_frontend_kernel_matches_plain_on_gpu_at_rig_widths(cuda_device,
                                                            shape):
    """The 8-level pyramids of a KITTI (1241x376) and a TUM-VI (512x512)
    frame, at the bounds of the 752x480 case."""
    img = _texture(*shape, seed=6).astype(np.float32)
    levels = tpyr.build_pyramid(torch.from_numpy(img).to(cuda_device), 8, 1.2)
    got = tfp.frontend_pass_packed(levels)
    ref = tfp.frontend_pass_packed_ref(levels)
    torch.cuda.synchronize()
    assert got[4] == ref[4] and got[0].shape[1] == shape[1]
    B = 4
    s, k, b = (x.cpu().numpy() for x in got[:3])
    s_r, k_r, b_r = (x.cpu().numpy() for x in ref[:3])
    for (r0, h, w) in got[4]:
        sl = np.s_[r0 + B:r0 + h - B, B:w - B]
        np.testing.assert_allclose(s[sl], s_r[sl], atol=1e-4)
        np.testing.assert_array_equal(k[sl], k_r[sl])
        np.testing.assert_allclose(b[sl], b_r[sl], rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got[3].cpu().numpy(), ref[3].cpu().numpy())


def test_frontend_wrapper_raises_off_cpu_without_a_kernel():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel path, which refuses a non-CUDA tensor instead of falling
    back."""
    levels = [torch.zeros((64, 96), device="meta")]
    n = tfp.frontend_pass_packed.launches
    with pytest.raises(ValueError, match="CUDA"):
        tfp.frontend_pass_packed(levels)
    assert tfp.frontend_pass_packed.launches == n
