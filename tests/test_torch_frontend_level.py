"""Parity of the port's per-level frontend ops (`ops/frontend_level.py`) with
the JAX Pallas kernels in interpret mode on the CPU, at the JAX oracle tests'
size and tolerances (`tests/test_pallas_kernels.py`): the plain versions on
the interior, the zero-padding mirror on the whole image; the kernel's launch
plan; and the CUDA kernels against both on a GPU."""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_ros2_tpu.ops import orb_descriptor as jdesc
from orb_slam3_ros2_tpu.ops import pallas_kernels as pk
from orb_slam3_ros2_tpu_torch.ops import frontend_level as tfl
from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as tdesc
from orb_slam3_ros2_tpu_torch.ops import pyramid as tpyr

# interiors: score/keep/blur agree >= 4 px from the border (zero vs reflect
# padding), the moment maps >= 16 px (disc radius 15 + 1)
B, BM = 4, 16
TOL = dict(score=dict(atol=1e-4), blur=dict(rtol=1e-5, atol=1e-3),
           moments=dict(rtol=2e-4, atol=2.0))


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


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _interior(a, b):
    return a[b:-b, b:-b]


def _check_score_keep(score, keep, score_ref, keep_ref):
    np.testing.assert_allclose(_interior(_np(score), B),
                               _interior(_np(score_ref), B), **TOL["score"])
    np.testing.assert_array_equal(_interior(_np(keep), B),
                                  _interior(_np(keep_ref), B))


def _check_blur(blur, blur_ref):
    np.testing.assert_allclose(_interior(_np(blur), B),
                               _interior(_np(blur_ref), B), **TOL["blur"])


def _check_moments(m01, m10, m01_ref, m10_ref):
    for a, b in ((m01, m01_ref), (m10, m10_ref)):
        np.testing.assert_allclose(_interior(_np(a), BM), _interior(_np(b), BM),
                                   **TOL["moments"])


@pytest.mark.parametrize("seed", [0, 3])
def test_fast_nms_matches_pallas(seed):
    img = _img(seed=seed)
    score, keep = tfl.fast_nms(torch.from_numpy(img))
    s_j, k_j = pk.fast_nms(jnp.asarray(img), interpret=True)
    _check_score_keep(score, keep, s_j, k_j)
    assert keep.dtype == torch.bool and int(keep.sum()) > 10


@pytest.mark.parametrize("seed", [1, 4])
def test_blur7_matches_pallas(seed):
    img = _img(seed=seed)
    _check_blur(tfl.blur7(torch.from_numpy(img)),
                pk.blur7(jnp.asarray(img), interpret=True))


@pytest.mark.parametrize("seed", [3, 5])
def test_frontend_pass_matches_pallas(seed):
    img = _img(seed=seed)
    score, keep, m01, m10, blur = tfl.frontend_pass(torch.from_numpy(img))
    s_j, k_j, m01_j, m10_j, b_j = pk.frontend_pass(jnp.asarray(img),
                                                   interpret=True)
    _check_score_keep(score, keep, s_j, k_j)
    _check_moments(m01, m10, m01_j, m10_j)
    _check_blur(blur, b_j)


def test_frontend_pass_lite_matches_pallas():
    img = _img(seed=6)
    score, keep, blur = tfl.frontend_pass_lite(torch.from_numpy(img))
    s_j, k_j, b_j = pk.frontend_pass_lite(jnp.asarray(img), interpret=True)
    _check_score_keep(score, keep, s_j, k_j)
    _check_blur(blur, b_j)


@pytest.mark.parametrize("shape", [(96, 160), (61, 97)])
def test_moment_maps_match_jax(shape):
    """The float64 plain moment maps against the JAX float32 ones (both
    exact on the interior up to rounding), and against the disc moments of
    gathered patches."""
    img = _img(*shape, seed=7)
    m01, m10 = tdesc.moment_maps(torch.from_numpy(img))
    m01_j, m10_j = jdesc.moment_maps(jnp.asarray(img))
    assert m01.dtype == torch.float32 and m01.shape == shape
    _check_moments(m01, m10, m01_j, m10_j)
    # exact disc moments at a few interior pixels, in float64
    w = tdesc._orientation_weights().astype(np.float64)
    for (y, x) in ((BM, BM), (shape[0] // 2, shape[1] // 2),
                   (shape[0] - BM - 1, shape[1] - BM - 1)):
        patch = img[y - 15:y + 16, x - 15:x + 16].astype(np.float64).ravel()
        want = patch @ w
        np.testing.assert_allclose([m01[y, x].item(), m10[y, x].item()],
                                   want, rtol=1e-6, atol=1e-2)


# ------------------------------------- the zero-padding mirror, whole image

def _check_whole(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _check_mirror(name, got, want):
    """got / want: the outputs of `name` (tuples), on the whole image."""
    if name == "blur7":
        got, want = (got,), (want,)
    kinds = dict(fast_nms=("score", "keep"), blur7=("blur",),
                 frontend_pass=("score", "keep", "moments", "moments", "blur"),
                 frontend_pass_lite=("score", "keep", "blur"))[name]
    for kind, g, w in zip(kinds, got, want):
        if kind == "keep":
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=name)
        else:
            _check_whole(g, w, TOL[kind], f"{name} {kind}")


MIRRORS = ("fast_nms", "blur7", "frontend_pass", "frontend_pass_lite")


@pytest.mark.parametrize("shape", [(96, 160), (61, 97), (139, 218)])
@pytest.mark.parametrize("name", MIRRORS)
def test_zero_mirror_matches_pallas_whole_image(name, shape):
    """The plain zero-padding mirror (`*_zero`) equals the Pallas kernel in
    interpret mode on every pixel, the border band included."""
    img = _img(*shape, seed=11)
    got = getattr(tfl, f"{name}_zero")(torch.from_numpy(img))
    want = getattr(pk, name)(jnp.asarray(img), interpret=True)
    _check_mirror(name, got, want)


def test_zero_mirror_and_ref_differ_only_at_the_border():
    """The mirror and the plain versions agree on the interior; the blur
    differs at the border (zero against reflect padding)."""
    img = torch.from_numpy(_img(61, 97, seed=12))
    z, r = tfl.frontend_pass_zero(img), tfl.frontend_pass_ref(img)
    _check_score_keep(z[0], z[1], r[0], r[1])
    _check_moments(z[2], z[3], r[2], r[3])
    _check_blur(z[4], r[4])
    assert torch.equal(z[0], r[0]) and torch.equal(z[2], r[2])
    assert float((z[4] - r[4]).abs().max()) > 0.1


# ------------------------------------------------------------ launch plan

# every level of the 752x480, 1241x376 and 512x512 pyramids, and odd shapes
PLAN_SHAPES = sorted({s for h, w in ((480, 752), (376, 1241), (512, 512))
                      for s in tpyr.level_shapes(h, w, 8, 1.2)}
                     | {(1, 1), (3, 5), (15, 95), (16, 96), (17, 97),
                        (61, 97), (139, 218), (33, 1), (1, 193)})


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_launch_plan_stores_each_cell_once(shape):
    """Every output cell of score / keep / blur and of m01 / m10 is stored
    exactly once by the level kernel's tiles, groups and moment threads and
    by blur7's strips and lanes, and at the pyramids' widths most cells go
    by 16-byte stores."""
    H, W = shape
    for moments, blur7, (tw, th) in ((False, False, tfl.LITE_TILE),
                                     (True, False, tfl.MOM_TILE),
                                     (False, True, tfl.BLUR_TILE)):
        counts, mom, vector = tfl.store_counts(H, W, moments=moments,
                                               blur7=blur7)
        assert counts.shape == (H, W) and (counts == 1).all()
        assert mom is None if not moments else (mom == 1).all()
        gx, gy = tfl.launch_grid(H, W, moments, blur7)
        assert (gx - 1) * tw < W <= gx * tw and (gy - 1) * th < H <= gy * th
        if blur7:
            assert vector == 0
        elif W >= 96:
            assert vector > 0.9


def _blur7_lanes(img, rows=tfl.BLUR_ROWS):
    """blur7_kernel restated over every warp and lane at once (numpy f32):
    each lane's column of `rows` + 6 rows, loaded cell by cell (zero
    outside); the vertical pass; the 3 vertical sums either side from the
    lanes beside it (a shuffle out of the warp reads the lane's own); each
    of lanes 3-28 stores its cell. Returns the output and how often each
    cell was stored."""
    H, W = img.shape
    strip = 32 - 6
    taps = tpyr._gauss_kernel1d(7, 2.0)
    lane = np.arange(32)
    y0 = rows * np.arange(-(-H // rows))[:, None, None]  # (bands, 1, 1)
    x0 = strip * np.arange(-(-W // strip))[None, :, None]  # (1, strips, 1)
    x = x0 + lane - 3  # a lane's column
    shape = (y0.shape[0], x0.shape[1], 32)

    def load(y):
        yy, xx = np.broadcast_arrays(y, x)
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        return np.where(ok, img[yy.clip(0, H - 1), xx.clip(0, W - 1)],
                        np.float32(0))

    def shfl(v, d):  # lane l reads lane l + d; out of range: its own
        src = lane + d
        return np.where((src >= 0) & (src < 32), v[..., src.clip(0, 31)], v)

    a = [load(y0 - 3 + r) for r in range(rows + 6)]
    out = np.zeros((H, W), np.float32)
    count = np.zeros((H, W), np.int64)
    xs = np.broadcast_to(x, shape)
    for i in range(rows):
        v = np.float32(0)
        for k in range(7):
            v = v + taps[k] * a[i + k]
        o = np.float32(0)
        for k in range(7):
            o = o + taps[k] * shfl(v, k - 3)
        y = np.broadcast_to(y0 + i, shape)
        hit = (y < H) & (lane >= 3) & (lane < 29) & (xs < W)
        out[y[hit], xs[hit]] = o[hit]
        np.add.at(count, (y[hit], xs[hit]), 1)
    return out, count


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (33, 1), (61, 97),
                                   (40, 130), (37, 243), (50, 262),
                                   (33, 522), (21, 627), (19, 1241)])
@pytest.mark.parametrize("rows", [tfl.BLUR_ROWS, 3, 16])
def test_blur7_lane_plan_equals_zero_mirror(shape, rows):
    """blur7's loads, shuffles and stores, restated lane by lane on the
    CPU (the shipped rows a warp and two others), store each cell once and
    give the zero-padding mirror bit for bit (a signed zero included) at
    widths of every residue mod 4."""
    rng = np.random.default_rng(sum(shape))
    img = (rng.random(shape) * 255).astype(np.float32)
    img[rng.random(shape) < 0.05] = -0.0
    got, count = _blur7_lanes(img, rows)
    want = tfl.blur7_zero(torch.from_numpy(img)).numpy()
    assert (count == 1).all()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_source_constants_match_the_plan():
    """The tile and moment tiling in `csrc/frontend_level.cu` are the ones
    `ops/frontend_level.py` restates, and its compiled-in blur taps are the
    f32 taps of `pyramid._gauss_kernel1d(7, 2.0)` bit for bit."""
    src = (Path(tfl.__file__).resolve().parents[1] / "csrc"
           / "frontend_level.cu").read_text()

    tiles = re.findall(r"constexpr int ([ML])TW = (\d+), [ML]TH = (\d+);",
                       src)
    assert {k: (int(w), int(h)) for k, w, h in tiles} == dict(
        M=tfl.MOM_TILE, L=tfl.LITE_TILE)
    m = re.search(r"constexpr int BRW = (\d+), BNW = (\d+);", src)
    assert m.groups() == (str(tfl.BLUR_ROWS), str(tfl.BLUR_WARPS))
    assert "constexpr int BSW = 32 - 6, BTH = BNW * BRW;" in src
    assert tfl.BLUR_TILE == (32 - 6, tfl.BLUR_WARPS * tfl.BLUR_ROWS)
    m = re.search(r"constexpr int MC = (\d+), MK = (\d+);", src)
    assert (int(m.group(1)), int(m.group(2))) == (tfl.MOM_COLS, tfl.MOM_ROWS)
    body = re.search(r"c_taps\[7\] = \{([^}]*)\}", src).group(1)
    taps = np.array([float.fromhex(t.strip().rstrip("f"))
                     for t in body.split(",")], np.float32)
    np.testing.assert_array_equal(taps, tpyr._gauss_kernel1d(7, 2.0))
    u = [int(np.floor(np.sqrt(225 - d * d))) for d in range(16)]
    chain = re.search(r"constexpr int disc_u\(int d\) \{(.*?)\}", src,
                      re.S).group(1)
    assert u == [15, 14, 14, 14, 14, 14, 13, 13, 12, 12, 11, 10, 9, 7, 5, 0]
    assert "d <= 5 ? 14 : d <= 7 ? 13 : d <= 9 ? 12" in " ".join(chain.split())


# -------------------------------------------------------------- on a GPU

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(96, 160), (480, 752), (139, 218),
                                   (61, 97), (376, 1241)])
def test_kernels_match_plain_on_gpu(cuda_device, shape):
    """Each kernel equals the zero-padding mirror on the whole image and
    the plain version on the interior, gives the same bits twice, and
    counts one launch a call."""
    img = torch.from_numpy(_img(*shape, seed=2)).to(cuda_device)
    fns = [getattr(tfl, name) for name in MIRRORS]
    n0 = [f.launches for f in fns]
    got = {name: fn(img) for name, fn in zip(MIRRORS, fns)}
    again = {name: fn(img) for name, fn in zip(MIRRORS, fns)}
    n1 = [f.launches for f in fns]
    assert [b - a for a, b in zip(n0, n1)] == [2, 2, 2, 2]
    for name in MIRRORS:
        a, b = got[name], again[name]
        a, b = ((a,), (b,)) if name == "blur7" else (a, b)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name
        _check_mirror(name, got[name], getattr(tfl, f"{name}_zero")(img))
    _check_score_keep(*got["fast_nms"], *tfl.fast_nms_ref(img))
    _check_blur(got["blur7"], tfl.blur7_ref(img))
    full, ref = got["frontend_pass"], tfl.frontend_pass_ref(img)
    _check_score_keep(full[0], full[1], ref[0], ref[1])
    _check_moments(full[2], full[3], ref[2], ref[3])
    _check_blur(full[4], ref[4])
    lite, ref = got["frontend_pass_lite"], tfl.frontend_pass_lite_ref(img)
    _check_score_keep(lite[0], lite[1], ref[0], ref[1])
    _check_blur(lite[2], ref[2])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 752), (400, 627), (333, 522),
                                   (376, 1241), (1, 1), (3, 5), (33, 1)])
def test_blur7_equals_zero_mirror_on_gpu(cuda_device, shape):
    """blur7 equals the zero-padding mirror bit for bit at widths of every
    residue mod 4 and at odd shapes, on a level and on a view of one that
    starts 4 bytes into its buffer (off the 16-byte grid at every width),
    one launch a call."""
    H, W = shape
    rng = np.random.default_rng(sum(shape))
    big = (rng.random(H * W + 1) * 255).astype(np.float32)
    big = torch.from_numpy(big).to(cuda_device)
    n0 = tfl.blur7.launches
    for img in (big[:-1].view(H, W), big[1:].view(H, W)):
        got = tfl.blur7(img)
        assert torch.equal(got, tfl.blur7_zero(img))
        assert torch.equal(got, tfl.blur7(img))
    assert tfl.blur7.launches - n0 == 4


# ------------------------------------------------------ kernel_timing.py

@pytest.mark.parametrize("name", ("fast_nms", "frontend_pass",
                                  "frontend_pass_lite", "blur7"))
def test_kernel_timing_takes_the_per_level_kernels(name, capsys):
    """`tools/kernel_timing.py --kernel <per-level kernel>` parses (and,
    with no card here, stops for want of one), and its inputs are every
    level of the rendered frame's 8-level pyramid, or level 0 alone."""
    from orb_slam3_ros2_tpu_torch.tools import kernel_timing as kt

    with pytest.raises(SystemExit):
        kt.main(["--root", ".", "--kernel", name, "--levels", "0",
                 "--shapes", "160x96"])
    assert "no CUDA device" in capsys.readouterr().err
    levels = kt.level_inputs("160x96", "all", "cpu")
    assert [i for i, _ in levels] == list(range(8))
    assert [tuple(l.shape) for _, l in levels] == tpyr.level_shapes(
        96, 160, 8, 1.2)
    (i0, l0), = kt.level_inputs("160x96", "0", "cpu")
    assert i0 == 0 and torch.equal(l0, levels[0][1])
    out = getattr(tfl, name)(l0)  # on the CPU: the plain version
    ref = getattr(tfl, f"{name}_ref")(l0)
    out, ref = ((out,), (ref,)) if name == "blur7" else (out, ref)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_level_ablation_variants_apply():
    """Each variant of `tools/level_ablation.py` is an edit that the source
    still takes, and joined names apply their edits in turn."""
    from orb_slam3_ros2_tpu_torch.ops import cuda_lib
    from orb_slam3_ros2_tpu_torch.tools import level_ablation as la

    src = (cuda_lib.CSRC / "frontend_level.cu").read_text()
    out = la.variants(src)
    assert out["full"] == src and len(out) == 1 + len(la.EDITS)
    assert all(text != src for name, text in out.items() if name != "full")
    assert "constexpr int LTW = 64, LTH = 8;" in out["lite_64x8"]
    assert "constexpr int BRW = 4, BNW = 8;" in out["blur_c1_r4_w8"]
    for name, plan in (("blur_c2_r2_w8", "constexpr int BC = 2, BRW = 2, "
                        "BNW = 8;\nconstexpr bool BVEC = false;"),
                       ("blur_c4_r8_w4_vec", "constexpr int BC = 4, BRW = 8, "
                        "BNW = 4;\nconstexpr bool BVEC = true;")):
        text = out[name]  # the shipped kernel replaced by the plan's
        assert plan in text and "blur7_plan_launch(img, H, W, blur" in text
        assert "constexpr int BSW = 32 - 6," not in text
        assert text.count("__global__") == src.count("__global__")
    assert "BVEC" not in src and "load4" not in src
    assert la.BLUR_PLAN not in la.BLUR_PLANS and len(la.BLUR_PLANS) >= 6
    both = la.variant(src, "stage_only+no_m10")
    assert "if (n > 0) return;" in both and la.M10_ADD not in both
