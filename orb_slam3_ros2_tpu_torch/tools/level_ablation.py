"""Where the per-level kernels' time goes: build variants of
`csrc/frontend_level.cu` with one part changed or taken out and time each
on the card.

    python -m orb_slam3_ros2_tpu_torch.tools.level_ablation \\
        [--shapes 752x480 1241x376] [--variants full no_score stage_only+no_m10]

Variants (each a copy of the source with one edit, built by nvcc into
`build/kernels/ablation/`):

  full           the kernels as they are
  lite_WxH       the tile without the moment maps (fast_nms, lite) W x H
                 instead of 64x16 (96x16, 128x16, 64x32, 64x8, 32x16)
  no_score       the FAST score replaced by the centre pixel (no ring, no
                 min/max); staging, blur, NMS and stores kept
  no_early_out   every interior cell listed for the score (no
                 compass-point test)
  mom_no_gather  the moment threads build the prefix sums and stop (m01,
                 m10 not written)
  no_moments     the moment threads stop after the staging: the pass is
                 the score warps alone
  no_m01, no_m10 the gather without the S rows (m01) or the V columns (m10)
  stage_only     the tile threads return after the staging: no score,
                 blur, NMS or stores (the moment threads kept)
  mom_384        the pass with the moment maps on 384 threads a block: 2
                 warps a map of 3 x 8 outputs a thread (not 4 of 3 x 4)
  blur_cC_rR_wN[_vec]
                 blur7 with C columns a lane, R rows a warp and N warps a
                 block, loading and storing each cell alone, or with _vec
                 in 16-byte groups realigned by shuffles (C 4, R a
                 multiple of 4): with one column a lane the shipped kernel
                 with its BRW, BNW changed, else the kernel of
                 `BLUR_PLAN_SRC` in its place

Names joined by "+" combine edits. Prints one JSON line per variant and
level 0 (`--levels all`: every level) of each shape: device µs per
launch of each of `--kernels` (`fast_nms`, `frontend_pass_lite`,
`frontend_pass`, `blur7`; torch.profiler over 50 launches, the kernel's
own device time), whether each
equals the zero-padding mirror (`ops/frontend_level.py` `*_zero`; blur7
bit for bit; expected for full and the tile and blur variants), and
ptxas' registers and spills. The variants are measurements, never used by
the port.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import subprocess

import torch

from orb_slam3_ros2_tpu_torch.ops import cuda_lib
from orb_slam3_ros2_tpu_torch.ops import frontend_level as fl
from orb_slam3_ros2_tpu_torch.tools.kernel_timing import (device_events,
                                                          level_inputs)

LITE_TILE = "constexpr int LTW = 64, LTH = 16;"
SCORE_CALL = ("    s_sc[ly * SCW + lx + 3] = fast_score<T::KW>(s_key, ly + 3, "
              "lx + 3);")
ARC_TEST = ("              x < W - BORDER && arc_possible<T::KW>(s_key, ly + 3, "
            "lx + 3);")
CENTRE = ("    s_sc[ly * SCW + lx + 3] = __int_as_float(key_of(s_key[(ly + 3) "
          "* T::KW + lx + 3]));")
GATHER = "  group_sync(ROWS ? 1 : 3, NS);\n"
MOM_BRANCH = "    if (tid < NS) {\n"
TILE_BODY = ("  using T = Tile<TW, TH>;\n"
             "  constexpr int SCW = T::SCW, SVW = T::SVW, NG = T::NG, "
             "NPIX = T::NPIX;\n")
MOM_THREADS = "constexpr int NTM = 512;"
MOM_ROWS = "constexpr int MC = 3, MK = 4;"
MOM_WARPS = "constexpr int NM = 256;"
LITE_TILES = ((96, 16), (128, 16), (64, 32), (64, 8), (32, 16))
BLUR_ROWS_WARPS = f"constexpr int BRW = {fl.BLUR_ROWS}, BNW = {fl.BLUR_WARPS};"
BLUR_PLAN = (1, fl.BLUR_ROWS, fl.BLUR_WARPS, False)  # the shipped plan
BLUR_PLANS = [p for p in (
    (4, 4, 8, True), (4, 4, 4, True), (4, 8, 4, True), (4, 4, 2, True),
    (4, 4, 1, True), (4, 8, 2, True), (4, 8, 1, True), (4, 4, 8, False),
    (4, 2, 8, False), (4, 1, 8, False), (4, 2, 16, False), (4, 4, 2, False),
    (4, 4, 1, False), (4, 8, 1, False), (4, 2, 2, False), (2, 4, 8, False),
    (2, 2, 8, False), (2, 1, 16, False), (2, 4, 2, False), (2, 4, 1, False),
    (2, 8, 2, False), (2, 8, 1, False), (1, 4, 8, False), (1, 2, 8, False),
    (1, 8, 4, False), (1, 4, 2, False), (1, 4, 1, False), (1, 8, 1, False),
    (1, 16, 1, False), (1, 6, 2, False), (1, 12, 2, False), (1, 16, 2, False),
    (2, 6, 2, False)) if p != BLUR_PLAN]
# the shipped blur7 kernel and its launch, which a plan of several columns
# a lane or of 16-byte groups replaces
BLUR_KERNEL = re.compile(r"// blur7: a warp owns.*?(?=template <bool BLUR, "
                         r"bool MOM>\nint launch_level)", re.S)
BLUR_LAUNCH = ("  const dim3 grid((W + BSW - 1) / BSW, (H + BTH - 1) / BTH);\n"
               "  blur7_kernel<<<grid, 32 * BNW, 0, (cudaStream_t)stream>>>"
               "(img, H, W, blur);\n  return (int)cudaGetLastError();\n")
BLUR_PLAN_SRC = r"""// blur7 with BC columns a lane (the first and last BHL lanes hold the 3-px
// halo), BRW rows a warp and BNW warps a block. With BVEC (BC = 4, BRW a
// multiple of 4) one 16-byte load a row on the input's 16-byte grid: the
// groups of row y start s = (y W) & 3 columns before the lane's own (x0 is
// a multiple of 4), so lane l takes the last s cells of its columns from
// lane l + 1 by __shfl_down_sync (lane 31 loads them); the blocks start at
// rows that are multiples of 4, so with W & 3 a template argument every
// row's s is a constant. Its stores are 16-byte groups on the output's grid
// (lane l writes the group that starts s columns before its own, taking
// those s cells from lane l - 1), a group cut by the strip's end cell by
// cell. Else every cell is loaded and stored alone.
@PLAN@
constexpr int BHL = (3 + BC - 1) / BC;  // halo lanes on each side
constexpr int BSW = BC * (32 - 2 * BHL), BTH = BNW * BRW;
static_assert(!BVEC || (BC == 4 && BRW % 4 == 0), "16-byte groups");

// cell (y, x), zero outside the image (EDGE: tested)
template <bool EDGE>
__device__ __forceinline__ float load1(const float* img, int y, int x, int H,
                                       int W) {
  if constexpr (!EDGE) return __ldg(img + (size_t)y * W + x);
  return (y >= 0 && y < H && x >= 0 && x < W) ? __ldg(img + (size_t)y * W + x)
                                              : 0.f;
}

// cells (y, c .. c+3), c on the row's 16-byte grid
template <bool EDGE>
__device__ __forceinline__ void load4(const float* img, int y, int c, int H,
                                      int W, float* v) {
  if (!EDGE || (y >= 0 && y < H && c >= 0 && c + 4 <= W)) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(img + (size_t)y * W + c));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = load1<true>(img, y, c + j, H, W);
  }
}

// the value of column `j` (-3 .. BC + 2) of the lane's row of vertical sums
// v: its own or a neighbour's by shuffle
__device__ __forceinline__ float lane_col(const float* v, int j) {
  const unsigned full = 0xffffffffu;
  const int d = j >= 0 ? j / BC : -((BC - 1 - j) / BC);  // lane offset
  const int e = j - d * BC;
  if (d < 0) return __shfl_up_sync(full, v[e], -d);
  if (d > 0) return __shfl_down_sync(full, v[e], d);
  return v[e];
}

// One warp's strip: columns x0 .. x0 + BSW - 1, rows y0 .. y0 + BRW - 1
template <int W3, bool EDGE>
__device__ __forceinline__ void blur7_warp(const float* __restrict__ img,
                                           int H, int W,
                                           float* __restrict__ blur_out,
                                           int x0, int y0, int lane) {
  constexpr int NR = BRW + 6;  // rows a lane loads
  const unsigned full = 0xffffffffu;
  const int xl = x0 + BC * (lane - BHL);  // the lane's first column

  // a[r]: row y0 - 3 + r, columns xl .. xl + BC - 1
  float a[NR][BC];
  if constexpr (BVEC) {
    float raw[NR][4], ex[NR][3];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int s = ((r + 1) * W3) & 3;  // ((y0 - 3 + r) W) & 3
      const int y = y0 - 3 + r;
      load4<EDGE>(img, y, xl - s, H, W, raw[r]);
#pragma unroll
      for (int j = 0; j < 3; ++j)
        ex[r][j] = (j < s && lane == 31) ? load1<EDGE>(img, y, xl + 4 - s + j, H, W)
                                         : 0.f;
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int s = ((r + 1) * W3) & 3;
      float nx[3];  // the next lane's first s cells (lane 31: its own loads)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j < s) {
          const float n = __shfl_down_sync(full, raw[r][j], 1);
          nx[j] = lane == 31 ? ex[r][j] : n;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) a[r][q] = q + s < 4 ? raw[r][q + s] : nx[q + s - 4];
    }
  } else {
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int q = 0; q < BC; ++q)
        a[r][q] = load1<EDGE>(img, y0 - 3 + r, xl + q, H, W);
  }

  const int xe = EDGE ? min(x0 + BSW, W) : x0 + BSW;
#pragma unroll
  for (int i = 0; i < BRW; ++i) {
    // vertical pass, in the plain version's order: 0 + t0 a0 + t1 a1 + ...
    float v[BC];
#pragma unroll
    for (int q = 0; q < BC; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 7; ++k) acc += c_taps[k] * a[i + k][q];
      v[q] = acc;
    }
    // horizontal pass over columns xl - 3 .. xl + BC + 2
    float w[BC + 6];
#pragma unroll
    for (int j = 0; j < BC + 6; ++j) w[j] = lane_col(v, j - 3);
    float o[BC];
#pragma unroll
    for (int q = 0; q < BC; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 7; ++k) acc += c_taps[k] * w[q + k];
      o[q] = acc;
    }
    const int y = y0 + i;
    if constexpr (BVEC) {
      // the group from xl - s on the output's 16-byte grid
      const int s = (i * W3) & 3;  // ((y0 + i) W) & 3
      float pv[3];  // the previous lane's last s outputs
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (j < s) pv[j] = __shfl_up_sync(full, o[4 - s + j], 1);
      if (EDGE && y >= H) continue;
      float* row = blur_out + (size_t)y * W;
      const int xs = xl - s;
      float g[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) g[j] = j >= s ? o[j - s] : pv[j];
      if (xs >= x0 && xs + 4 <= xe) {
        *reinterpret_cast<float4*>(row + xs) = make_float4(g[0], g[1], g[2], g[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (xs + j >= x0 && xs + j < xe) row[xs + j] = g[j];
      }
    } else {
      if (EDGE && y >= H) continue;
#pragma unroll
      for (int q = 0; q < BC; ++q)
        if (xl + q >= x0 && xl + q < xe) blur_out[(size_t)y * W + xl + q] = o[q];
    }
  }
}

template <int W3>
__global__ void __launch_bounds__(32 * BNW)
blur7_kernel(const float* __restrict__ img, int H, int W,
             float* __restrict__ blur_out) {
  const int x0 = blockIdx.x * BSW, yb = blockIdx.y * BTH;
  const int y0 = yb + (threadIdx.x >> 5) * BRW, lane = threadIdx.x & 31;
  // the block's loads: columns from x0 - BC BHL - 3, to x0 + BSW + BC BHL
  // + 3 with lane 31's; rows yb - 3 .. yb + BTH + 2
  const bool edge = x0 < BC * BHL + 4 || x0 + BSW + BC * BHL + 4 > W ||
                    yb < 3 || yb + BTH + 3 > H;
  if (edge)
    blur7_warp<W3, true>(img, H, W, blur_out, x0, y0, lane);
  else
    blur7_warp<W3, false>(img, H, W, blur_out, x0, y0, lane);
}

int blur7_plan_launch(const float* img, int H, int W, float* blur,
                      cudaStream_t st) {
  // BVEC's 16-byte group loads and stores
  if (BVEC && (((uintptr_t)img | (uintptr_t)blur) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid((W + BSW - 1) / BSW, (H + BTH - 1) / BTH);
  switch (W & 3) {
    case 0: blur7_kernel<0><<<grid, 32 * BNW, 0, st>>>(img, H, W, blur); break;
    case 1: blur7_kernel<1><<<grid, 32 * BNW, 0, st>>>(img, H, W, blur); break;
    case 2: blur7_kernel<2><<<grid, 32 * BNW, 0, st>>>(img, H, W, blur); break;
    default: blur7_kernel<3><<<grid, 32 * BNW, 0, st>>>(img, H, W, blur);
  }
  return (int)cudaGetLastError();
}

"""


def _blur_edits(c, r, n, vec):
    if c == 1 and not vec:
        return [(BLUR_ROWS_WARPS, f"constexpr int BRW = {r}, BNW = {n};")]
    plan = (f"constexpr int BC = {c}, BRW = {r}, BNW = {n};\n"
            f"constexpr bool BVEC = {str(vec).lower()};")
    return [(BLUR_KERNEL, BLUR_PLAN_SRC.replace("@PLAN@", plan)),
            (BLUR_LAUNCH, "  return blur7_plan_launch(img, H, W, blur, "
                          "(cudaStream_t)stream);\n")]


def _blur_name(c, r, n, vec):
    return f"blur_c{c}_r{r}_w{n}" + ("_vec" if vec else "")


M01_ADD = ("          m[k][j] = __fmaf_rn((float)d, row[j + u + 1] - row[j - u], "
           "m[k][j]);\n")
M10_ADD = ("          m[k][j] = __fmaf_rn((float)d, col[(k + u + 1) * VP] - "
           "col[(k - u) * VP],\n                              m[k][j]);\n")
EDITS = dict(
    no_score=[(SCORE_CALL, CENTRE)],
    no_early_out=[(ARC_TEST, "              x < W - BORDER;")],
    mom_no_gather=[(GATHER, GATHER + "  return;\n")],
    no_moments=[(MOM_BRANCH, "    if (tid < NM) {\n    } else if (tid < NS) {\n")],
    no_m01=[(M01_ADD, "          ;\n")],
    no_m10=[(M10_ADD, "          ;\n")],
    stage_only=[(TILE_BODY, TILE_BODY + "  if (n > 0) return;\n")],
    mom_384=[(MOM_THREADS, "constexpr int NTM = 384;"),
             (MOM_ROWS, "constexpr int MC = 3, MK = 8;"),
             (MOM_WARPS, "constexpr int NM = 128;")],
    **{f"lite_{w}x{h}": [(LITE_TILE, f"constexpr int LTW = {w}, LTH = {h};")]
       for w, h in LITE_TILES},
    **{_blur_name(*p): _blur_edits(*p) for p in BLUR_PLANS})


def variant(src: str, name: str) -> str:
    """The source of a variant: "full", a name of EDITS, or names joined
    by "+" (their edits one after another)."""
    if name == "full":
        return src
    for part in name.split("+"):
        for old, new in EDITS[part]:
            if isinstance(old, re.Pattern):  # a region, replaced as it is
                src, n = old.subn(lambda m: new, src)
            else:
                n = src.count(old)
                src = src.replace(old, new)
            if n == 0:
                raise ValueError(f"{name}: the source no longer holds {old!r}")
    return src


def variants(src: str) -> dict:
    """{name: source} of "full" and every single edit."""
    return {name: variant(src, name) for name in ("full", *EDITS)}


def build(sources: dict) -> dict:
    """Compile each variant in parallel; {name: (library, ptxas lines)}."""
    out_dir = cuda_lib.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, text = item
        src = out_dir / f"level_{name}.cu"
        src.write_text(text)
        lib = out_dir / f"liblevel_{name}.so"
        proc = subprocess.run(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(lib), str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        info = [l.strip() for l in (proc.stdout + proc.stderr).splitlines()
                if "registers" in l or "spill" in l]
        return name, (lib, info)

    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(one, sources.items()))


def _calls(lib, img):
    """The four launches of one library on `img`, each returning its
    outputs as fast_nms / frontend_pass_lite / frontend_pass do (blur7 as
    a 1-tuple)."""
    H, W = img.shape
    dev = img.device
    stream = cuda_lib.stream_handle(dev)

    def maps(n):
        return [torch.empty((H, W), dtype=torch.float32, device=dev)
                for _ in range(n)]

    def keep():
        return torch.empty((H, W), dtype=torch.bool, device=dev)

    def fast_nms():
        score, k = maps(1)[0], keep()
        cuda_lib.check(lib.fast_nms_level_launch(
            cuda_lib.ptr(img), H, W, cuda_lib.ptr(score), cuda_lib.ptr(k),
            stream), "fast_nms")
        return score, k

    def frontend(with_moments):
        score, blur, m01, m10 = maps(4)
        k = keep()
        cuda_lib.check(lib.frontend_level_launch(
            cuda_lib.ptr(img), H, W, int(with_moments), cuda_lib.ptr(score),
            cuda_lib.ptr(k), cuda_lib.ptr(m01), cuda_lib.ptr(m10),
            cuda_lib.ptr(blur), stream), "frontend")
        if with_moments:
            return score, k, m01, m10, blur
        return score, k, blur

    def blur7():
        out = maps(1)[0]
        cuda_lib.check(lib.blur7_level_launch(
            cuda_lib.ptr(img), H, W, cuda_lib.ptr(out), stream), "blur7")
        return (out,)

    return dict(fast_nms=fast_nms,
                frontend_pass_lite=lambda: frontend(False),
                frontend_pass=lambda: frontend(True), blur7=blur7)


KERNEL_NAMES = dict(fast_nms="level_kernel", frontend_pass_lite="level_kernel",
                    frontend_pass="level_kernel", blur7="blur7_kernel")


def _equal_to_mirror(name, got, img) -> bool:
    want = getattr(fl, f"{name}_zero")(img)
    if name == "blur7":
        return torch.equal(got[0], want)
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.bool:
            if not torch.equal(g, w):
                return False
            continue
        rtol, atol = ((2e-4, 2.0) if name == "frontend_pass" and i in (2, 3)
                      else (1e-5, 1e-3))
        if not bool(((g - w).abs() <= atol + rtol * w.abs()).all()):
            return False
    return True


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["752x480", "1241x376"])
    ap.add_argument("--levels", default="0", choices=("all", "0"))
    ap.add_argument("--variants", nargs="+", default=None)
    ap.add_argument("--kernels", nargs="+", default=list(KERNEL_NAMES),
                    choices=list(KERNEL_NAMES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("times the card: no CUDA device is available")
    src = (cuda_lib.CSRC / "frontend_level.cu").read_text()
    sources = ({k: variant(src, k) for k in args.variants} if args.variants
               else variants(src))
    libs = build(sources)
    dev = torch.device("cuda", 0)
    for shape, (level, img) in [(shape, li) for shape in args.shapes
                                for li in level_inputs(shape, args.levels,
                                                       dev)]:
        for name, (path, info) in libs.items():
            lib = ctypes.CDLL(str(path))
            for fn, (restype, argtypes) in fl._SIGNATURES.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            row = dict(variant=name, shape=shape, level=level,
                       ptxas=[re.sub(r"\s+", " ", l) for l in info])
            calls = _calls(lib, img)
            for kernel in args.kernels:
                call = calls[kernel]
                us, ops = device_events(call, (KERNEL_NAMES[kernel],),
                                        calls=50)
                row[kernel] = dict(
                    device_us=None if us is None else us * 1e3,
                    mirror=_equal_to_mirror(kernel, call(), img))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
