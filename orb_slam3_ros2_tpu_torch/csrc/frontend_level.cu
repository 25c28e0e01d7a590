// Per-level frontend: FAST-9 score with 3x3 NMS (raster tie-break), the
// 7x7 sigma=2 blur, and the intensity-centroid moment maps m01/m10 over the
// radius-15 disc, for one pyramid level (one launch per call).
//
// Replaces the TPU kernels of orb_slam3_ros2_tpu/ops/pallas_kernels.py:
//   _fast_nms_call  (fast_nms, :161)              -> level_kernel<false, false>
//   _frontend_call  (frontend_pass_lite, :340)    -> level_kernel<true, false>
//   _frontend_call  (frontend_pass, :340)         -> level_kernel<true, true>
//   _blur_call      (blur7, :182)                 -> blur7_kernel
// with the Pallas kernels' semantics on the whole image: zero padding, score
// 0 outside the interior (>= 3 px from the edges), NMS against 0 outside.
//
// What bounds it on the H100: by the roofline, bytes (a 480x752 level is
// 1.4 MB in; fast_nms writes 5 B a pixel, the full pass 17 B: 0.97 / 2.26
// us at 3.35 TB/s). In practice each block runs its phases (stage, score,
// NMS and blur, store) between barriers, and a level's 240-360 blocks all
// run at once, so each phase's latency shows: staging alone takes 1.87 us
// of fast_nms' 6.3 at 752x480 (NVIDIA H100 80GB HBM3, 700.00 W;
// tools/level_ablation.py). With the moment maps, shared memory: ~60 loads
// a pixel for the gather plus the prefix sums, beside the score warps'.
// blur7 moves 8 B a pixel (0.86 us at 752x480); a level that small is too
// little to keep the memory busy across one load's latency, so its time is
// the launch, one exposed load latency and the serial work after it.
//
// What the design does about it:
// - Tiles: 64x16 outputs for fast_nms and the lite pass (360 blocks of 256
//   threads at 752x480), 96x16 with the moment maps (240 blocks of 512
//   threads, 99.5 KB of dynamic shared memory: two a SM, one wave on 132
//   SMs; 1241x376's level 0 needs 312, 1.18 waves). A thread's staging
//   loads are all issued before any is stored.
// - The FAST score is the packed kernel's (csrc/frontend_packed.cu): the
//   windowed min/max on order-preserving integer keys with Hopper's 3-input
//   DPX min/max, bit-identical to the plain score. A pixel gets it only if
//   two compass points 4 apart are both brighter (or both darker) than the
//   centre, which every 9-arc implies; the cells that pass are listed in
//   shared memory (one atomic a warp) and scored after a barrier, so the
//   min/max runs on the listed cells alone, not on every warp that holds
//   one.
// - Stores go in groups of 4 cells on the output's 16-byte grid (float4
//   score and blur, uchar4 keep); a group cut by the tile's or the row's
//   edge is written cell by cell. Level widths are not multiples of 4.
// - The moment maps take their own warps: warps 0-3 build the row prefix
//   sums S (one thread a row) and gather m01 = sum_d d * (S range of width
//   2u(d)+1 in the row at +d); warps 4-7 the column prefix sums V and m10
//   the same with columns. A walker loads a chunk of its row or column
//   before it adds, and each gather thread owns 3 adjacent columns x 4 rows
//   of outputs, walking each row (column) once so that one load serves
//   every output that reads it: ~60 shared loads a pixel for both maps
//   against 124 for one output a thread, on 32 distinct banks (3 columns a
//   lane). Warps 8-15 meanwhile score, NMS and blur the tile, synchronised
//   among themselves by a named barrier.
// - Precision: the sums stay f32 with no tensor cores. The prefix sums are
//   of I - 128 (the disc is symmetric, so a constant shift of every disc
//   pixel, padding included, changes neither moment) and the weights are
//   the small dy / dx of each range, so no large x-weighted prefix cancels.
// - The blur taps are compiled in (c_taps, the f32 values of
//   ops/pyramid.py _gauss_kernel1d(7, 2.0)), summed in the plain version's
//   order; the library is built with --fmad=false, so the blur is
//   bit-identical to the plain zero-padded blur.
// - blur7 (blur7_kernel, below) takes no barrier and no shared memory:
//   a warp loads its column strip into registers, all rows at once, and
//   takes the horizontal pass's neighbours from the lanes beside it by
//   shuffles.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// output tiles of a block: with the moment maps (MTW x MTH) and without
constexpr int MTW = 96, MTH = 16;
constexpr int LTW = 64, LTH = 16;
constexpr int NT = 256;    // threads a block without the moment maps
constexpr int NTM = 512;   // threads a block with them
constexpr int BORDER = 3;  // FAST interior margin
constexpr int R = 15;      // moment disc radius
constexpr int NM = 256;        // moment threads (warps 0-7)
constexpr int NS = NM / 2;     // of which m01 (warps 0-3) and m10 (4-7)
constexpr int MC = 3, MK = 4;  // outputs a moment thread: 3 cols x 4 rows
static_assert(MC * 32 == MTW && MK * (NS / 32) == MTH, "moment tiling");
// moment staging: the tile and a 15-px halo, odd pitch for the row walkers
constexpr int MH = MTH + 2 * R, MW = MTW + 2 * R;
constexpr int MP = MW + 1;  // s_img / S pitch (S has MW+1 entries a row)
constexpr int VP = MW;      // V pitch (MH+1 rows)
static_assert(MP % 2 == 1, "row walkers need an odd pitch");

// Shared memory of a TW x TH tile, in 4-byte words: keys of the tile and a
// 4-px halo, the score of the tile and a 1-px ring (columns at +3), the
// vertical blur (columns -3 .. TW+2 at +3), the list of cells to score and
// its length, then the staged pixels (the 4-px halo region, or with MOM
// the 15-px one) and the prefix sums.
template <int TW, int TH>
struct Tile {
  static constexpr int NG = TW / 4 + 1;  // 16-byte groups a tile row touches
  static constexpr int KH = TH + 8, KW = TW + 8;
  static constexpr int SCW = TW + 8, SVW = TW + 12;
  static constexpr int NPIX = (TH + 2) * (TW + 2);  // scored cells
  static constexpr int OFF_SC = KH * KW;
  static constexpr int OFF_V = OFF_SC + (TH + 2) * SCW;
  static constexpr int OFF_L = OFF_V + TH * SVW;  // cells to score, count
  static constexpr int OFF_F = OFF_L + NPIX + 1;
  static constexpr int LITE_BYTES = (OFF_F + KH * KW) * 4;
  static constexpr int OFF_S = OFF_F + MH * MP;
  static constexpr int OFF_VS = OFF_S + MH * MP;
  static constexpr int MOM_BYTES = (OFF_VS + (MH + 1) * VP) * 4;
};

// f32 values of ops/pyramid.py _gauss_kernel1d(7, 2.0)
__constant__ float c_taps[7] = {0x1.1f5f62p-4f, 0x1.0c70fcp-3f, 0x1.869472p-3f,
                                0x1.ba95c0p-3f, 0x1.869472p-3f, 0x1.0c70fcp-3f,
                                0x1.1f5f62p-4f};

// u(d) = floor(sqrt(15^2 - d^2)): the disc's half-width at row offset d
__host__ __device__ constexpr int disc_u(int d) {
  return d == 0 ? 15 : d <= 5 ? 14 : d <= 7 ? 13 : d <= 9 ? 12 : d == 10 ? 11
       : d == 11 ? 10 : d == 12 ? 9 : d == 13 ? 7 : d == 14 ? 5 : 0;
}

// Order-preserving integer key of a float's bits (an involution): signed
// integer order of keys is the float order, with -0 just below +0.
__device__ __forceinline__ int key_of(int bits) {
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

// FAST-9 score at (cy, cx) of the keys k (row pitch P): the largest t for
// which 9 contiguous ring samples are all brighter than c + t or all darker
// than c - t (csrc/frontend_packed.cu fast_score).
template <int P>
__device__ __forceinline__ float fast_score(const int* k, int cy, int cx) {
  const int* q = k + cy * P + cx;
  // Bresenham circle of radius 3, clockwise from 12 o'clock (ops/fast.py)
  const int p[16] = {q[-3 * P],     q[-3 * P + 1], q[-2 * P + 2], q[-P + 3],
                     q[3],          q[P + 3],      q[2 * P + 2],  q[3 * P + 1],
                     q[3 * P],      q[3 * P - 1],  q[2 * P - 2],  q[P - 3],
                     q[-3],         q[-P - 3],     q[-2 * P - 2], q[-3 * P - 1]};
  const float c = __int_as_float(key_of(q[0]));
  int lo[16], hi[16];  // min / max of the arc of 3 from j
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    lo[j] = __vimin3_s32(p[j], p[(j + 1) & 15], p[(j + 2) & 15]);
    hi[j] = __vimax3_s32(p[j], p[(j + 1) & 15], p[(j + 2) & 15]);
  }
  // a: max over the 16 arcs of 9 of their min; b: min of their max
  int a = INT32_MIN, b = INT32_MAX;
#pragma unroll
  for (int j = 0; j < 16; j += 2) {
    const int j1 = j + 1;
    a = __vimax3_s32(
        a, __vimin3_s32(lo[j], lo[(j + 3) & 15], lo[(j + 6) & 15]),
        __vimin3_s32(lo[j1], lo[(j1 + 3) & 15], lo[(j1 + 6) & 15]));
    b = __vimin3_s32(
        b, __vimax3_s32(hi[j], hi[(j + 3) & 15], hi[(j + 6) & 15]),
        __vimax3_s32(hi[j1], hi[(j1 + 3) & 15], hi[(j1 + 6) & 15]));
  }
  // bright arc: a - c; dark arc: c - b; the score is >= 0
  return fmaxf(fmaxf(__int_as_float(key_of(a)) - c,
                     c - __int_as_float(key_of(b))), 0.f);
}

// Whether a 9-arc of the ring at (cy, cx) can be all brighter or all
// darker than the centre: a necessary condition for a score above 0 (keys
// order as the floats do, -0 just below +0, so the test passes wherever
// the float comparisons would).
template <int P>
__device__ __forceinline__ bool arc_possible(const int* k, int cy, int cx) {
  const int* q = k + cy * P + cx;
  const int c = q[0];
  const bool n = q[-3 * P] > c, e = q[3] > c, s = q[3 * P] > c, w = q[-3] > c;
  const bool dn = q[-3 * P] < c, de = q[3] < c, ds = q[3 * P] < c,
             dw = q[-3] < c;
  return (n && e) || (e && s) || (s && w) || (w && n) || (dn && de) ||
         (de && ds) || (ds && dw) || (dw && dn);
}

__device__ __forceinline__ void group_sync(int id, int n) {
  if (id == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Score, NMS and (BLUR) blur of the TW x TH tile at (x0, y0) by `n`
// threads (t is the thread's index among them; `bar` their barrier). `f`
// points at the staged pixel of tile cell (-4, -4), row pitch fp.
template <int TW, int TH, bool BLUR>
__device__ void score_tile(const int* s_key, float* s_sc, float* s_v,
                           int* s_list, const float* f, int fp, int x0,
                           int y0, int H, int W, int t, int n, int bar,
                           float* score_out, uint8_t* keep_out,
                           float* blur_out) {
  using T = Tile<TW, TH>;
  constexpr int SCW = T::SCW, SVW = T::SVW, NG = T::NG, NPIX = T::NPIX;
  int* s_count = s_list + NPIX;  // 0 on entry
  // FAST-9 score on the tile plus a 1-px ring (the NMS neighbourhood); 0
  // outside the interior (>= 3 px from the edges), and 0 where no 9-arc
  // can be brighter or darker than the centre: such an arc holds two
  // compass points 4 apart, so one of those pairs must be brighter
  // (darker) too. The cells that pass that test are listed (each warp
  // appends its own with one atomic) and scored after the barrier, so the
  // min/max runs on them alone.
  const int lane = t & 31;
  for (int base = t - lane; base < NPIX; base += n) {  // warp-uniform
    const int i = base + lane;
    bool maybe = false;
    if (i < NPIX) {
      const int ly = i / (TW + 2), lx = i - ly * (TW + 2);
      const int y = y0 - 1 + ly, x = x0 - 1 + lx;
      maybe = y >= BORDER && y < H - BORDER && x >= BORDER &&
              x < W - BORDER && arc_possible<T::KW>(s_key, ly + 3, lx + 3);
      s_sc[ly * SCW + lx + 3] = 0.f;
    }
    const unsigned m = __ballot_sync(0xffffffffu, maybe);
    if (m != 0u) {
      int pos = 0;
      if (lane == 0) pos = atomicAdd(s_count, __popc(m));
      pos = __shfl_sync(0xffffffffu, pos, 0);
      if (maybe) s_list[pos + __popc(m & ((1u << lane) - 1u))] = i;
    }
  }
  if constexpr (BLUR) {
    // vertical pass: the tile's rows, columns x0-3 .. x0+TW+2
    for (int i = t; i < TH * (TW + 6); i += n) {
      const int ly = i / (TW + 6), lx = i - ly * (TW + 6);
      const float* c = f + (ly + 1) * fp + lx + 1;
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < 7; ++k) v += c_taps[k] * c[k * fp];
      s_v[ly * SVW + lx + 3] = v;
    }
  }
  group_sync(bar, n);
  for (int e = t; e < *s_count; e += n) {
    const int i = s_list[e];
    const int ly = i / (TW + 2), lx = i - ly * (TW + 2);
    s_sc[ly * SCW + lx + 3] = fast_score<T::KW>(s_key, ly + 3, lx + 3);
  }
  group_sync(bar, n);

  // groups of 4 cells on the output's 16-byte grid; a thread's cells in
  // [x0, xe) are this tile's
  const int xe = min(x0 + TW, W);
  for (int g = t; g < TH * NG; g += n) {
    const int ly = g / NG, y = y0 + ly;
    if (y >= H) continue;
    const size_t row = (size_t)y * W;
    const int xs = x0 - (int)((row + x0) & 3) + 4 * (g - ly * NG);
    if (xs + 4 <= x0 || xs >= xe) continue;
    const int c0 = xs - x0;  // tile column of the first cell, -3 .. TW-1
    float sc[4], bl[4];
    uint8_t kp[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* n0 = s_sc + ly * SCW + c0 + j + 3;  // 3x3 neighbourhood
      const float* n1 = n0 + SCW;
      const float* n2 = n1 + SCW;
      const float c = n1[1];
      // raster tie-break: strict against earlier neighbours, >= later ones
      const bool keep = c > n0[0] && c > n0[1] && c > n0[2] && c > n1[0] &&
                        c >= n1[2] && c >= n2[0] && c >= n2[1] && c >= n2[2];
      sc[j] = c;
      kp[j] = keep ? 1 : 0;
      if constexpr (BLUR) {
        float bv = 0.f;
#pragma unroll
        for (int k = 0; k < 7; ++k) bv += c_taps[k] * s_v[ly * SVW + c0 + j + k + 3];
        bl[j] = bv;
      }
    }
    const size_t o = row + xs;
    if (xs >= x0 && xs + 4 <= xe) {
      *reinterpret_cast<float4*>(score_out + o) =
          make_float4(sc[0], sc[1], sc[2], sc[3]);
      *reinterpret_cast<uchar4*>(keep_out + o) =
          make_uchar4(kp[0], kp[1], kp[2], kp[3]);
      if constexpr (BLUR)
        *reinterpret_cast<float4*>(blur_out + o) =
            make_float4(bl[0], bl[1], bl[2], bl[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (xs + j >= x0 && xs + j < xe) {
          score_out[o + j] = sc[j];
          keep_out[o + j] = kp[j];
          if constexpr (BLUR) blur_out[o + j] = bl[j];
        }
      }
    }
  }
}

// One moment map of the tile by NS threads (t < NS): with ROWS the row
// prefix sums P[r][c] (pitch MP) of I - 128 over the staged tile (s_img,
// MH x MW at pitch MP), the sum of row r's columns < c, and m01 = sum_d d *
// (P range of width 2u(d)+1 in the row at +d); else the column prefix sums
// P[r][c] (pitch VP), the sum of column c's rows < r, and m10 the same
// with columns. A walker loads a chunk of its row (column) into registers
// before it adds, so the chunk's loads are in flight together. Each thread
// then gathers MC columns x MK rows of outputs, walking the rows (columns)
// of P once: a row's loads serve every output of the thread that reads it.
constexpr int SCHUNK = 14, VCHUNK = 23;
static_assert(MW % SCHUNK == 0 && MH % VCHUNK == 0, "walker chunks");

template <bool ROWS>
__device__ void moment_map(const float* __restrict__ s_img,
                           float* __restrict__ P, int x0, int y0, int H,
                           int W, int t, float* __restrict__ out) {
  if constexpr (ROWS) {
    if (t < MH) {  // one row a thread
      const float* in = s_img + t * MP;
      float* row = P + t * MP;
      float acc = 0.f;
      row[0] = 0.f;
      for (int c0 = 0; c0 < MW; c0 += SCHUNK) {
        float x[SCHUNK];
#pragma unroll
        for (int i = 0; i < SCHUNK; ++i) x[i] = in[c0 + i];
#pragma unroll
        for (int i = 0; i < SCHUNK; ++i) {
          acc += x[i] - 128.f;
          row[c0 + i + 1] = acc;
        }
      }
    }
  } else {
    for (int c = t; c < MW; c += NS) {  // one or two columns a thread
      float acc = 0.f;
      P[c] = 0.f;
      for (int r0 = 0; r0 < MH; r0 += VCHUNK) {
        float x[VCHUNK];
#pragma unroll
        for (int i = 0; i < VCHUNK; ++i) x[i] = s_img[(r0 + i) * MP + c];
#pragma unroll
        for (int i = 0; i < VCHUNK; ++i) {
          acc += x[i] - 128.f;
          P[(r0 + i + 1) * VP + c] = acc;
        }
      }
    }
  }
  group_sync(ROWS ? 1 : 3, NS);

  const int lane = t & 31, w = t >> 5;
  const int sy = MK * w + R, sx = MC * lane + R;  // staged coordinates
  float m[MK][MC];
#pragma unroll
  for (int k = 0; k < MK; ++k)
#pragma unroll
    for (int j = 0; j < MC; ++j) m[k][j] = 0.f;
  if constexpr (ROWS) {
    const float* Pb = P + sy * MP + sx;
#pragma unroll
    for (int r = -R; r < MK + R; ++r) {  // P row sy + r
      const float* row = Pb + r * MP;
#pragma unroll
      for (int k = 0; k < MK; ++k) {
        const int d = r - k;
        if (d == 0 || d < -R || d > R) continue;
        const int u = disc_u(d < 0 ? -d : d);
#pragma unroll
        for (int j = 0; j < MC; ++j)
          m[k][j] = __fmaf_rn((float)d, row[j + u + 1] - row[j - u], m[k][j]);
      }
    }
  } else {
    const float* Pb = P + sy * VP + sx;
#pragma unroll
    for (int c = -R; c < MC + R; ++c) {  // P column sx + c
      const float* col = Pb + c;
#pragma unroll
      for (int j = 0; j < MC; ++j) {
        const int d = c - j;
        if (d == 0 || d < -R || d > R) continue;
        const int u = disc_u(d < 0 ? -d : d);
#pragma unroll
        for (int k = 0; k < MK; ++k)
          m[k][j] = __fmaf_rn((float)d, col[(k + u + 1) * VP] - col[(k - u) * VP],
                              m[k][j]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < MK; ++k) {
    const int y = y0 + MK * w + k;
    if (y >= H) continue;
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      const int x = x0 + MC * lane + j;
      if (x < W) out[(size_t)y * W + x] = m[k][j];
    }
  }
}

// One output tile a block (MTW x MTH with MOM, LTW x LTH without).
// Without MOM all 256 threads score, NMS and blur the tile; with MOM warps
// 0-3 compute m01, warps 4-7 m10 and warps 8-15 the rest.
template <bool BLUR, bool MOM>
__global__ void __launch_bounds__(MOM ? NTM : NT, MOM ? 2 : 1)
level_kernel(const float* __restrict__ img, int H, int W,
             float* __restrict__ score_out, uint8_t* __restrict__ keep_out,
             float* __restrict__ blur_out, float* __restrict__ m01_out,
             float* __restrict__ m10_out) {
  constexpr int TW = MOM ? MTW : LTW, TH = MOM ? MTH : LTH;
  using T = Tile<TW, TH>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int* s_key = reinterpret_cast<int*>(smem);
  float* s_sc = smem + T::OFF_SC;
  float* s_v = smem + T::OFF_V;
  int* s_list = reinterpret_cast<int*>(smem + T::OFF_L);
  float* s_f = smem + T::OFF_F;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.x;
  if (tid == 0) s_list[T::NPIX] = 0;  // the list's length

  // the staged region: the tile and a 15-px halo with MOM (the keys of its
  // inner 4-px halo region beside it), else the tile and a 4-px halo; zero
  // outside the image. Unrolled, so a thread's loads are all in flight at
  // once.
  constexpr int SH = MOM ? MH : T::KH, SW = MOM ? MW : T::KW;
  constexpr int HALO = MOM ? R : 4, N = MOM ? NTM : NT;
  float v[(SH * SW + N - 1) / N];
#pragma unroll
  for (int k = 0; k < (SH * SW + N - 1) / N; ++k) {
    const int i = tid + k * N;
    const int ly = i / SW, lx = i - ly * SW;
    const int y = y0 - HALO + ly, x = x0 - HALO + lx;
    v[k] = (i < SH * SW && y >= 0 && y < H && x >= 0 && x < W)
               ? __ldg(img + (size_t)y * W + x) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < (SH * SW + N - 1) / N; ++k) {
    const int i = tid + k * N;
    if (i >= SH * SW) break;
    const int ly = i / SW, lx = i - ly * SW;
    if constexpr (MOM) {
      s_f[ly * MP + lx] = v[k];
      const int ky = ly - (R - 4), kx = lx - (R - 4);
      if (ky >= 0 && ky < T::KH && kx >= 0 && kx < T::KW)
        s_key[ky * T::KW + kx] = key_of(__float_as_int(v[k]));
    } else {
      s_key[i] = key_of(__float_as_int(v[k]));
      if constexpr (BLUR) s_f[i] = v[k];
    }
  }
  __syncthreads();

  if constexpr (MOM) {
    if (tid < NS) {
      moment_map<true>(s_f, smem + T::OFF_S, x0, y0, H, W, tid, m01_out);
    } else if (tid < NM) {
      moment_map<false>(s_f, smem + T::OFF_VS, x0, y0, H, W, tid - NS,
                        m10_out);
    } else {
      score_tile<TW, TH, BLUR>(s_key, s_sc, s_v, s_list,
                               s_f + (R - 4) * MP + (R - 4), MP, x0, y0, H,
                               W, tid - NM, NTM - NM, 2, score_out, keep_out,
                               blur_out);
    }
  } else {
    score_tile<TW, TH, BLUR>(s_key, s_sc, s_v, s_list, s_f, T::KW, x0, y0, H, W,
                             tid, NT, 0, score_out, keep_out, blur_out);
  }
}

// blur7: a warp owns a strip of BSW = 26 output columns and BRW rows, one
// column a lane; lanes 0-2 and 29-31 hold the 3-px halo on either side. A
// block stacks BNW warps down the strip (BTH rows). No shared memory and no
// barrier:
// - loads: a lane issues all BRW + 6 rows of its column before it uses any;
// - the vertical pass runs on those registers; the horizontal pass takes
//   the 3 vertical sums it needs on either side from the lanes beside it
//   by shuffles;
// - stores: each of lanes 3-28 its own cell of a row;
// - a block whose loads all fall inside the image (the interior) runs
//   without a bounds test; a block at the image's edge tests every load
//   and store and loads zero outside;
// - offsets are 32-bit: with 64-bit ones each warp's chain took ~0.3 us
//   more at every level size.
// The plan is chosen by measurement (tools/level_ablation.py, which also
// holds the variants with several columns a lane and with 16-byte loads
// and stores; NVIDIA H100 80GB HBM3, 700.00 W): 8 rows a warp, 2 warps a
// block (26x16 tiles, 870 blocks at 752x480): 2.45 us at 752x480's level
// 0, against 2.81-2.97 with 4 columns a lane and 3.03-3.33 with 16-byte
// groups; a lane's serial work (its outputs) sets the time of the small
// levels, and the bounds tests and the 16-byte realignment cost more than
// they save.
constexpr int BRW = 8, BNW = 2;
constexpr int BSW = 32 - 6, BTH = BNW * BRW;

// cell (y, x), zero outside the image (EDGE: tested); 32-bit offsets, as
// the launch admits fewer than 2^31 cells
template <bool EDGE>
__device__ __forceinline__ float load1(const float* img, int y, int x, int H,
                                       int W) {
  if constexpr (!EDGE) return __ldg(img + y * W + x);
  return (y >= 0 && y < H && x >= 0 && x < W) ? __ldg(img + y * W + x)
                                              : 0.f;
}

// One warp's strip: columns x0 .. x0 + BSW - 1, rows y0 .. y0 + BRW - 1
template <bool EDGE>
__device__ __forceinline__ void blur7_warp(const float* __restrict__ img,
                                           int H, int W,
                                           float* __restrict__ blur_out,
                                           int x0, int y0, int lane) {
  constexpr int NR = BRW + 6;  // rows a lane loads
  const unsigned full = 0xffffffffu;
  const int x = x0 + lane - 3;  // the lane's column
  const bool owner = lane >= 3 && lane < 3 + BSW && (!EDGE || x < W);

  float a[NR];  // a[r]: row y0 - 3 + r
#pragma unroll
  for (int r = 0; r < NR; ++r) a[r] = load1<EDGE>(img, y0 - 3 + r, x, H, W);

#pragma unroll
  for (int i = 0; i < BRW; ++i) {
    // vertical pass, in the plain version's order: 0 + t0 a0 + t1 a1 + ...
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < 7; ++k) v += c_taps[k] * a[i + k];
    // horizontal pass over columns x - 3 .. x + 3, from the lanes beside
    // (shuffled in the order the sum takes them)
    float w[7];
#pragma unroll
    for (int k = 0; k < 7; ++k)
      w[k] = k < 3   ? __shfl_up_sync(full, v, 3 - k)
             : k > 3 ? __shfl_down_sync(full, v, k - 3)
                     : v;
    float o = 0.f;
#pragma unroll
    for (int k = 0; k < 7; ++k) o += c_taps[k] * w[k];
    const int y = y0 + i;
    if (owner && (!EDGE || y < H)) blur_out[y * W + x] = o;
  }
}

__global__ void __launch_bounds__(32 * BNW)
blur7_kernel(const float* __restrict__ img, int H, int W,
             float* __restrict__ blur_out) {
  const int x0 = blockIdx.x * BSW, yb = blockIdx.y * BTH;
  const int y0 = yb + (threadIdx.x >> 5) * BRW, lane = threadIdx.x & 31;
  // the block's loads: columns x0 - 3 .. x0 + BSW + 2, rows yb - 3 ..
  // yb + BTH + 2
  const bool edge = x0 < 3 || x0 + BSW + 3 > W || yb < 3 || yb + BTH + 3 > H;
  if (edge)
    blur7_warp<true>(img, H, W, blur_out, x0, y0, lane);
  else
    blur7_warp<false>(img, H, W, blur_out, x0, y0, lane);
}

template <bool BLUR, bool MOM>
int launch_level(const float* img, int H, int W, float* score, uint8_t* keep,
                 float* blur, float* m01, float* m10, void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  // 16-byte group stores (torch allocations start on 256 bytes)
  if ((((uintptr_t)score | (uintptr_t)keep | (uintptr_t)blur) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  constexpr int TW = MOM ? MTW : LTW, TH = MOM ? MTH : LTH;
  constexpr int smem = MOM ? Tile<TW, TH>::MOM_BYTES : Tile<TW, TH>::LITE_BYTES;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        level_kernel<BLUR, MOM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  level_kernel<BLUR, MOM><<<grid, MOM ? NTM : NT, smem, (cudaStream_t)stream>>>(
      img, H, W, score, keep, blur, m01, m10);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fast_nms_level_launch(const float* img, int H, int W,
                                     float* score, uint8_t* keep,
                                     void* stream) {
  return launch_level<false, false>(img, H, W, score, keep, nullptr, nullptr,
                                    nullptr, stream);
}

extern "C" int blur7_level_launch(const float* img, int H, int W, float* blur,
                                  void* stream) {
  if (H < 1 || W < 1 || (long long)H * W > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + BSW - 1) / BSW, (H + BTH - 1) / BTH);
  blur7_kernel<<<grid, 32 * BNW, 0, (cudaStream_t)stream>>>(img, H, W, blur);
  return (int)cudaGetLastError();
}

extern "C" int frontend_level_launch(const float* img, int H, int W,
                                     int with_moments, float* score,
                                     uint8_t* keep, float* m01, float* m10,
                                     float* blur, void* stream) {
  if (with_moments)
    return launch_level<true, true>(img, H, W, score, keep, blur, m01, m10,
                                    stream);
  return launch_level<true, false>(img, H, W, score, keep, blur, nullptr,
                                   nullptr, stream);
}
