// Packed-pyramid frontend: FAST-9 score, per-level interior mask, 3x3 NMS
// with raster tie-break, 7x7 sigma=2 blur and a raw echo for every pyramid
// level, written into four canvases that stack the levels under
// `pack_layout` (one launch per extraction).
//
// Replaces the TPU kernel `_make_frontend_kernel_packed` /
// `_frontend_packed_call` / `frontend_pass_packed` in
// orb_slam3_ros2_tpu/ops/pallas_kernels.py:450-592.
//
// What bounds it on the H100: bytes, by the roofline. At 752x480 over 8
// levels it must read the 1,117,367 level pixels once (4.5 MB) and write
// the four (2304, 752) canvases once (f32 score, bool keep, f32 blur, f32
// raw: 13 B a cell, 22.5 MB): 27.0 MB, 8.1 us at 3.35 TB/s. The
// arithmetic, ~196 operations a level pixel (FAST 162, NMS 8, blur 26), is
// ~0.22 GFLOP, 3.3 us at the card's 67 TFLOP/s f32 rate. (1241x376:
// 35.2 MB, 10.5 us.) It runs at about a third of that bound (24.0 us at
// 752x480 and 32.1 us at 1241x376 on an H100 SXM at 700 W, PERF.md): with
// the score taken out it still takes 16.6 us, and the score adds 7.5 us
// that its barrier-separated phases (stage, score and blur, store) do not
// overlap with the memory traffic (tools/frontend_ablation.py).
//
// What the design does about it:
// - The levels are read in place. The TPU kernel needed one zero-gapped
//   canvas for its (8,128)-aligned bands; here each block stages its tile
//   plus a 4-px halo (FAST ring 3 + NMS 1) straight from the level's own
//   tensor, with zeros outside the level. That equals the TPU canvas,
//   because its gap (PACK_GAP = 8 rows) and the cells right of a narrower
//   level are zero and wider than the halo. The wrapper builds no canvas
//   and launches nothing but this kernel.
// - Blocks map to (level, tile) over the level regions only: a block finds
//   its level once from a prefix sum of the levels' tile counts, so the
//   interior test compares against block constants. The cells outside the
//   level regions (gap rows, the canvas right of a narrower level, the
//   rows below the last level) are written 0 / false by blocks of the same
//   launch that do nothing else, one warp a canvas row.
// - Staging uses coalesced plain loads, not TMA: a TMA tile needs a row
//   pitch that is a multiple of 16 bytes, and most level widths (627, 522,
//   435, 363, 302, 210 at 752 px) are not a multiple of 4 floats. Every
//   level pixel is read from device memory once (halo rereads hit L2).
//   (Double-buffering tiles with cp.async in persistent blocks was tried
//   and was slower, as were persistent blocks alone and 32-row tiles.)
// - The FAST score is the TPU kernel's windowed min/max (`win9`) on
//   order-preserving integer keys of the pixels (the float's bits with the
//   magnitude flipped for negatives), staged beside the pixels, so
//   Hopper's 3-input DPX min/max (__vimin3_s32) take arcs of 3, then arcs
//   of 9 from three of those: 80 operations a pixel where 2-input float
//   min/max take 158 (4.3 us less at 752x480). The centre is subtracted
//   once: rounding is monotone, so min(p_i - c) = min(p_i) - c bit for
//   bit, and the score equals the plain version's exactly.
// - The blur sums its taps in the plain version's order, and the library
//   is built with --fmad=false, so the blur is bit-identical on each
//   level's interior.
// - Each thread writes 4 neighbouring cells that lie on the canvas's own
//   16-byte grid, as 16-byte stores of the f32 canvases (4-byte for keep),
//   whatever the canvas width (1241 is not a multiple of 4); a group cut by
//   a tile's or a row's edge is written cell by cell.
#include <cuda_runtime.h>
#include <stdint.h>

#define TW 64   // tile width (columns of one level)
#define TH 16   // tile height
#define HALO 4  // FAST ring 3 + NMS 1
#define SW (TW + 2 * HALO)
#define SH (TH + 2 * HALO)
#define NG (TW / 4 + 1)  // 16-byte store groups a tile row can touch
#define ZR 8    // canvas rows per zero-fill block (one warp each)
#define NT 256  // threads per block
#define BORDER 3
#define MAX_LEVELS 16
#define TABLE_HEAD 9  // ints before the per-level entries of the table
#define TABLE_LEVEL 6 // ints per level entry

struct Level {
  const float* img;
  int r0, h, w, pitch, tiles_x, first;
};

struct Params {
  Level lv[MAX_LEVELS];
  int n_levels, rows, W, n_tiles, n_zero, zero_row0;
  float taps[7];
};

// Order-preserving integer key of a float's bits (an involution): signed
// integer order of keys is the float order, with -0 just below +0.
__device__ __forceinline__ int key_of(int bits) {
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

// FAST-9 score at (cy, cx) from the keys k and the centre value c: the
// largest t for which 9 contiguous ring samples are all brighter than
// c + t or all darker than c - t.
__device__ __forceinline__ float fast_score(const int (*k)[SW], float c,
                                            int cy, int cx) {
  // Bresenham circle of radius 3, clockwise from 12 o'clock (ops/fast.py)
  const int p[16] = {
      k[cy - 3][cx],     k[cy - 3][cx + 1], k[cy - 2][cx + 2],
      k[cy - 1][cx + 3], k[cy][cx + 3],     k[cy + 1][cx + 3],
      k[cy + 2][cx + 2], k[cy + 3][cx + 1], k[cy + 3][cx],
      k[cy + 3][cx - 1], k[cy + 2][cx - 2], k[cy + 1][cx - 3],
      k[cy][cx - 3],     k[cy - 1][cx - 3], k[cy - 2][cx - 2],
      k[cy - 3][cx - 1]};
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

// Zero the cells of canvas row r that lie outside every level: right of
// the level that owns the row, or the whole row in a gap.
__device__ void zero_row(const Params& p, int r, int lane, float* score,
                         uint8_t* keep, float* blur, float* raw) {
  int start = 0;
  for (int l = 0; l < p.n_levels; ++l)
    if (r >= p.lv[l].r0 && r < p.lv[l].r0 + p.lv[l].h) start = p.lv[l].w;
  const size_t o = (size_t)r * p.W;
  // [a, e): the cells on whole 16-byte groups; fewer than 4 cells lie in
  // [start, a) and in [e, W)
  const int a = min(start + (int)((4 - ((o + start) & 3)) & 3), p.W);
  const int e = a + ((p.W - a) & ~3);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int x = k == 0 ? start + lane : e + lane;
    if (x < (k == 0 ? a : p.W)) {
      score[o + x] = 0.f;
      keep[o + x] = 0;
      blur[o + x] = 0.f;
      raw[o + x] = 0.f;
    }
  }
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int x = a + 4 * lane; x < e; x += 128) {
    *reinterpret_cast<float4*>(score + o + x) = z;
    *reinterpret_cast<uchar4*>(keep + o + x) = make_uchar4(0, 0, 0, 0);
    *reinterpret_cast<float4*>(blur + o + x) = z;
    *reinterpret_cast<float4*>(raw + o + x) = z;
  }
}

// Score, NMS, blur and raw of tile t, written to the canvases.
__device__ void process_tile(const Params& p, int t, float* score_out,
                             uint8_t* keep_out, float* blur_out,
                             float* raw_out) {
  __shared__ float s_img[SH][SW];
  __shared__ int s_key[SH][SW];
  // score of tile columns -1 .. TW and vertical blur of columns -3 .. TW+2,
  // stored 3 columns in, so that a store group's cells (tile columns -3 ..
  // TW+2) read their neighbours without a clamp
  __shared__ float s_sc[TH + 2][TW + 8];
  __shared__ float s_v[TH][TW + 12];

  const int tid = threadIdx.x;
  int l = 0;
  while (l + 1 < p.n_levels && t >= p.lv[l + 1].first) ++l;
  const Level& L = p.lv[l];
  const int i_t = t - L.first;
  const int ty = i_t / L.tiles_x;
  const int y0 = ty * TH, x0 = (i_t - ty * L.tiles_x) * TW;
  const int h = L.h, w = L.w;

  // the tile and its halo, zero outside the level, and their keys
#pragma unroll
  for (int k = 0; k < (SH * SW + NT - 1) / NT; ++k) {
    const int i = tid + k * NT;
    if (i < SH * SW) {
      const int ly = i / SW, lx = i - ly * SW;
      const int y = y0 - HALO + ly, x = x0 - HALO + lx;
      const float v = (y >= 0 && y < h && x >= 0 && x < w)
                          ? __ldg(L.img + (size_t)y * L.pitch + x) : 0.f;
      s_img[ly][lx] = v;
      s_key[ly][lx] = key_of(__float_as_int(v));
    }
  }
  __syncthreads();

  // FAST-9 score on the tile plus a 1-px ring (the NMS neighbourhood); 0
  // outside the level's interior (>= 3 px from its edges)
  for (int i = tid; i < (TH + 2) * (TW + 2); i += NT) {
    const int ly = i / (TW + 2), lx = i - ly * (TW + 2);
    const int y = y0 - 1 + ly, x = x0 - 1 + lx;
    float s = 0.f;
    if (y >= BORDER && y < h - BORDER && x >= BORDER && x < w - BORDER) {
      const int cy = ly + HALO - 1, cx = lx + HALO - 1;
      s = fast_score(s_key, s_img[cy][cx], cy, cx);
    }
    s_sc[ly][lx + 3] = s;
  }
  // vertical blur pass: the tile's rows, columns x0-3 .. x0+TW+2
  for (int i = tid; i < TH * (TW + 6); i += NT) {
    const int ly = i / (TW + 6), lx = i - ly * (TW + 6);
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < 7; ++k)
      v += p.taps[k] * s_img[ly + HALO - 3 + k][lx + HALO - 3];
    s_v[ly][lx + 3] = v;
  }
  __syncthreads();

  // groups of 4 cells on the canvas's 16-byte grid; a thread's cells in
  // [x0, xe) are this tile's, and the cells of a whole group right of the
  // level are written 0
  const int xe = min(x0 + TW, w);
  for (int g = tid; g < TH * NG; g += NT) {
    const int ly = g / NG, y = y0 + ly;
    if (y >= h) continue;
    const size_t row = (size_t)(L.r0 + y) * p.W;
    const int xs = x0 - (int)((row + x0) & 3) + 4 * (g - ly * NG);
    if (xs + 4 <= x0 || xs >= xe) continue;
    const int c0 = xs - x0;  // tile column of the first cell, -3 .. TW-1
    float sc[4], bl[4], rw[4];
    uint8_t kp[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* n0 = &s_sc[ly][c0 + j + 3];  // the 3x3 neighbourhood
      const float* n1 = &s_sc[ly + 1][c0 + j + 3];
      const float* n2 = &s_sc[ly + 2][c0 + j + 3];
      const float c = n1[1];
      // raster tie-break: strict against earlier neighbours, >= later ones
      const bool keep = c > n0[0] && c > n0[1] && c > n0[2] && c > n1[0] &&
                        c >= n1[2] && c >= n2[0] && c >= n2[1] && c >= n2[2];
      float bv = 0.f;
#pragma unroll
      for (int k = 0; k < 7; ++k) bv += p.taps[k] * s_v[ly][c0 + j + k + 3];
      const bool in = xs + j >= x0 && xs + j < xe;
      sc[j] = in ? c : 0.f;
      kp[j] = in && keep ? 1 : 0;
      bl[j] = in ? bv : 0.f;
      rw[j] = in ? s_img[ly + HALO][c0 + j + HALO] : 0.f;
    }
    const size_t o = row + xs;
    if (xs >= x0 && xs + 4 <= x0 + TW && xs + 4 <= p.W) {
      *reinterpret_cast<float4*>(score_out + o) =
          make_float4(sc[0], sc[1], sc[2], sc[3]);
      *reinterpret_cast<uchar4*>(keep_out + o) =
          make_uchar4(kp[0], kp[1], kp[2], kp[3]);
      *reinterpret_cast<float4*>(blur_out + o) =
          make_float4(bl[0], bl[1], bl[2], bl[3]);
      *reinterpret_cast<float4*>(raw_out + o) =
          make_float4(rw[0], rw[1], rw[2], rw[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (xs + j >= x0 && xs + j < xe) {
          score_out[o + j] = sc[j];
          keep_out[o + j] = kp[j];
          blur_out[o + j] = bl[j];
          raw_out[o + j] = rw[j];
        }
      }
    }
  }
}

// Blocks 0 .. n_tiles-1 take one tile each; the others zero-fill ZR canvas
// rows each.
__global__ void __launch_bounds__(NT)
frontend_packed_kernel(const __grid_constant__ Params p,
                       float* __restrict__ score_out,
                       uint8_t* __restrict__ keep_out,
                       float* __restrict__ blur_out,
                       float* __restrict__ raw_out) {
  const int b = blockIdx.x;
  if (b < p.n_tiles) {
    process_tile(p, b, score_out, keep_out, blur_out, raw_out);
    return;
  }
  const int r = p.zero_row0 + (b - p.n_tiles) * ZR + (threadIdx.x >> 5);
  if (r < p.rows)
    zero_row(p, r, threadIdx.x & 31, score_out, keep_out, blur_out, raw_out);
}

// `table` is the launch plan of ops/frontend_packed.py `launch_plan`:
//   [TW, TH, ZR, n_levels, rows, W, n_tiles, n_zero, zero_row0]
//   then per level [r0, h, w, pitch, tiles_x, first_tile].
// `levels` holds each level's device pointer; `taps` the 7 blur taps. The
// canvases must start on 16 bytes (torch allocations do).
extern "C" int frontend_packed_launch(const int* table,
                                      const float* const* levels,
                                      const float* taps, float* score,
                                      uint8_t* keep, float* blur, float* raw,
                                      void* stream) {
  if (table[0] != TW || table[1] != TH || table[2] != ZR)
    return (int)cudaErrorInvalidValue;  // the plan was made for other tiles
  const int n = table[3];
  if (n < 1 || n > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)score | (uintptr_t)keep | (uintptr_t)blur |
        (uintptr_t)raw) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  Params p;
  p.n_levels = n;
  p.rows = table[4];
  p.W = table[5];
  p.n_tiles = table[6];
  p.n_zero = table[7];
  p.zero_row0 = table[8];
  for (int l = 0; l < n; ++l) {
    const int* e = table + TABLE_HEAD + TABLE_LEVEL * l;
    p.lv[l] = Level{levels[l], e[0], e[1], e[2], e[3], e[4], e[5]};
  }
  for (int k = 0; k < 7; ++k) p.taps[k] = taps[k];
  const int blocks = p.n_tiles + p.n_zero;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  frontend_packed_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
      p, score, keep, blur, raw);
  return (int)cudaGetLastError();
}
