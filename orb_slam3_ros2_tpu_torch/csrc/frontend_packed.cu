// Packed-pyramid frontend: FAST-9 score, per-level interior mask, 3x3 NMS
// with raster tie-break, 7x7 sigma=2 blur and a raw echo, for every pixel
// of the canvas that stacks all pyramid levels (one launch per frame).
//
// Replaces the TPU kernel `_make_frontend_kernel_packed` /
// `frontend_pass_packed` in orb_slam3_ros2_tpu/ops/pallas_kernels.py.
//
// What bounds it on the H100: memory traffic and launch latency. At 752x480
// over 8 levels the canvas is 2304 x 752 f32 (6.9 MB read, 4 outputs
// written: ~24 MB), about 7 us of HBM time at 3.35 TB/s; the arithmetic
// (~300 min/max/sub per pixel for the score) is ~0.5 GFLOP, well under the
// card's f32 rate. The design reads every input pixel once: each block
// stages a 16x32 output tile plus a 4-px halo (FAST ring 3 + NMS 1) in
// shared memory, computes the score on the tile plus a 1-px ring so that
// NMS reads its neighbours from shared memory, and does the separable blur
// from the same staged tile. Reads outside the canvas are 0, as in the TPU
// kernel's zero-padded canvas; gap rows get score 0 from the layout mask.
#include <cuda_runtime.h>
#include <stdint.h>

#define TW 32
#define TH 16
#define HALO 4
#define MAX_LEVELS 16

struct Params {
  int n_levels;
  int r0[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  float taps[7];
};

__constant__ int c_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                             3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                             0, -1, -2, -3, -3, -3, -2, -1};

// Interior of the level that owns canvas row gy: >= 3 px from its edges.
__device__ __forceinline__ bool interior(const Params& p, int gy, int gx) {
  for (int l = 0; l < p.n_levels; ++l) {
    int y = gy - p.r0[l];
    if (y >= 0 && y < p.h[l])
      return y >= 3 && y < p.h[l] - 3 && gx >= 3 && gx < p.w[l] - 3;
  }
  return false;
}

__global__ void __launch_bounds__(256)
frontend_packed_kernel(const float* __restrict__ canvas, int rows, int W,
                       Params p, float* __restrict__ score_out,
                       uint8_t* __restrict__ keep_out,
                       float* __restrict__ blur_out,
                       float* __restrict__ raw_out) {
  __shared__ float s_img[TH + 2 * HALO][TW + 2 * HALO];
  __shared__ float s_sc[TH + 2][TW + 2];
  __shared__ float s_v[TH][TW + 6];

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  for (int i = tid; i < (TH + 2 * HALO) * (TW + 2 * HALO); i += nthr) {
    int ly = i / (TW + 2 * HALO), lx = i % (TW + 2 * HALO);
    int gy = y0 - HALO + ly, gx = x0 - HALO + lx;
    s_img[ly][lx] = (gy >= 0 && gy < rows && gx >= 0 && gx < W)
                        ? canvas[(size_t)gy * W + gx] : 0.f;
  }
  __syncthreads();

  // FAST-9 score on the tile plus a 1-px ring (NMS neighbourhood).
  for (int i = tid; i < (TH + 2) * (TW + 2); i += nthr) {
    int ly = i / (TW + 2), lx = i % (TW + 2);
    int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    float s = 0.f;
    if (interior(p, gy, gx)) {
      int cy = ly + HALO - 1, cx = lx + HALO - 1;
      float c = s_img[cy][cx];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = s_img[cy + c_dy[k]][cx + c_dx[k]] - c;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float mn = d[k], mx = d[k];
#pragma unroll
        for (int j = 1; j < 9; ++j) {
          mn = fminf(mn, d[(k + j) & 15]);
          mx = fmaxf(mx, d[(k + j) & 15]);
        }
        // bright arc: min d > t; dark arc: -max d > t; score >= 0
        s = fmaxf(s, fmaxf(mn, -mx));
      }
    }
    s_sc[ly][lx] = s;
  }

  // vertical blur pass: output rows of the tile, columns x0-3 .. x0+TW+2
  for (int i = tid; i < TH * (TW + 6); i += nthr) {
    int ly = i / (TW + 6), lx = i % (TW + 6);
    float v = 0.f;
#pragma unroll
    for (int t = 0; t < 7; ++t)
      v += p.taps[t] * s_img[ly + HALO - 3 + t][lx + HALO - 3];
    s_v[ly][lx] = v;
  }
  __syncthreads();

  for (int i = tid; i < TH * TW; i += nthr) {
    int ly = i / TW, lx = i % TW;
    int gy = y0 + ly, gx = x0 + lx;
    if (gy >= rows || gx >= W) continue;
    float c = s_sc[ly + 1][lx + 1];
    // raster tie-break: strict against earlier neighbours, >= later ones
    bool keep = c > s_sc[ly][lx] && c > s_sc[ly][lx + 1] &&
                c > s_sc[ly][lx + 2] && c > s_sc[ly + 1][lx] &&
                c >= s_sc[ly + 1][lx + 2] && c >= s_sc[ly + 2][lx] &&
                c >= s_sc[ly + 2][lx + 1] && c >= s_sc[ly + 2][lx + 2];
    float b = 0.f;
#pragma unroll
    for (int t = 0; t < 7; ++t) b += p.taps[t] * s_v[ly][lx + t];
    size_t o = (size_t)gy * W + gx;
    score_out[o] = c;
    keep_out[o] = keep ? 1 : 0;
    blur_out[o] = b;
    raw_out[o] = s_img[ly + HALO][lx + HALO];
  }
}

extern "C" int frontend_packed_launch(const float* canvas, int rows, int W,
                                      int n_levels, const int* layout,
                                      const float* taps, float* score,
                                      uint8_t* keep, float* blur, float* raw,
                                      void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Params p;
  p.n_levels = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    p.r0[l] = layout[3 * l];
    p.h[l] = layout[3 * l + 1];
    p.w[l] = layout[3 * l + 2];
  }
  for (int t = 0; t < 7; ++t) p.taps[t] = taps[t];
  dim3 block(32, 8);
  dim3 grid((W + TW - 1) / TW, (rows + TH - 1) / TH);
  frontend_packed_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      canvas, rows, W, p, score, keep, blur, raw);
  return (int)cudaGetLastError();
}
