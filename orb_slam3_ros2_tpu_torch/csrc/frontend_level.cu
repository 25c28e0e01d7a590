// Per-level frontend: FAST-9 score with 3x3 NMS (raster tie-break), the
// 7x7 sigma=2 blur, and the intensity-centroid moment maps m01/m10 over the
// radius-15 disc, for one pyramid level (one launch per call).
//
// Replaces the TPU kernels of orb_slam3_ros2_tpu/ops/pallas_kernels.py:
//   _fast_nms_call  (fast_nms)                          -> fast_nms_level_launch
//   _blur_call      (blur7)                             -> blur7_level_launch
//   _frontend_call  (frontend_pass / frontend_pass_lite) -> frontend_level_launch
//
// What bounds it on the H100: memory traffic and launch latency, as for the
// packed kernel (csrc/frontend_packed.cu). A 480x752 level is 1.4 MB in and
// at most 5 maps out (~8.7 MB), ~3 us of HBM time at 3.35 TB/s. The moment
// maps add 31 rows x 3 adds per pixel over prefix sums, still far under the
// card's f32 rate. Each block stages a 16x32 output tile plus a halo (4 px:
// FAST ring 3 + NMS 1; 16 px with moments: disc 15 + NMS 1) in shared
// memory, reading every input pixel of the tile once. The score is computed
// on a 1-px ring around the tile so NMS needs no other block. The moments
// are row prefix sums of the staged tile, then per output pixel the per-row
// [x-u, x+u] differences with u = floor(sqrt(225 - dy^2)); the x weights are
// taken relative to the tile's centre column so the f32 sums stay small.
// Reads outside the image are 0 (the TPU kernels' zero padding).
#include <cuda_runtime.h>
#include <stdint.h>

#define TW 32
#define TH 16
#define BORDER 3
#define MOM_R 15

struct Taps {
  float t[7];
};

__constant__ int c_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                             3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                             0, -1, -2, -3, -3, -3, -2, -1};
// u(dy) = floor(sqrt(15^2 - dy^2)) for dy = -15..15
__constant__ int c_u[2 * MOM_R + 1] = {0, 5, 7, 9, 10, 11, 12, 12, 13, 13, 14,
                                       14, 14, 14, 14, 15, 14, 14, 14, 14, 14,
                                       13, 13, 12, 12, 11, 10, 9, 7, 5, 0};

template <int HALO, bool SCORE, bool BLUR, bool MOM>
__global__ void __launch_bounds__(256)
level_kernel(const float* __restrict__ img, int H, int W, Taps taps,
             float* __restrict__ score_out, uint8_t* __restrict__ keep_out,
             float* __restrict__ m01_out, float* __restrict__ m10_out,
             float* __restrict__ blur_out) {
  constexpr int SH = TH + 2 * HALO;
  constexpr int SW = TW + 2 * HALO;
  __shared__ float s_img[SH][SW];
  __shared__ float s_sc[SCORE ? TH + 2 : 1][SCORE ? TW + 2 : 1];
  __shared__ float s_v[BLUR ? TH : 1][BLUR ? TW + 6 : 1];
  // prefix sums with a leading zero column: sum of cols [a, b] = P[b+1]-P[a]
  __shared__ float s_S[MOM ? SH : 1][MOM ? SW + 1 : 1];
  __shared__ float s_C[MOM ? SH : 1][MOM ? SW + 1 : 1];

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  for (int i = tid; i < SH * SW; i += nthr) {
    int ly = i / SW, lx = i % SW;
    int gy = y0 - HALO + ly, gx = x0 - HALO + lx;
    s_img[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                        ? img[(size_t)gy * W + gx] : 0.f;
  }
  __syncthreads();

  if constexpr (SCORE) {
    // FAST-9 score on the tile plus a 1-px ring (the NMS neighbourhood)
    for (int i = tid; i < (TH + 2) * (TW + 2); i += nthr) {
      int ly = i / (TW + 2), lx = i % (TW + 2);
      int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
      float s = 0.f;
      if (gy >= BORDER && gy < H - BORDER && gx >= BORDER && gx < W - BORDER) {
        int cy = ly + HALO - 1, cx = lx + HALO - 1;
        float c = s_img[cy][cx];
        float d[16];
#pragma unroll
        for (int k = 0; k < 16; ++k)
          d[k] = s_img[cy + c_dy[k]][cx + c_dx[k]] - c;
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
  }
  if constexpr (BLUR) {
    // vertical pass: output rows of the tile, columns x0-3 .. x0+TW+2
    for (int i = tid; i < TH * (TW + 6); i += nthr) {
      int ly = i / (TW + 6), lx = i % (TW + 6);
      float v = 0.f;
#pragma unroll
      for (int t = 0; t < 7; ++t)
        v += taps.t[t] * s_img[ly + HALO - 3 + t][lx + HALO - 3];
      s_v[ly][lx] = v;
    }
  }
  if constexpr (MOM) {
    // one thread per staged row: serial prefix sums of I and (x - xc) * I,
    // xc = the tile's centre column
    for (int r = tid; r < SH; r += nthr) {
      float s = 0.f, c = 0.f;
      s_S[r][0] = 0.f;
      s_C[r][0] = 0.f;
      for (int j = 0; j < SW; ++j) {
        float v = s_img[r][j];
        s += v;
        c += (float)(j - HALO - TW / 2) * v;
        s_S[r][j + 1] = s;
        s_C[r][j + 1] = c;
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < TH * TW; i += nthr) {
    int ly = i / TW, lx = i % TW;
    int gy = y0 + ly, gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    size_t o = (size_t)gy * W + gx;
    if constexpr (SCORE) {
      float c = s_sc[ly + 1][lx + 1];
      // raster tie-break: strict against earlier neighbours, >= later ones
      bool keep = c > s_sc[ly][lx] && c > s_sc[ly][lx + 1] &&
                  c > s_sc[ly][lx + 2] && c > s_sc[ly + 1][lx] &&
                  c >= s_sc[ly + 1][lx + 2] && c >= s_sc[ly + 2][lx] &&
                  c >= s_sc[ly + 2][lx + 1] && c >= s_sc[ly + 2][lx + 2];
      score_out[o] = c;
      keep_out[o] = keep ? 1 : 0;
    }
    if constexpr (BLUR) {
      float b = 0.f;
#pragma unroll
      for (int t = 0; t < 7; ++t) b += taps.t[t] * s_v[ly][lx + t];
      blur_out[o] = b;
    }
    if constexpr (MOM) {
      const int cx = lx + HALO;
      float m01 = 0.f, msum = 0.f, mxw = 0.f;
#pragma unroll
      for (int k = 0; k < 2 * MOM_R + 1; ++k) {
        const int dy = k - MOM_R, u = c_u[k], r = ly + HALO + dy;
        float rs = s_S[r][cx + u + 1] - s_S[r][cx - u];
        m01 += (float)dy * rs;
        msum += rs;
        mxw += s_C[r][cx + u + 1] - s_C[r][cx - u];
      }
      m01_out[o] = m01;
      m10_out[o] = mxw - msum * (float)(lx - TW / 2);
    }
  }
}

template <int HALO, bool SCORE, bool BLUR, bool MOM>
static int launch(const float* img, int H, int W, const float* taps,
                  float* score, uint8_t* keep, float* m01, float* m10,
                  float* blur, void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  Taps tp;
  for (int t = 0; t < 7; ++t) tp.t[t] = taps ? taps[t] : 0.f;
  dim3 block(32, 8);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  level_kernel<HALO, SCORE, BLUR, MOM><<<grid, block, 0, (cudaStream_t)stream>>>(
      img, H, W, tp, score, keep, m01, m10, blur);
  return (int)cudaGetLastError();
}

extern "C" int fast_nms_level_launch(const float* img, int H, int W,
                                     float* score, uint8_t* keep,
                                     void* stream) {
  return launch<4, true, false, false>(img, H, W, nullptr, score, keep,
                                       nullptr, nullptr, nullptr, stream);
}

extern "C" int blur7_level_launch(const float* img, int H, int W,
                                  const float* taps, float* blur,
                                  void* stream) {
  return launch<4, false, true, false>(img, H, W, taps, nullptr, nullptr,
                                       nullptr, nullptr, blur, stream);
}

extern "C" int frontend_level_launch(const float* img, int H, int W,
                                     const float* taps, int with_moments,
                                     float* score, uint8_t* keep, float* m01,
                                     float* m10, float* blur, void* stream) {
  if (with_moments)
    return launch<16, true, true, true>(img, H, W, taps, score, keep, m01,
                                        m10, blur, stream);
  return launch<4, true, true, false>(img, H, W, taps, score, keep, nullptr,
                                      nullptr, blur, stream);
}
