// Robust pose-only Levenberg-Marquardt for one frame in one thread block:
// 3 rounds x 5 iterations of Huber-weighted reprojection residuals, a 7x7
// Gram [J|r]^T W [J|r], a damped 6x6 Cholesky solve, an SE(3) retraction
// with Gram-Schmidt, lambda x0.5 on accept and x4 on reject, and chi2
// re-classification of outliers at each round boundary.
//
// Replaces the TPU kernel `_make_kernel` / `optimize_pose_fused` in
// orb_slam3_ros2_tpu/backend/pose_opt_fused.py (same algorithm as the plain
// `backend/pose_opt.optimize_pose`).
//
// What bounds it on the H100: latency, not bytes or FLOPs. The whole run is
// 18 evaluations of ~100 flops per point (N=1000: ~2 MFLOP, 32 KB of
// input), but every iteration depends on the last through a scalar solve.
// The design runs the whole LM in one launch on one SM: each evaluation is a
// strided per-thread loop over the points, then a warp-shuffle + shared
// memory reduction of the 28 Gram entries and the cost; thread 0 does the
// Cholesky, the retraction and the normalization and publishes the
// candidate pose through shared memory. Per-point chi2 and cheirality of the
// accepted and the candidate pose live in shared memory and swap by pointer
// on accept, so no per-point state goes back to device memory until the end.
// The guards of the TPU kernel are kept: z clamp 1e-8, cheirality 0.05, the
// Taylor branch below theta^2 = 1e-8 and the 1e-12 floors.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NT 256
#define NW (NT / 32)
#define NG 28  // upper triangle of the 7x7 Gram
#define NACC (NG + 1)

struct Cam {
  float fx, fy, cx, cy, delta, chi2_th;
};

__device__ __forceinline__ float huber_rho(float chi2, float delta) {
  return chi2 <= delta * delta
             ? chi2
             : 2.f * delta * sqrtf(fmaxf(chi2, 1e-12f)) - delta * delta;
}

// Sum NACC per-thread values over the block into out[] (all threads return
// after out[] is complete).
__device__ void block_reduce(float (&acc)[NACC], float (*s_red)[NACC],
                             float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < NACC) {
    float v = 0.f;
    for (int w = 0; w < NW; ++w) v += s_red[w][threadIdx.x];
    out[threadIdx.x] = v;
  }
  __syncthreads();
}

// One residual/Jacobian pass at (R, t): Gram + cost into s_G, per-point
// chi2 and cheirality into chi2_out / pos_out.
__device__ void eval_system(const float* R, const float* t,
                            const float* __restrict__ X,
                            const float* __restrict__ uv,
                            const float* __restrict__ invs2,
                            const uint8_t* __restrict__ mask,
                            const float* act, int N, const Cam& c,
                            float* chi2_out, float* pos_out,
                            float (*s_red)[NACC], float* s_G) {
  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
  const float R00 = R[0], R01 = R[1], R02 = R[2], R10 = R[3], R11 = R[4],
              R12 = R[5], R20 = R[6], R21 = R[7], R22 = R[8];
  const float t0 = t[0], t1 = t[1], t2 = t[2];
  for (int i = threadIdx.x; i < N; i += NT) {
    const float X0 = X[3 * i], X1 = X[3 * i + 1], X2 = X[3 * i + 2];
    const float wa = invs2[i] * (mask[i] ? 1.f : 0.f) * act[i];
    const float xr = R00 * X0 + R01 * X1 + R02 * X2 + t0;
    const float yr = R10 * X0 + R11 * X1 + R12 * X2 + t1;
    const float zr = R20 * X0 + R21 * X1 + R22 * X2 + t2;
    const float z = fabsf(zr) < 1e-8f ? 1e-8f : zr;
    const float iz = 1.f / z;
    const float iz2 = iz * iz;
    const float rx = c.fx * xr * iz + c.cx - uv[2 * i];
    const float ry = c.fy * yr * iz + c.cy - uv[2 * i + 1];
    const float chi2 = (rx * rx + ry * ry) * invs2[i];
    const float pos = zr > 0.05f ? 1.f : 0.f;
    const float rn = sqrtf(fmaxf(chi2, 1e-12f));
    const float hw = rn <= c.delta ? 1.f : c.delta / rn;
    const float ww = wa * hw * pos;
    const float a0 = c.fx * iz, c0 = -c.fx * xr * iz2;
    const float b1 = c.fy * iz, c1 = -c.fy * yr * iz2;
    const float J0[7] = {a0, 0.f, c0, c0 * yr, a0 * zr - c0 * xr, -a0 * yr,
                         rx};
    const float J1[7] = {0.f, b1, c1, c1 * yr - b1 * zr, -c1 * xr, b1 * xr,
                         ry};
    int k = 0;
#pragma unroll
    for (int a = 0; a < 7; ++a) {
#pragma unroll
      for (int b = a; b < 7; ++b) {
        acc[k] += ww * J0[a] * J0[b] + ww * J1[a] * J1[b];
        ++k;
      }
    }
    acc[NG] += wa > 0.f ? huber_rho(chi2, c.delta) : 0.f;
    chi2_out[i] = chi2;
    pos_out[i] = pos;
  }
  block_reduce(acc, s_red, s_G);
}

__device__ __forceinline__ int gidx(int a, int b) {
  // index of (a, b), a <= b, in the row-major upper triangle of 7x7
  if (a > b) {
    int tmp = a;
    a = b;
    b = tmp;
  }
  return a * 7 - a * (a - 1) / 2 + (b - a);
}

// Thread 0: damped 6x6 Cholesky solve, retraction exp(-x) * (R, t) and
// Gram-Schmidt, written to Rc, tc.
__device__ void lm_step(const float* G, float lam, const float* R,
                        const float* t, float* Rc, float* tc) {
  float h[6][6], L[6][6], y[6], x[6];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j)
      h[i][j] = G[gidx(i, j)] + (i == j ? lam * G[gidx(i, i)] + 1e-9f : 0.f);
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = h[i][j];
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      if (i == j)
        L[i][j] = sqrtf(fmaxf(s, 1e-12f));
      else
        L[i][j] = s / L[j][j];
    }
  }
  for (int i = 0; i < 6; ++i) {
    float s = G[gidx(i, 6)];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
  const float rho[3] = {-x[0], -x[1], -x[2]};
  const float phi[3] = {-x[3], -x[4], -x[5]};
  const float ts = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const bool small = ts < 1e-8f;
  const float safe_ts = small ? 1.f : ts;
  const float theta = sqrtf(safe_ts);
  const float ca = small ? 1.f - ts / 6.f : sinf(theta) / theta;
  const float cb = small ? 0.5f - ts / 24.f : (1.f - cosf(theta)) / safe_ts;
  const float cc = small ? 1.f / 6.f - ts / 120.f : (1.f - ca) / safe_ts;
  const float K[3][3] = {{0.f, -phi[2], phi[1]},
                         {phi[2], 0.f, -phi[0]},
                         {-phi[1], phi[0], 0.f}};
  float dR[3][3], V[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float P2 = phi[i] * phi[j] - (i == j ? ts : 0.f);  // K^2
      float id = i == j ? 1.f : 0.f;
      dR[i][j] = id + ca * K[i][j] + cb * P2;
      V[i][j] = id + cb * K[i][j] + cc * P2;
    }
  float Rn[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      Rn[i][j] = dR[i][0] * R[j] + dR[i][1] * R[3 + j] + dR[i][2] * R[6 + j];
    tc[i] = dR[i][0] * t[0] + dR[i][1] * t[1] + dR[i][2] * t[2] +
            (V[i][0] * rho[0] + V[i][1] * rho[1] + V[i][2] * rho[2]);
  }
  // Gram-Schmidt on the columns
  float cx[3] = {Rn[0][0], Rn[1][0], Rn[2][0]};
  float cy[3] = {Rn[0][1], Rn[1][1], Rn[2][1]};
  float nx = fmaxf(sqrtf(cx[0] * cx[0] + cx[1] * cx[1] + cx[2] * cx[2]), 1e-12f);
  for (int i = 0; i < 3; ++i) cx[i] /= nx;
  float d = cx[0] * cy[0] + cx[1] * cy[1] + cx[2] * cy[2];
  for (int i = 0; i < 3; ++i) cy[i] -= d * cx[i];
  float ny = fmaxf(sqrtf(cy[0] * cy[0] + cy[1] * cy[1] + cy[2] * cy[2]), 1e-12f);
  for (int i = 0; i < 3; ++i) cy[i] /= ny;
  float cz[3] = {cx[1] * cy[2] - cx[2] * cy[1], cx[2] * cy[0] - cx[0] * cy[2],
                 cx[0] * cy[1] - cx[1] * cy[0]};
  for (int i = 0; i < 3; ++i) {
    Rc[3 * i] = cx[i];
    Rc[3 * i + 1] = cy[i];
    Rc[3 * i + 2] = cz[i];
  }
}

__global__ void __launch_bounds__(NT)
pose_opt_kernel(const float* __restrict__ pose0, const float* __restrict__ X,
                const float* __restrict__ uv,
                const float* __restrict__ invs2,
                const uint8_t* __restrict__ mask, int N, Cam c, int n_rounds,
                int iters, float* __restrict__ pose_out,
                uint8_t* __restrict__ inl_out) {
  extern __shared__ float sh[];
  float* chi2v = sh;          // accepted pose
  float* posv = sh + N;
  float* chi2c = sh + 2 * N;  // candidate pose
  float* posc = sh + 3 * N;
  float* act = sh + 4 * N;    // round's active set (0/1)
  __shared__ float s_red[NW][NACC];
  __shared__ float s_G[NACC];
  __shared__ float s_R[9], s_t[3], s_Rc[9], s_tc[3];
  __shared__ int s_better;

  const int tid = threadIdx.x;
  if (tid < 9) s_R[tid] = pose0[tid];
  if (tid < 3) s_t[tid] = pose0[9 + tid];
  for (int i = tid; i < N; i += NT) {
    chi2v[i] = 0.f;
    posv[i] = 1.f;
  }
  __syncthreads();

  float G[NACC];  // thread 0: the accepted system and cost
  float lam = 1e-3f;
  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    for (int i = tid; i < N; i += NT)
      act[i] = (rnd == 0 || (chi2v[i] <= c.chi2_th && posv[i] > 0.5f &&
                             mask[i])) ? 1.f : 0.f;
    __syncthreads();
    eval_system(s_R, s_t, X, uv, invs2, mask, act, N, c, chi2v, posv, s_red,
                s_G);
    if (tid == 0)
      for (int k = 0; k < NACC; ++k) G[k] = s_G[k];
    for (int it = 0; it < iters; ++it) {
      if (tid == 0) lm_step(G, lam, s_R, s_t, s_Rc, s_tc);
      __syncthreads();
      eval_system(s_Rc, s_tc, X, uv, invs2, mask, act, N, c, chi2c, posc,
                  s_red, s_G);
      if (tid == 0) {
        bool better = s_G[NG] < G[NG];
        if (better) {
          for (int k = 0; k < 9; ++k) s_R[k] = s_Rc[k];
          for (int k = 0; k < 3; ++k) s_t[k] = s_tc[k];
          for (int k = 0; k < NACC; ++k) G[k] = s_G[k];
        }
        lam = fminf(fmaxf(better ? lam * 0.5f : lam * 4.f, 1e-7f), 1e2f);
        s_better = better;
      }
      __syncthreads();
      if (s_better) {  // the candidate's per-point state becomes accepted
        float* tmp = chi2v;
        chi2v = chi2c;
        chi2c = tmp;
        tmp = posv;
        posv = posc;
        posc = tmp;
      }
    }
  }

  float acc[NACC];
  for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
  for (int i = tid; i < N; i += NT) {
    bool inl = chi2v[i] <= c.chi2_th && posv[i] > 0.5f && mask[i];
    inl_out[i] = inl ? 1 : 0;
    if (inl) {
      acc[0] += huber_rho(chi2v[i], c.delta);
      acc[1] += 1.f;
    }
  }
  block_reduce(acc, s_red, s_G);
  if (tid == 0) {
    for (int k = 0; k < 9; ++k) pose_out[k] = s_R[k];
    for (int k = 0; k < 3; ++k) pose_out[9 + k] = s_t[k];
    pose_out[12] = s_G[0];
    pose_out[13] = s_G[1];
    pose_out[14] = 0.f;
    pose_out[15] = 0.f;
  }
}

extern "C" int pose_opt_launch(const float* pose0, const float* X,
                               const float* uv, const float* invs2,
                               const uint8_t* mask, int N, float fx, float fy,
                               float cx, float cy, float delta, float chi2_th,
                               int n_rounds, int iters, float* pose_out,
                               uint8_t* inl_out, void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  Cam c{fx, fy, cx, cy, delta, chi2_th};
  size_t smem = (size_t)5 * N * sizeof(float);
  pose_opt_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(
      pose0, X, uv, invs2, mask, N, c, n_rounds, iters, pose_out, inl_out);
  return (int)cudaGetLastError();
}

// Largest N whose per-point state fits the default 48 KB of shared memory.
extern "C" int pose_opt_max_points(void) {
  return (48 * 1024 - (int)(sizeof(float) * (NW * NACC + NACC + 24) + 64)) /
         (5 * (int)sizeof(float));
}
