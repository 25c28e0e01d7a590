// Windowed Hamming search (search-by-projection): for each feature row, the
// best landmark column inside a square pixel window, its lowest-index
// argmin and the second best excluding that argmin; for each landmark
// column, the lowest row that reaches its minimum (the mutual check).
//
// Replaces the TPU kernel `_make_kernel` / `match_window` in
// orb_slam3_ros2_tpu/ops/fused_match.py.
//
// What bounds it on the H100: neither bytes nor arithmetic at the main-path
// shape. N=1000 rows x M=4096 columns is 4.1M pairs; each costs a window
// test and, inside the window, 8 __popc over the XOR of the packed words
// (exact, where the TPU used a bf16 +-1 matmul on the MXU). Inputs are
// 160 KB. What dominates is launch and the two-pass structure, so the
// design keeps everything in two small launches: pass 1 tiles rows x
// landmark columns (64 x 256 per block), stages the column tile's packed
// bits, uv and mask in shared memory, gives each warp a row at a time (each
// lane strides over the tile's columns), reduces each row's (best, argmin,
// second) over the warp with shuffles, and writes one partial per (column
// tile, row). The per-column argmin goes through atomicMin on a packed
// 64-bit key (dist << 32 | row), so the lowest row wins ties; only pairs
// inside the window issue an atomic. Pass 2 merges the partials of each row
// in tile order with the TPU kernel's strict-< streaming rule and unpacks
// the column keys.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define CT 256          // landmark columns per block
#define RB 64           // feature rows per block
#define INF_D 0x100000  // distance of a gated-out pair (> 256)
#define SKIP_D 0x200000 // a lane that saw no column at all

struct Top2 {
  int b1, a1, b2;
};

// Combine two (best, argmin, second-excluding-argmin) over disjoint column
// sets; the lower column index wins a tie on best.
__device__ __forceinline__ Top2 merge(Top2 x, Top2 y) {
  bool xw = x.b1 < y.b1 || (x.b1 == y.b1 && x.a1 < y.a1);
  Top2 w = xw ? x : y;
  Top2 l = xw ? y : x;
  return Top2{w.b1, w.a1, min(w.b2, l.b1)};
}

__global__ void __launch_bounds__(256)
match_partial_kernel(const unsigned* __restrict__ bits_a,
                     const uint8_t* __restrict__ mask_a,
                     const float* __restrict__ uv_a, int N,
                     const unsigned* __restrict__ bits_b,
                     const uint8_t* __restrict__ mask_b,
                     const float* __restrict__ uv_b, int M, float radius,
                     int* __restrict__ part_b1, int* __restrict__ part_a1,
                     int* __restrict__ part_b2,
                     unsigned long long* __restrict__ colkey) {
  __shared__ unsigned s_bits[CT][9];  // 9: odd stride, no bank conflicts
  __shared__ float s_u[CT], s_v[CT];
  __shared__ uint8_t s_m[CT];

  const int tile = blockIdx.x;
  const int c0 = tile * CT;
  const int r0 = blockIdx.y * RB;
  const int tid = threadIdx.x;

  for (int i = tid; i < CT * 8; i += blockDim.x) {
    int c = i >> 3, w = i & 7, gc = c0 + c;
    s_bits[c][w] = gc < M ? bits_b[(size_t)gc * 8 + w] : 0u;
  }
  for (int c = tid; c < CT; c += blockDim.x) {
    int gc = c0 + c;
    bool in = gc < M;
    s_u[c] = in ? uv_b[2 * gc] : 0.f;
    s_v[c] = in ? uv_b[2 * gc + 1] : 0.f;
    s_m[c] = in ? mask_b[gc] : 0;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const int r_end = min(r0 + RB, N);
  for (int r = r0 + warp; r < r_end; r += nwarps) {
    unsigned a[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) a[w] = bits_a[(size_t)r * 8 + w];
    const float ua = uv_a[2 * r], va = uv_a[2 * r + 1];
    const bool ma = mask_a[r] != 0;
    Top2 t{SKIP_D, INT_MAX, SKIP_D};
    for (int c = lane; c < CT && c0 + c < M; c += 32) {
      int d = INF_D;
      if (ma && s_m[c] && fabsf(ua - s_u[c]) <= radius &&
          fabsf(va - s_v[c]) <= radius) {
        d = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w) d += __popc(a[w] ^ s_bits[c][w]);
        atomicMin(&colkey[c0 + c],
                  ((unsigned long long)d << 32) | (unsigned)r);
      }
      // columns arrive in ascending order: a tie keeps the earlier argmin
      if (d < t.b1) {
        t.b2 = t.b1;
        t.b1 = d;
        t.a1 = c0 + c;
      } else {
        t.b2 = min(t.b2, d);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Top2 o{__shfl_down_sync(0xffffffffu, t.b1, off),
             __shfl_down_sync(0xffffffffu, t.a1, off),
             __shfl_down_sync(0xffffffffu, t.b2, off)};
      t = merge(t, o);
    }
    if (lane == 0) {
      size_t o = (size_t)tile * N + r;
      part_b1[o] = t.b1;
      part_a1[o] = t.a1;
      part_b2[o] = t.b2;
    }
  }
}

__global__ void match_merge_kernel(const int* __restrict__ part_b1,
                                   const int* __restrict__ part_a1,
                                   const int* __restrict__ part_b2,
                                   int n_tiles, int N,
                                   const unsigned long long* __restrict__ colkey,
                                   int M, float* __restrict__ best,
                                   float* __restrict__ second,
                                   int* __restrict__ bidx,
                                   int* __restrict__ cidx) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) {
    int b1 = part_b1[i], i1 = part_a1[i], b2 = part_b2[i];
    for (int t = 1; t < n_tiles; ++t) {
      size_t o = (size_t)t * N + i;
      int t1 = part_b1[o], a1 = part_a1[o], t2 = part_b2[o];
      // strict <: on a tie the earlier tile (lower column ids) keeps argmin
      if (t1 < b1) {
        b2 = min(b1, t2);
        b1 = t1;
        i1 = a1;
      } else {
        b2 = min(b2, t1);
      }
    }
    best[i] = b1 >= INF_D ? 1e9f : (float)b1;
    second[i] = b2 >= INF_D ? 1e9f : (float)b2;
    bidx[i] = i1;
  }
  if (i < M) cidx[i] = (int)(colkey[i] & 0xffffffffull);
}

extern "C" int match_window_launch(const unsigned* bits_a,
                                   const uint8_t* mask_a, const float* uv_a,
                                   int N, const unsigned* bits_b,
                                   const uint8_t* mask_b, const float* uv_b,
                                   int M, float radius, int* part_b1,
                                   int* part_a1, int* part_b2,
                                   unsigned long long* colkey, float* best,
                                   float* second, int* bidx, int* cidx,
                                   void* stream) {
  if (N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = (M + CT - 1) / CT;
  dim3 grid1(n_tiles, (N + RB - 1) / RB);
  match_partial_kernel<<<grid1, 256, 0, s>>>(bits_a, mask_a, uv_a, N, bits_b,
                                             mask_b, uv_b, M, radius, part_b1,
                                             part_a1, part_b2, colkey);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = N > M ? N : M;
  match_merge_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      part_b1, part_a1, part_b2, n_tiles, N, colkey, M, best, second, bidx,
      cidx);
  return (int)cudaGetLastError();
}

// Number of column tiles pass 1 writes partials for (the wrapper sizes the
// scratch buffers with it).
extern "C" int match_window_tiles(int M) { return (M + CT - 1) / CT; }

// Column key of a landmark that no row reaches: gated-out distance, row 0.
extern "C" unsigned long long match_window_colkey_init(void) {
  return (unsigned long long)INF_D << 32;
}
