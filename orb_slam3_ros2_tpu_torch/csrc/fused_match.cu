// Windowed Hamming search (search-by-projection) and its acceptance test in
// one launch: for each feature row, the best landmark column inside a
// square pixel window, its lowest-index argmin, the second best excluding
// exactly that column, and from them idx / dist / valid under max_dist,
// the ratio test and the mutual check.
//
// Replaces the TPU kernel `_make_kernel` / `_match_window_call`
// (pl.pallas_call at :137) and the acceptance epilogue of `match_window`
// (:202-209) in orb_slam3_ros2_tpu/ops/fused_match.py.
//
// What bounds it on the H100: operations. At tracking's shape (N = 1000
// rows x M = 4096 columns, 15 px) the function is 28.9 M operations (a
// window test of ~7 per pair, ~28 more per pair inside the window, where 8
// __popc over the XOR of the packed words give the exact distance) on
// 0.24 MB: 0.43 us at 67 TFLOP/s. A launch and one exchange between blocks
// take longer than that, so the design is about latency:
//
// - One launch, one block per RB rows, and nothing passes between blocks:
//   no partials, no merge pass, no handoff. A block holds its rows' bits
//   and uv in shared memory and sweeps all M columns, its threads striding
//   over them U at a time with the next U's uv and mask in flight. The
//   window tests are branch-free; a column's packed bits are read only
//   when one of the block's rows has it inside the window.
// - Each row's top-2 is one 32-bit key, distance << 22 | column, so the
//   lowest column wins a tie by the key's order; two warp reductions
//   (__reduce_min_sync) and one pass over the warps finish it once per
//   call. The acceptance test follows in the kernel (the ratio test in
//   f32, `best < (float)ratio * second`, as torch rounds it).
// - The mutual check inside the block: it needs the argmin over all N rows
//   of only the <= RB columns the block's rows chose, so the block sweeps
//   the N rows once more against those columns (lowest row on a tie). That
//   is N x N pair tests in all where a column pass over every column is
//   N x M, and it needs no grid-wide handoff, counter or scratch; a run is
//   deterministic (`tools/match_ablation.py` times the handoff designs it
//   replaced).
//
// `match_floor_launch` is a measurement entry point, not used by the port:
// the same launch with both sweeps taken out (owner loads, reductions and
// acceptance), the latency floor of the design.
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL 0xffffffffu
#define INF_D 512u   // distance of "no allowed pair" (> 256)
#define IDX_BITS 22  // key = distance << IDX_BITS | index
#define IDX_MASK ((1u << IDX_BITS) - 1u)
#define NO_KEY (INF_D << IDX_BITS)  // decodes to index 0, as jnp.argmin
#define MAX_ENTRIES (1 << IDX_BITS)

// Instantiations (threads per block, rows per block, entries in flight a
// thread), the wrapper's PLAN.
#define MATCH_PLANS(X) X(512, 8, 2)

struct Side {  // one side of the match
  const uint4* bits;     // (n, 8) int32 packed, two uint4 an entry
  const float2* uv;      // (n, 2) f32
  const uint8_t* mask;   // (n,) bool
  int n;
};

struct Args {
  Side rows, cols;  // features (A), landmarks (B)
  float radius, max_dist, ratio;
  int has_ratio, mutual;
  int* idx;        // (N,) int32, -1 where no match
  float* dist;     // (N,) f32, 1e9 where no allowed pair
  uint8_t* valid;  // (N,) bool
};

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ unsigned hamming(uint4 a0, uint4 a1, uint4 b0,
                                            uint4 b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// Owners ent[g], g < G, of side s into shared memory: bits, and uv with
// NaN where the owner is absent (ent < 0) or masked, which no window test
// passes.
template <int G>
__device__ __forceinline__ void load_owners(const Side& s, const int* ent,
                                            uint4 (*ob)[2], float2* ouv) {
  for (int k = threadIdx.x; k < 2 * G; k += blockDim.x) {
    const int o = ent[k >> 1];
    ob[k >> 1][k & 1] = o >= 0 ? __ldg(s.bits + 2 * (size_t)o + (k & 1))
                               : make_uint4(0u, 0u, 0u, 0u);
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const int o = max(ent[g], 0);
    const float2 q = __ldg(s.uv + o);
    const bool on = ent[g] >= 0 && __ldg(s.mask + o) != 0;
    ouv[g] = on ? q : make_float2(qnan(), qnan());
  }
}

// What `sweep` does besides the keys for each allowed pair: nothing here;
// `tools/match_ablation.py`'s atomic variant passes one.
struct NoHook {
  __device__ void operator()(int, int, unsigned) const {}
};

// Stream every entry j of s past the G owners: thread t takes j = t,
// t + T, ..., U at a time, the next U's uv and mask in flight while it
// tests these. For each allowed pair (owner g, entry j, Hamming distance
// d), key[g] keeps the least d << IDX_BITS | j and, with SECOND, sec[g]
// the least distance over the other entries (the loser of each min). The
// window tests are branch-free; only an entry with a pair inside the
// window has its bits read.
template <int T, int G, int U, bool SECOND, class Hook = NoHook>
__device__ __forceinline__ void sweep(const Side& s, float radius,
                                      uint4 (*ob)[2], const float2* ouv,
                                      unsigned (&key)[G], unsigned (&sec)[G],
                                      Hook hook = Hook()) {
  static_assert(G <= 32, "one bit of `hit` an owner");
  float2 q[U];
  uint8_t on[U];
  auto fetch = [&](int s0) {
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int j = min(s0 + k * T, s.n - 1);
      q[k] = __ldg(s.uv + j);
      on[k] = __ldg(s.mask + j);
    }
  };
  fetch(threadIdx.x);
  for (int s0 = threadIdx.x; s0 < s.n; s0 += T * U) {
    float su[U], sv[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const bool in = s0 + k * T < s.n && on[k] != 0;
      su[k] = in ? q[k].x : qnan();
      sv[k] = in ? q[k].y : qnan();
    }
    fetch(s0 + T * U);
    unsigned hit[U], any = 0u;
#pragma unroll
    for (int k = 0; k < U; ++k) hit[k] = 0u;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float2 o = ouv[g];
#pragma unroll
      for (int k = 0; k < U; ++k)
        if ((fabsf(o.x - su[k]) <= radius) & (fabsf(o.y - sv[k]) <= radius))
          hit[k] |= 1u << g;
    }
#pragma unroll
    for (int k = 0; k < U; ++k) any |= hit[k];
    if (any == 0u) continue;
    uint4 b0[U], b1[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const uint4* p = s.bits + 2 * (size_t)min(s0 + k * T, s.n - 1);
      b0[k] = hit[k] ? __ldg(p) : make_uint4(0u, 0u, 0u, 0u);
      b1[k] = hit[k] ? __ldg(p + 1) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < U; ++k)
      for (unsigned left = hit[k]; left; left &= left - 1u) {
        const int h = __ffs(left) - 1;
        const unsigned d = hamming(ob[h][0], ob[h][1], b0[k], b1[k]);
        const unsigned kn = d << IDX_BITS | (unsigned)(s0 + k * T);
        hook(h, s0 + k * T, d);
#pragma unroll
        for (int g = 0; g < G; ++g) {  // selects: key[] stays in registers
          const unsigned kg = g == h ? kn : FULL;  // FULL loses every min
          if constexpr (SECOND)
            sec[g] = min(sec[g], max(key[g], kg) >> IDX_BITS);
          key[g] = min(key[g], kg);
        }
      }
  }
}

// Reduce each owner's (key, sec) over the block: the least key, and the
// least distance over every entry but that key's. Thread g < G gets owner
// g's pair.
template <int T, int G, bool SECOND>
__device__ __forceinline__ void block_min(const unsigned (&key)[G],
                                          const unsigned (&sec)[G],
                                          unsigned (*s_key)[G],
                                          unsigned (*s_sec)[G], unsigned& K,
                                          unsigned& S) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const unsigned k = __reduce_min_sync(FULL, key[g]);
    if (lane == 0) s_key[warp][g] = k;
    if constexpr (SECOND) {
      const unsigned s2 = __reduce_min_sync(
          FULL, key[g] == k ? sec[g] : min(sec[g], key[g] >> IDX_BITS));
      if (lane == 0) s_sec[warp][g] = s2;
    }
  }
  __syncthreads();
  K = NO_KEY;
  S = INF_D;
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
#pragma unroll
    for (int w = 0; w < T / 32; ++w) K = min(K, s_key[w][g]);
    if constexpr (SECOND) {
#pragma unroll
      for (int w = 0; w < T / 32; ++w) {
        const unsigned k = s_key[w][g];
        S = min(S, k == K ? s_sec[w][g] : min(s_sec[w][g], k >> IDX_BITS));
      }
    }
  }
}

template <int T, int RB>
struct RowBlock {  // a block's shared memory
  uint4 bits[RB][2];                       // its owners' bits
  float2 uv[RB];                           // and uv (NaN: no owner)
  unsigned key[T / 32][RB], sec[T / 32][RB];  // warps' partials
  int ent[RB];                             // the owners' indices
};

// The top-2 of rows r0 + g, g < RB, over all M columns. Thread g gets its
// row's argmin column j and whether the row passes max_dist and the ratio
// test, and writes its dist; other threads get false.
template <int T, int RB, int U, bool SWEEP, class Hook = NoHook>
__device__ __forceinline__ bool rows_top2(const Args& a, int r0,
                                          RowBlock<T, RB>& sh, int& j,
                                          Hook hook = Hook()) {
  const int g = threadIdx.x, o = r0 + g;
  if (g < RB) sh.ent[g] = o < a.rows.n ? o : -1;
  __syncthreads();
  load_owners<RB>(a.rows, sh.ent, sh.bits, sh.uv);
  unsigned key[RB], sec[RB];
#pragma unroll
  for (int k = 0; k < RB; ++k) {
    key[k] = NO_KEY;
    sec[k] = INF_D;
  }
  __syncthreads();
  if constexpr (SWEEP)
    sweep<T, RB, U, true>(a.cols, a.radius, sh.bits, sh.uv, key, sec, hook);
  unsigned K, S;
  block_min<T, RB, true>(key, sec, sh.key, sh.sec, K, S);
  j = (int)(K & IDX_MASK);
  if (g >= RB || o >= a.rows.n) return false;
  const unsigned b1 = K >> IDX_BITS;
  const float best = b1 >= INF_D ? 1e9f : (float)b1;
  const float second = S >= INF_D ? 1e9f : (float)S;
  bool ok = __ldg(a.rows.mask + o) != 0 && best <= a.max_dist;
  if (a.has_ratio) ok = ok && best < a.ratio * second;
  a.dist[o] = best;
  return ok;
}

// The mutual check of rows r0 + g inside their block: the argmin over all
// N rows of each column j that a row still able to match chose, which must
// be that row. Thread g gets its row's verdict.
template <int T, int RB, int U, bool SWEEP>
__device__ __forceinline__ bool rows_mutual(const Args& a, int r0,
                                            RowBlock<T, RB>& sh, bool ok,
                                            int j) {
  __syncthreads();  // the rows' owners and partials are read
  if (threadIdx.x < RB) sh.ent[threadIdx.x] = ok ? j : -1;
  __syncthreads();
  load_owners<RB>(a.cols, sh.ent, sh.bits, sh.uv);
  unsigned key[RB], unused[RB];
#pragma unroll
  for (int k = 0; k < RB; ++k) key[k] = unused[k] = NO_KEY;
  __syncthreads();
  if constexpr (SWEEP)
    sweep<T, RB, U, false>(a.rows, a.radius, sh.bits, sh.uv, key, unused);
  unsigned K, S;
  block_min<T, RB, false>(key, unused, sh.key, sh.key, K, S);
  return ok && (int)(K & IDX_MASK) == r0 + (int)threadIdx.x;
}

// One block a group of RB rows; nothing passes between blocks.
template <int T, int RB, int U, bool SWEEP>
__global__ void __launch_bounds__(T) match_window_kernel(const Args a) {
  __shared__ RowBlock<T, RB> sh;
  const int r0 = blockIdx.x * RB, o = r0 + threadIdx.x;
  int j;
  bool ok = rows_top2<T, RB, U, SWEEP>(a, r0, sh, j);
  if (a.mutual) ok = rows_mutual<T, RB, U, SWEEP>(a, r0, sh, ok, j);
  if (threadIdx.x < RB && o < a.rows.n) {
    a.idx[o] = ok ? j : -1;
    a.valid[o] = ok;
  }
}

// The launch's Args, or false for arguments the kernel does not take:
// 1..2^22 entries a side, bits 16-byte and uv 8-byte aligned.
static bool make_args(Args& a, const unsigned* bits_a, const uint8_t* mask_a,
                      const float* uv_a, int N, const unsigned* bits_b,
                      const uint8_t* mask_b, const float* uv_b, int M,
                      float radius, float max_dist, float ratio,
                      int has_ratio, int mutual, int* idx, float* dist,
                      uint8_t* valid) {
  if (N < 1 || M < 1 || N > MAX_ENTRIES || M > MAX_ENTRIES) return false;
  if ((((uintptr_t)bits_a | (uintptr_t)bits_b) & 15) ||
      (((uintptr_t)uv_a | (uintptr_t)uv_b) & 7))
    return false;
  a = Args{Side{(const uint4*)bits_a, (const float2*)uv_a, mask_a, N},
           Side{(const uint4*)bits_b, (const float2*)uv_b, mask_b, M},
           radius, max_dist, ratio, has_ratio, mutual, idx, dist, valid};
  return true;
}

template <bool SWEEP>
static int launch(const Args& a, int nt, int rb, int u, cudaStream_t st) {
#define MATCH_CASE(T_, RB_, U_)                                              \
  if (nt == T_ && rb == RB_ && u == U_) {                                    \
    match_window_kernel<T_, RB_, U_, SWEEP>                                  \
        <<<(a.rows.n + RB_ - 1) / RB_, T_, 0, st>>>(a);                      \
    return (int)cudaGetLastError();                                          \
  }
  MATCH_PLANS(MATCH_CASE)
#undef MATCH_CASE
  return (int)cudaErrorInvalidValue;
}

#define MATCH_PARAMS                                                         \
  const unsigned *bits_a, const uint8_t *mask_a, const float *uv_a, int N,   \
      const unsigned *bits_b, const uint8_t *mask_b, const float *uv_b,      \
      int M, float radius, float max_dist, float ratio, int has_ratio,       \
      int mutual, int nt, int rb, int u, int *idx, float *dist,              \
      uint8_t *valid, void *stream
#define MATCH_ARGS                                                           \
  bits_a, mask_a, uv_a, N, bits_b, mask_b, uv_b, M, radius, max_dist, ratio, \
      has_ratio, mutual, idx, dist, valid

// Launch the plan (nt threads, rb rows a block, u entries in flight a
// thread) on `stream`; returns a CUDA error code (invalid value for
// arguments or a plan the kernel does not take).
extern "C" int match_window_launch(MATCH_PARAMS) {
  Args a;
  if (!make_args(a, MATCH_ARGS)) return (int)cudaErrorInvalidValue;
  return launch<true>(a, nt, rb, u, (cudaStream_t)stream);
}

extern "C" int match_floor_launch(MATCH_PARAMS) {
  Args a;
  if (!make_args(a, MATCH_ARGS)) return (int)cudaErrorInvalidValue;
  return launch<false>(a, nt, rb, u, (cudaStream_t)stream);
}
