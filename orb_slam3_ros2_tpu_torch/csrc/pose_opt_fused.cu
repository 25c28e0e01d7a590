// Robust pose-only Levenberg-Marquardt for one frame in one launch:
// 3 rounds x 5 iterations of Huber-weighted reprojection residuals, a 7x7
// Gram [J|r]^T W [J|r], a damped 6x6 Cholesky solve, an SE(3) retraction
// with Gram-Schmidt, lambda x0.5 on accept and x4 on reject, and chi2
// re-classification of outliers at each round boundary.
//
// Replaces the TPU kernel `_make_kernel` / `_pose_call` in
// orb_slam3_ros2_tpu/backend/pose_opt_fused.py (same algorithm as the plain
// `backend/pose_opt.optimize_pose`).
//
// What bounds it on the H100: latency. The run is 18 evaluations of ~235
// operations a point (N = 1000: 4.2 M operations, 26 KB in), so bytes and
// operations allow well under a microsecond, but each evaluation waits for
// the previous one through a block-wide sum and a scalar 6x6 solve. Per
// evaluation the critical path is: the point pass, one reduction of 29
// sums, and the solve's dependent chain (6 square roots and 27 divisions
// in the plain form). At 1000 points on an H100, of ~30 us the 18
// reductions across the cluster take ~15 (the latency floor below), the
// 15 solves ~11 and the point passes ~4 (`tools/pose_ablation.py`). The
// design shortens each part:
//
// - Per-point state in registers. Thread g of the cluster owns points
//   g + k * NT * CL, k < P (P, NT and the cluster size CL are template
//   parameters that the wrapper picks by N). It loads X, uv, invs2 and the
//   mask once; the accepted and the candidate chi2 and cheirality stay in
//   registers and are selected on accept. No per-point state goes through
//   shared or device memory, so N is bounded by the instantiations, not by
//   shared memory.
// - The point pass and the Gram with explicit fmaf, the Gram on
//   W = ww * J (the build has --fmad=false, which fmaf ignores); the
//   identically zero entries of the pinhole Jacobian are skipped.
// - One reduction an evaluation: a butterfly reduce-scatter of the 29 sums
//   (padded to 32) across a warp's lanes, 31 shuffles instead of 29 x 5;
//   each lane writes its warp's sum of one entry to double-buffered shared
//   memory; one wait (__syncthreads in one CTA; in a cluster, each CTA
//   stores its partials into every peer's shared memory with st.async and
//   waits on its own mbarrier for the bytes to arrive, which avoids the
//   cluster barrier's GPU-wide fence); each lane adds the partials of its
//   entry in a fixed order; 29 shuffles broadcast them. The order is fixed
//   and there are no atomics, so a run is bit-reproducible.
// - The solve off thread 0: every thread runs the same fully unrolled
//   Cholesky, retraction and Gram-Schmidt on the same bits, in registers,
//   and takes the same accept decision, so no pose goes through shared
//   memory and no second barrier is needed. Its chain of dependent
//   operations bounds every iteration, so it sums with fmaf and takes its
//   square roots and the divisions by them through rsqrtf (not IEEE;
//   within 2 ulp); the retraction's other divisions and the point pass's
//   stay IEEE. `tools/pose_ablation.py` times the IEEE forms.
// - Spread over SMs: the plans the wrapper picks are clusters of 8 CTAs of
//   128 threads, whose point passes are 8 times shorter than one CTA's at
//   the price of a cluster barrier an evaluation; at 1000 and 2000 points
//   that beats one CTA and clusters of 2 and 4 (`tools/pose_ablation.py`,
//   which also instantiates those).
//
// The guards of the TPU kernel are kept: z clamp 1e-8, cheirality 0.05, the
// Taylor branch below theta^2 = 1e-8, the 1e-12 floors, the 1e-9 diagonal.
//
// `pose_floor_launch` is a measurement entry point, not used by the port:
// the same launch shape doing only n reductions of 29 sums and their
// broadcast, the latency floor of the design.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NACC 29  // upper triangle of the 7x7 Gram (28) and the cost
#define NRED 32  // NACC padded to a warp's width
#define FULL 0xffffffffu

// Instantiations (threads per CTA, points per thread, CTAs per cluster),
// the wrapper's PLANS.
#define POSE_PLANS(X) X(128, 1, 8) X(128, 2, 8) X(128, 4, 8) X(128, 8, 8)

struct Cam {
  float fx, fy, cx, cy, delta, chi2_th;
};

struct Args {
  const float* R0;
  const float* t0;
  const float* X;
  const float* uv;
  const float* invs2;
  const uint8_t* mask;
  int N;
  Cam c;
  int n_rounds, iters;
  float* pose_out;
  int* n_inl_out;
  uint8_t* inl_out;
};

// Index of (a, b) in the row-major upper triangle of 7x7.
__host__ __device__ constexpr int gidx(int a, int b) {
  return a <= b ? a * 7 - a * (a - 1) / 2 + (b - a) : gidx(b, a);
}

__device__ __forceinline__ float huber_rho(float chi2, float rn, float delta) {
  return chi2 <= delta * delta ? chi2 : 2.f * delta * rn - delta * delta;
}

template <int CL>
__device__ __forceinline__ int cta_rank() {
  if constexpr (CL > 1)
    return (int)cg::this_cluster().block_rank();
  else
    return 0;
}

// Distributed shared memory without a cluster barrier: each CTA stores
// into its peers with st.async, which counts the bytes on the receiving
// CTA's mbarrier, and each CTA waits on its own mbarrier alone. (A cluster
// barrier costs a GPU-wide memory fence and an L1 invalidation a call.)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void store_to_peer(uint32_t addr, float v,
                                              uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (tries > (1u << 20)) __trap();  // a lost store: fail, do not hang
  }
}

// Where the partial sums of one reduction meet: 2 buffers of CL x NW x 32
// floats and, in a cluster, one mbarrier per buffer that completes when
// all CL x NT floats of a call have arrived. buf alternates, so a CTA's
// stores into a buffer always find it read: a peer stores into buffer b
// for call e + 2 only after it received this CTA's stores of call e + 1,
// which each thread makes after reading buffer b for call e.
template <int NT, int CL>
struct Exchange {
  float* s_red;
  uint64_t* s_bar;
  int buf;
  uint32_t parity;  // bit b: the phase of buffer b's mbarrier to wait for

  __device__ void init() {
    buf = 0;
    parity = 0u;
    if constexpr (CL > 1) {
      if (threadIdx.x == 0) {
        for (int b = 0; b < 2; ++b)
          asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                       :: "r"(smem_u32(s_bar + b)) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      }
      cg::this_cluster().sync();  // every mbarrier is set before any store
    }
  }
};

// Sum v[0..NACC) over every thread of the cluster; every thread receives
// the same bits in tot. Each warp's lane l stores the warp's sum of entry
// l into slot [buf][its CTA's rank][warp][l] of every CTA; once they have
// all arrived each CTA adds its own copy in the same order.
template <int NT, int CL>
__device__ __forceinline__ void reduce_all(float (&v)[NRED],
                                           float (&tot)[NACC],
                                           Exchange<NT, CL>& ex) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // reduce-scatter: after the step of offset 16 >> s, v[0 .. 16 >> s)
  // hold this lane's half of the entries still left; v[0] ends as the
  // warp's sum of entry `lane`. Every loop has a constant trip count, so
  // all of v stays in registers.
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int off = 16 >> s;
    const bool hi = lane & off;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k < off) {
        const float send = hi ? v[k] : v[k + off];
        const float keep = hi ? v[k + off] : v[k];
        v[k] = keep + __shfl_xor_sync(FULL, send, off);
      }
    }
  }
  float* part = ex.s_red + ex.buf * (CL * NW * 32);
  const int slot = (cta_rank<CL>() * NW + warp) * 32 + lane;
  if constexpr (CL > 1) {
    const uint32_t bar = smem_u32(ex.s_bar + ex.buf);
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar), "r"((uint32_t)(CL * NT * sizeof(float)))
                   : "memory");
    const uint32_t dst = smem_u32(part + slot);
#pragma unroll
    for (int r = 0; r < CL; ++r)
      store_to_peer(peer_addr(dst, r), v[0], peer_addr(bar, r));
    wait_phase(bar, (ex.parity >> ex.buf) & 1u);
    ex.parity ^= 1u << ex.buf;
  } else {
    part[slot] = v[0];
    __syncthreads();
  }
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < CL * NW; ++w) t += part[w * 32 + lane];
  ex.buf ^= 1;
#pragma unroll
  for (int j = 0; j < NACC; ++j) tot[j] = __shfl_sync(FULL, t, j);
}

template <int P>
struct Points {
  float X0[P], X1[P], X2[P], u[P], v[P], is2[P];
  float wa[P];     // the round's active weight: invs2 * mask * active
  float chi2v[P];  // accepted pose
  float chi2c[P];  // candidate pose
  unsigned mask, posv, posc;  // bit k: point k
  int nk;                     // points k < nk exist
};

// One residual/Jacobian pass at (R, t): Gram + cost into acc, per-point
// chi2 and cheirality into chi2c / posc.
template <int P>
__device__ __forceinline__ void eval_points(const float (&R)[9],
                                            const float (&t)[3],
                                            Points<P>& p, const Cam& c,
                                            float (&acc)[NRED]) {
#pragma unroll
  for (int k = 0; k < NRED; ++k) acc[k] = 0.f;
  p.posc = 0u;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (k >= p.nk) continue;
    const float X0 = p.X0[k], X1 = p.X1[k], X2 = p.X2[k];
    const float xr = fmaf(R[0], X0, fmaf(R[1], X1, fmaf(R[2], X2, t[0])));
    const float yr = fmaf(R[3], X0, fmaf(R[4], X1, fmaf(R[5], X2, t[1])));
    const float zr = fmaf(R[6], X0, fmaf(R[7], X1, fmaf(R[8], X2, t[2])));
    const float z = fabsf(zr) < 1e-8f ? 1e-8f : zr;
    const float iz = 1.f / z;
    const float iz2 = iz * iz;
    const float rx = fmaf(c.fx * xr, iz, c.cx) - p.u[k];
    const float ry = fmaf(c.fy * yr, iz, c.cy) - p.v[k];
    const float chi2 = fmaf(rx, rx, ry * ry) * p.is2[k];
    const bool pos = zr > 0.05f;
    const float rn = sqrtf(fmaxf(chi2, 1e-12f));
    const float hw = rn <= c.delta ? 1.f : c.delta / rn;
    const float wa = p.wa[k];
    const float ww = wa * hw * (pos ? 1.f : 0.f);
    const float a0 = c.fx * iz, c0 = -c.fx * xr * iz2;
    const float b1 = c.fy * iz, c1 = -c.fy * yr * iz2;
    // J0[1] and J1[0] are zero: (0, 1) gets no term, row 0 only J0's,
    // row 1 only J1's
    const float J0[7] = {a0, 0.f, c0, c0 * yr, fmaf(a0, zr, -c0 * xr),
                         -a0 * yr, rx};
    const float J1[7] = {0.f, b1, c1, fmaf(c1, yr, -b1 * zr), -c1 * xr,
                         b1 * xr, ry};
    float W0[7], W1[7];
#pragma unroll
    for (int a = 0; a < 7; ++a) {
      W0[a] = ww * J0[a];
      W1[a] = ww * J1[a];
    }
#pragma unroll
    for (int a = 0; a < 7; ++a) {
#pragma unroll
      for (int b = 0; b < 7; ++b) {
        if (b < a || (a == 0 && b == 1)) continue;
        float s = acc[gidx(a, b)];
        if (a != 1) s = fmaf(W0[a], J0[b], s);
        if (a != 0) s = fmaf(W1[a], J1[b], s);
        acc[gidx(a, b)] = s;
      }
    }
    acc[NACC - 1] += wa > 0.f ? huber_rho(chi2, rn, c.delta) : 0.f;
    p.chi2c[k] = chi2;
    p.posc |= pos ? 1u << k : 0u;
  }
}

// Damped 6x6 Cholesky solve on the accepted system G, retraction
// exp(-x) * (R, t) and Gram-Schmidt, into (Rc, tc). Fully unrolled: every
// loop has a constant trip count, so every index is a compile-time
// constant and everything stays in registers. Its chain of dependent
// operations is what bounds it, so products are summed with explicit
// fmaf, and each square root and the divisions by it go through one
// rsqrtf (the Cholesky diagonal, the rotation angle, the Gram-Schmidt
// norms): 6 products with a reciprocal square root where the plain
// version takes 6 IEEE square roots and divides by them 27 times.
__device__ __forceinline__ void lm_step(const float (&G)[NACC], float lam,
                                        const float (&R)[9],
                                        const float (&t)[3], float (&Rc)[9],
                                        float (&tc)[3]) {
  float L[6][6], inv[6], y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (j > i) continue;
      float s = G[gidx(j, i)];
      if (i == j) s = s + fmaf(lam, G[gidx(i, i)], 1e-9f);
#pragma unroll
      for (int k = 0; k < 6; ++k)
        if (k < j) s = fmaf(-L[i][k], L[j][k], s);
      if (i == j) {
        inv[i] = rsqrtf(fmaxf(s, 1e-12f));
        L[i][i] = fmaxf(s, 1e-12f) * inv[i];
      } else {
        L[i][j] = s * inv[j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = G[gidx(i, 6)];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      if (k < i) s = fmaf(-L[i][k], y[k], s);
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      if (k > i) s = fmaf(-L[k][i], x[k], s);
    x[i] = s * inv[i];
  }
  const float rho[3] = {-x[0], -x[1], -x[2]};
  const float phi[3] = {-x[3], -x[4], -x[5]};
  const float ts = fmaf(phi[0], phi[0], fmaf(phi[1], phi[1], phi[2] * phi[2]));
  const bool small = ts < 1e-8f;
  const float safe_ts = small ? 1.f : ts;
  const float itheta = rsqrtf(safe_ts), theta = safe_ts * itheta;
  // sin and cos through sincospif: its range reduction is exact and needs
  // no local-memory table (sincosf's path for huge arguments does)
  float sn, cs;
  sincospif(theta * 0.318309886183790671f, &sn, &cs);
  const float ca = small ? 1.f - ts / 6.f : sn * itheta;
  const float cb = small ? 0.5f - ts / 24.f : (1.f - cs) * (itheta * itheta);
  const float cc = small ? 1.f / 6.f - ts / 120.f : (1.f - ca) * (itheta * itheta);
  const float K[3][3] = {{0.f, -phi[2], phi[1]},
                         {phi[2], 0.f, -phi[0]},
                         {-phi[1], phi[0], 0.f}};
  float dR[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float P2 = fmaf(phi[i], phi[j], i == j ? -ts : 0.f);  // K^2
      const float id = i == j ? 1.f : 0.f;
      dR[i][j] = fmaf(cb, P2, fmaf(ca, K[i][j], id));
      V[i][j] = fmaf(cc, P2, fmaf(cb, K[i][j], id));
    }
  float Rn[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Rn[i][j] = fmaf(dR[i][0], R[j],
                      fmaf(dR[i][1], R[3 + j], dR[i][2] * R[6 + j]));
    tc[i] = fmaf(dR[i][0], t[0], fmaf(dR[i][1], t[1], fmaf(dR[i][2], t[2],
            fmaf(V[i][0], rho[0], fmaf(V[i][1], rho[1], V[i][2] * rho[2])))));
  }
  // Gram-Schmidt on the columns
  float cx[3] = {Rn[0][0], Rn[1][0], Rn[2][0]};
  float cy[3] = {Rn[0][1], Rn[1][1], Rn[2][1]};
  const float inx = fminf(
      rsqrtf(fmaf(cx[0], cx[0], fmaf(cx[1], cx[1], cx[2] * cx[2]))), 1e12f);
#pragma unroll
  for (int i = 0; i < 3; ++i) cx[i] *= inx;
  const float d = fmaf(cx[0], cy[0], fmaf(cx[1], cy[1], cx[2] * cy[2]));
#pragma unroll
  for (int i = 0; i < 3; ++i) cy[i] = fmaf(-d, cx[i], cy[i]);
  const float iny = fminf(
      rsqrtf(fmaf(cy[0], cy[0], fmaf(cy[1], cy[1], cy[2] * cy[2]))), 1e12f);
#pragma unroll
  for (int i = 0; i < 3; ++i) cy[i] *= iny;
  const float cz[3] = {fmaf(cx[1], cy[2], -cx[2] * cy[1]),
                       fmaf(cx[2], cy[0], -cx[0] * cy[2]),
                       fmaf(cx[0], cy[1], -cx[1] * cy[0])};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Rc[3 * i] = cx[i];
    Rc[3 * i + 1] = cy[i];
    Rc[3 * i + 2] = cz[i];
  }
}

template <int NT, int P, int CL>
__global__ void __launch_bounds__(NT, 1) pose_opt_kernel(const Args a) {
  __shared__ float s_red[2 * CL * NT];  // 2 x CL CTAs x NW warps x 32 lanes
  __shared__ uint64_t s_bar[2];
  Exchange<NT, CL> ex{s_red, s_bar};
  ex.init();
  const Cam& c = a.c;
  const int rank = cta_rank<CL>();
  const int g = rank * NT + threadIdx.x;
  constexpr int S = NT * CL;  // stride between a thread's points

  Points<P> p;
  p.nk = g < a.N ? min(P, (a.N - g + S - 1) / S) : 0;
  p.mask = 0u;
  p.posv = ~0u;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = g + k * S;
    const bool in = k < p.nk;
    p.X0[k] = in ? a.X[3 * i] : 0.f;
    p.X1[k] = in ? a.X[3 * i + 1] : 0.f;
    p.X2[k] = in ? a.X[3 * i + 2] : 0.f;
    p.u[k] = in ? a.uv[2 * i] : 0.f;
    p.v[k] = in ? a.uv[2 * i + 1] : 0.f;
    p.is2[k] = in ? a.invs2[i] : 0.f;
    p.mask |= (in && a.mask[i]) ? 1u << k : 0u;
    p.chi2v[k] = 0.f;
  }
  float R[9], t[3], Rc[9], tc[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = a.R0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = a.t0[k];

  float acc[NRED], G[NACC], Gc[NACC];
  float lam = 1e-3f;
  for (int rnd = 0; rnd < a.n_rounds; ++rnd) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const bool m = (p.mask >> k) & 1u;
      const bool act = rnd == 0 || (p.chi2v[k] <= c.chi2_th &&
                                    ((p.posv >> k) & 1u));
      p.wa[k] = m && act ? p.is2[k] : 0.f;
    }
    eval_points<P>(R, t, p, c, acc);
    reduce_all<NT, CL>(acc, G, ex);
#pragma unroll
    for (int k = 0; k < P; ++k) p.chi2v[k] = p.chi2c[k];
    p.posv = p.posc;
    for (int it = 0; it < a.iters; ++it) {
      lm_step(G, lam, R, t, Rc, tc);
      eval_points<P>(Rc, tc, p, c, acc);
      reduce_all<NT, CL>(acc, Gc, ex);
      const bool better = Gc[NACC - 1] < G[NACC - 1];  // same bits everywhere
      if (better) {
#pragma unroll
        for (int k = 0; k < 9; ++k) R[k] = Rc[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) t[k] = tc[k];
#pragma unroll
        for (int k = 0; k < NACC; ++k) G[k] = Gc[k];
#pragma unroll
        for (int k = 0; k < P; ++k) p.chi2v[k] = p.chi2c[k];
        p.posv = p.posc;
      }
      lam = fminf(fmaxf(better ? lam * 0.5f : lam * 4.f, 1e-7f), 1e2f);
    }
  }

#pragma unroll
  for (int k = 0; k < NRED; ++k) acc[k] = 0.f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (k >= p.nk) continue;
    const float chi2 = p.chi2v[k];
    const bool inl = chi2 <= c.chi2_th && ((p.posv >> k) & 1u) &&
                     ((p.mask >> k) & 1u);
    a.inl_out[g + k * S] = inl ? 1 : 0;
    if (inl) {
      acc[0] += huber_rho(chi2, sqrtf(fmaxf(chi2, 1e-12f)), c.delta);
      acc[1] += 1.f;
    }
  }
  // no CTA touches another's shared memory after the last barrier, so each
  // may exit as soon as it is done
  reduce_all<NT, CL>(acc, G, ex);
  if (g == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) a.pose_out[k] = R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) a.pose_out[9 + k] = t[k];
    a.pose_out[12] = G[0];
    a.pose_out[13] = G[1];
    a.pose_out[14] = 0.f;
    a.pose_out[15] = 0.f;
    *a.n_inl_out = (int)G[1];
  }
}

// The latency floor: n reductions of 29 sums and their broadcast, each
// depending on the last, in the launch shape of a plan.
template <int NT, int CL>
__global__ void __launch_bounds__(NT, 1) pose_floor_kernel(int n,
                                                           float* out) {
  __shared__ float s_red[2 * CL * NT];
  __shared__ uint64_t s_bar[2];
  Exchange<NT, CL> ex{s_red, s_bar};
  ex.init();
  float v[NRED], tot[NACC];
#pragma unroll
  for (int k = 0; k < NRED; ++k) v[k] = k < NACC ? (float)threadIdx.x : 0.f;
  for (int e = 0; e < n; ++e) {
    reduce_all<NT, CL>(v, tot, ex);
#pragma unroll
    for (int k = 0; k < NRED; ++k) v[k] = k < NACC ? tot[k] * 1e-3f : 0.f;
  }
  if (cta_rank<CL>() == 0 && threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NACC; ++k) s += tot[k];
    *out = s;
  }
}

// One CTA, or one cluster of cl CTAs, of nt threads on stream st.
template <typename... Params, typename... Actual>
static cudaError_t launch_on(void (*kernel)(Params...), int nt, int cl,
                             cudaStream_t st, Actual... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Launch the plan (nt threads, p points a thread, cl CTAs a cluster);
// returns a CUDA error code (invalid value for a plan that is not
// instantiated or too small for N).
extern "C" int pose_opt_launch(const float* R0, const float* t0,
                               const float* X, const float* uv,
                               const float* invs2, const uint8_t* mask,
                               int N, float fx, float fy, float cx, float cy,
                               float delta, float chi2_th, int n_rounds,
                               int iters, int nt, int p, int cl,
                               float* pose_out, int* n_inl_out,
                               uint8_t* inl_out, void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  const Args a{R0, t0, X, uv, invs2, mask, N,
               Cam{fx, fy, cx, cy, delta, chi2_th}, n_rounds, iters,
               pose_out, n_inl_out, inl_out};
  const cudaStream_t st = (cudaStream_t)stream;
#define POSE_CASE(NT_, P_, CL_)                                        \
  if (nt == NT_ && p == P_ && cl == CL_) {                             \
    if (N > NT_ * P_ * CL_) return (int)cudaErrorInvalidValue;         \
    return (int)launch_on(pose_opt_kernel<NT_, P_, CL_>, NT_, CL_, st, \
                          a);                                          \
  }
  POSE_PLANS(POSE_CASE)
#undef POSE_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int pose_floor_launch(int nt, int cl, int n, float* out,
                                 void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define FLOOR_CASE(NT_, P_, CL_)                                            \
  if (nt == NT_ && cl == CL_)                                               \
    return (int)launch_on(pose_floor_kernel<NT_, CL_>, NT_, CL_, st, n, out);
  POSE_PLANS(FLOOR_CASE)
#undef FLOOR_CASE
  return (int)cudaErrorInvalidValue;
}
