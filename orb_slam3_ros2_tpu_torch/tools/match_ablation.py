"""Where the windowed match kernel's time goes: build `csrc/fused_match.cu`
in several launch plans, and beside it the grid-wide designs of the mutual
check that its in-block check replaced, and time each on the card.

    python -m orb_slam3_ros2_tpu_torch.tools.match_ablation \\
        [--matches track:1000x4096 track:2000x4096 fuse:1000x8192]

Variants (each built from the source with its `MATCH_PLANS` set to every
plan below, the grid-wide ones appended; nvcc into
`build/kernels/ablation/`):

  full     the kernel as it is: each block of RB rows sweeps all M columns,
           then all N rows against the columns its rows chose (the mutual
           check inside the block)
  floor    the same launch with both sweeps taken out: owner loads,
           reductions and acceptance (`match_floor_launch`)
  handoff  the mutual check across the grid, (a): the row blocks stop
           before it, column blocks of GRID_CB columns sweep all N rows
           for their argmins, and the last block to count itself done on
           a counter runs the check for all N rows
  coop     the same with (b): a cooperative launch, one grid barrier, then
           each row block checks its own rows (where the card holds the
           grid at once; else it prints the launch error)
  atomic   column argmins by atomicMin of a 32-bit key (distance << 22 |
           row) from the row blocks' pairs inside the window, into a key
           buffer that the last block reads and then resets (no column
           blocks)

handoff, coop and atomic run the mutual cases only. Plans (threads per
block, rows per block, entries in flight a thread): `PLANS`.

Prints one JSON line per case, plan and variant: device µs per launch
(torch.profiler over 50 launches, the kernel's own device time), and
whether idx, valid and dist agree exactly with the plain version (expected
for all but floor), after a line per build with ptxas' registers. The
variants are measurements, never used by the port.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import torch

from orb_slam3_ros2_tpu_torch.ops import cuda_lib
from orb_slam3_ros2_tpu_torch.ops import fused_match as fm
from orb_slam3_ros2_tpu_torch.tools.kernel_timing import (device_events,
                                                          match_tensors)

PLANS = ((256, 4, 4), (256, 8, 2), (256, 8, 4), (512, 4, 2), (512, 8, 1),
         (512, 8, 2), (512, 16, 2), (1024, 8, 1), (1024, 8, 2))
GRID_CB = 16  # columns a column block of the handoff designs

GRID = r"""
#include <cooperative_groups.h>

#define GRID_CB %d

struct Grid {            // what the grid-wide designs add to Args
  int n_row_blocks;
  int* cidx;             // (M,) column argmins
  unsigned* counter;     // blocks done; 0 between launches
  unsigned* colkey;      // (M,) atomic keys; NO_KEY between launches
};

// Rows before the mutual check: idx / valid as if it passed.
template <int T, int RB, int U, class Hook = NoHook>
__device__ __forceinline__ void rows_only(const Args& a, int r0,
                                          Hook hook = Hook()) {
  __shared__ RowBlock<T, RB> sh;
  int j;
  const bool ok = rows_top2<T, RB, U, true>(a, r0, sh, j, hook);
  const int o = r0 + threadIdx.x;
  if (threadIdx.x < RB && o < a.rows.n) {
    a.idx[o] = ok ? j : -1;
    a.valid[o] = ok;
  }
}

// Argmins over all N rows of columns c0 + g, g < CB.
template <int T, int CB, int U>
__device__ __forceinline__ void col_argmins(const Args& a, const Grid& x,
                                            int c0) {
  __shared__ uint4 s_bits[CB][2];
  __shared__ float2 s_uv[CB];
  __shared__ unsigned s_key[T / 32][CB];
  __shared__ int s_ent[CB];
  const int c = c0 + (int)threadIdx.x;
  if (threadIdx.x < CB) s_ent[threadIdx.x] = c < a.cols.n ? c : -1;
  __syncthreads();
  load_owners<CB>(a.cols, s_ent, s_bits, s_uv);
  unsigned key[CB], unused[CB];
#pragma unroll
  for (int k = 0; k < CB; ++k) key[k] = unused[k] = NO_KEY;
  __syncthreads();
  sweep<T, CB, U, false>(a.rows, a.radius, s_bits, s_uv, key, unused);
  unsigned K, S;
  block_min<T, CB, false>(key, unused, s_key, s_key, K, S);
  if (threadIdx.x < CB && c < a.cols.n) x.cidx[c] = (int)(K & IDX_MASK);
}

// Count this block done; true in the block that finishes last.
__device__ __forceinline__ bool last_block(unsigned* counter) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicInc(counter, gridDim.x - 1) == gridDim.x - 1;
    if (s_last) __threadfence();
  }
  __syncthreads();
  return s_last;
}

// The mutual check of all N rows, 8 rows a thread in flight, against
// cidx or (where given) the atomic keys.
template <int T>
__device__ __forceinline__ void accept_all(const Args& a, const int* cidx,
                                           const unsigned* colkey) {
  constexpr int R = 8;
  for (int i0 = threadIdx.x; i0 < a.rows.n; i0 += T * R) {
    int j[R], c[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      j[r] = i0 + r * T < a.rows.n ? __ldcg(a.idx + i0 + r * T) : -1;
#pragma unroll
    for (int r = 0; r < R; ++r)
      c[r] = colkey ? (int)(__ldcg(colkey + max(j[r], 0)) & IDX_MASK)
                    : __ldcg(cidx + max(j[r], 0));
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (j[r] >= 0 && c[r] != i0 + r * T) {
        a.idx[i0 + r * T] = -1;
        a.valid[i0 + r * T] = 0;
      }
  }
}

template <int T, int RB, int U>
__global__ void __launch_bounds__(T) match_handoff_kernel(const Args a,
                                                          const Grid x) {
  if ((int)blockIdx.x < x.n_row_blocks)
    rows_only<T, RB, U>(a, blockIdx.x * RB);
  else
    col_argmins<T, GRID_CB, U>(a, x,
                               (blockIdx.x - x.n_row_blocks) * GRID_CB);
  if (last_block(x.counter)) accept_all<T>(a, x.cidx, nullptr);
}

template <int T, int RB, int U>
__global__ void __launch_bounds__(T) match_coop_kernel(const Args a,
                                                       const Grid x) {
  const bool row = (int)blockIdx.x < x.n_row_blocks;
  if (row)
    rows_only<T, RB, U>(a, blockIdx.x * RB);
  else
    col_argmins<T, GRID_CB, U>(a, x,
                               (blockIdx.x - x.n_row_blocks) * GRID_CB);
  cooperative_groups::this_grid().sync();
  const int i = blockIdx.x * RB + threadIdx.x;
  if (row && threadIdx.x < RB && i < a.rows.n) {
    const int j = __ldcg(a.idx + i);
    if (j >= 0 && __ldcg(x.cidx + j) != i) {
      a.idx[i] = -1;
      a.valid[i] = 0;
    }
  }
}

struct ColKeyHook {  // a row block's allowed pair into its column's key
  unsigned* colkey;
  int r0;
  __device__ void operator()(int g, int j, unsigned d) const {
    atomicMin(colkey + j, d << IDX_BITS | (unsigned)(r0 + g));
  }
};

template <int T, int RB, int U>
__global__ void __launch_bounds__(T) match_atomic_kernel(const Args a,
                                                         const Grid x) {
  const int r0 = blockIdx.x * RB;
  rows_only<T, RB, U>(a, r0, ColKeyHook{x.colkey, r0});
  if (!last_block(x.counter)) return;
  accept_all<T>(a, nullptr, x.colkey);
  __syncthreads();
  for (int j = threadIdx.x; j < a.cols.n; j += T) x.colkey[j] = NO_KEY;
}

// Each takes the kernel's arguments and (cidx, counter, colkey); mutual
// only.
#define GRID_ARGS(RB_)                                                       \
  Args a;                                                                    \
  if (!make_args(a, MATCH_ARGS) || !mutual)                                  \
    return (int)cudaErrorInvalidValue;                                       \
  const Grid x{(N + RB_ - 1) / RB_, cidx, counter, colkey};                  \
  const int n_col_blocks = (M + GRID_CB - 1) / GRID_CB;                      \
  const cudaStream_t st = (cudaStream_t)stream;

#define GRID_PARAMS MATCH_PARAMS, int *cidx, unsigned *counter, unsigned *colkey

extern "C" int match_handoff_launch(GRID_PARAMS) {
#define HANDOFF_CASE(T_, RB_, U_)                                            \
  if (nt == T_ && rb == RB_ && u == U_) {                                    \
    GRID_ARGS(RB_)                                                           \
    match_handoff_kernel<T_, RB_, U_>                                        \
        <<<x.n_row_blocks + n_col_blocks, T_, 0, st>>>(a, x);                \
    return (int)cudaGetLastError();                                          \
  }
  MATCH_PLANS(HANDOFF_CASE)
  return (int)cudaErrorInvalidValue;
}

extern "C" int match_coop_launch(GRID_PARAMS) {
#define COOP_CASE(T_, RB_, U_)                                               \
  if (nt == T_ && rb == RB_ && u == U_) {                                    \
    GRID_ARGS(RB_)                                                           \
    void* params[] = {(void*)&a, (void*)&x};                                 \
    const cudaError_t e = cudaLaunchCooperativeKernel(                       \
        (void*)match_coop_kernel<T_, RB_, U_>,                               \
        dim3(x.n_row_blocks + n_col_blocks), dim3(T_), params, 0, st);       \
    if (e != cudaSuccess) cudaGetLastError(); /* not the next launch's */   \
    return (int)(e != cudaSuccess ? e : cudaGetLastError());                 \
  }
  MATCH_PLANS(COOP_CASE)
  return (int)cudaErrorInvalidValue;
}

extern "C" int match_atomic_launch(GRID_PARAMS) {
#define ATOMIC_CASE(T_, RB_, U_)                                             \
  if (nt == T_ && rb == RB_ && u == U_) {                                    \
    GRID_ARGS(RB_)                                                           \
    (void)n_col_blocks;                                                      \
    match_atomic_kernel<T_, RB_, U_><<<x.n_row_blocks, T_, 0, st>>>(a, x);   \
    return (int)cudaGetLastError();                                          \
  }
  MATCH_PLANS(ATOMIC_CASE)
  return (int)cudaErrorInvalidValue;
}
""" % GRID_CB
def with_plans(src: str, plans) -> str:
    """src with `MATCH_PLANS` instantiating exactly `plans`."""
    line = re.search(r"#define MATCH_PLANS\(X\)[^\n]*\n", src)
    if line is None:
        raise ValueError("the kernel no longer defines MATCH_PLANS")
    body = " ".join(f"X({', '.join(map(str, p))})" for p in plans)
    return src.replace(line.group(0), f"#define MATCH_PLANS(X) {body}\n")


def variants(src: str) -> dict:
    """library name -> source: the kernel with every plan of PLANS, and
    the same with the grid-wide designs appended."""
    base = with_plans(src, PLANS)
    return {"base": base, "grid": base + GRID}


LAUNCH = fm._SIGNATURES["match_window_launch"]
ENTRIES = {  # variant -> (library, C entry point, kernel name)
    "full": ("base", "match_window_launch", "match_window_kernel"),
    "floor": ("base", "match_floor_launch", "match_window_kernel"),
    "handoff": ("grid", "match_handoff_launch", "match_handoff_kernel"),
    "coop": ("grid", "match_coop_launch", "match_coop_kernel"),
    "atomic": ("grid", "match_atomic_launch", "match_atomic_kernel"),
}
# the atomic key of a column that no row reaches (NO_KEY of the source)
NO_KEY = 512 << 22


def build(sources: dict) -> dict:
    """nvcc every source at once; name -> the loaded library, or the
    compiler's output where the build failed. Prints ptxas' lines."""
    out_dir = cuda_lib.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"match_{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
             str(out_dir / f"libmatch_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            libs[name] = log
            continue
        print(json.dumps(dict(library=name, ptxas=[
            line.strip() for line in log.splitlines()
            if "entry function" in line or "stack frame" in line
            or "registers" in line])))
        lib = ctypes.CDLL(str(out_dir / f"libmatch_{name}.so"))
        for _, (lib_name, entry, _) in ENTRIES.items():
            if lib_name == name:
                fn = getattr(lib, entry)
                extra = [ctypes.c_void_p] * 3 if name == "grid" else []
                fn.restype, fn.argtypes = LAUNCH[0], LAUNCH[1] + extra
        libs[name] = lib
    return libs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--matches", nargs="+",
                    default=["track:1000x4096", "track:2000x4096",
                             "fuse:1000x8192"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("times the card: no CUDA device is available")
    libs = build(variants((cuda_lib.CSRC / "fused_match.cu").read_text()))
    for name, lib in libs.items():
        if isinstance(lib, str):
            print(json.dumps(dict(library=name, build_error=lib[-3000:])))
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    for case in args.matches:
        setting, shape = case.split(":")
        N, M = (int(v) for v in shape.split("x"))
        call_args, kw = match_tensors(N, M, setting, N + M, dev)
        ref = fm.match_window_ref(*call_args, **kw)
        inputs, (idx, dist, valid) = fm.launch_args(*call_args)
        p = [t.data_ptr() for t in inputs]
        cidx = torch.empty((M,), dtype=torch.int32, device=dev)
        colkey = torch.full((M,), NO_KEY - (1 << 32), dtype=torch.int32,
                            device=dev)  # NO_KEY's bits as int32
        grid = [cidx.data_ptr(), counter.data_ptr(), colkey.data_ptr()]
        ratio = kw["ratio"]
        for plan in PLANS:
            for variant, (lib_name, entry, kernel) in ENTRIES.items():
                lib = libs[lib_name]
                if isinstance(lib, str) or (lib_name == "grid"
                                            and not kw["mutual"]):
                    continue
                extra = grid if lib_name == "grid" else []

                def launch():
                    return getattr(lib, entry)(
                        p[0], p[1], p[2], N, p[3], p[4], p[5], M,
                        kw["radius"], kw["max_dist"],
                        0.0 if ratio is None else ratio, ratio is not None,
                        kw["mutual"], *plan, idx.data_ptr(),
                        dist.data_ptr(), valid.data_ptr(), stream, *extra)

                row = dict(case=case, threads=plan[0], rows_per_block=plan[1],
                           in_flight=plan[2], variant=variant)
                err = launch()
                torch.cuda.synchronize()
                if err != 0:
                    print(json.dumps(dict(row, cuda_error=err)))
                    continue
                agrees = (torch.equal(idx, ref.idx)
                          and torch.equal(valid, ref.valid)
                          and torch.equal(dist, ref.dist))
                dev_ms, _ = device_events(launch, (kernel,), calls=50)
                print(json.dumps(dict(
                    row, device_us=None if dev_ms is None else dev_ms * 1e3,
                    agrees_with_plain=agrees)), flush=True)


if __name__ == "__main__":
    main()
