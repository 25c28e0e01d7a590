"""Where the pose LM kernel's time goes: build variants of
`csrc/pose_opt_fused.cu` with one part changed, and time each on the card
in several launch plans.

    python -m orb_slam3_ros2_tpu_torch.tools.pose_ablation [--points 1000 2000]

Variants (each a copy of the source with one edit, built by nvcc into
`build/kernels/ablation/`):

  full           the kernel as it is: every thread runs the solve, with
                 fmaf and rsqrtf
  thread0_solve  thread 0 of each block runs the solve and publishes the
                 candidate pose through shared memory behind one more
                 barrier (the parent design's solve)
  no_solve       the solve replaced by a copy of the accepted pose: the
                 point passes and the reductions alone (the skeleton)
  div_solve      the solve as the plain version computes it: IEEE square
                 roots, 27 IEEE divisions by a Cholesky diagonal entry, no
                 fmaf
  sqrt_solve     the kernel's solve with IEEE square roots and one IEEE
                 reciprocal of each (Cholesky diagonal, rotation angle,
                 Gram-Schmidt norms) where it takes rsqrtf

Plans (threads per block, points per thread, blocks per cluster): at
N <= 1024 one block of 128 x 8 or 256 x 4 against clusters of 2, 4 and 8
blocks of 128 or 256 threads; at N <= 2048 one block of 256 x 8 against
the same clusters with twice the points a thread; at N <= 4096 clusters
of 4 and 8. Each variant instantiates all of them.
For each plan the latency floor too: the same launch doing only the 18
reduce-and-broadcasts (`pose_floor_launch`).

Prints one JSON line per variant, N and plan: device µs per launch
(torch.profiler over 50 launches, the kernel's own device time), and
whether R, t and the inliers agree with the plain version (R atol 5e-5, t
atol 5e-4, identical inliers; expected for full and thread0_solve). The
variants are measurements, never used by the port.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import torch

from orb_slam3_ros2_tpu_torch.backend import pose_opt
from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused as pof
from orb_slam3_ros2_tpu_torch.backend import residuals as res
from orb_slam3_ros2_tpu_torch.ops import cuda_lib
from orb_slam3_ros2_tpu_torch.tools.kernel_timing import (device_events,
                                                          pose_case)

SOLVE_CALL = "      lm_step(G, lam, R, t, Rc, tc);\n"
THREAD0_SOLVE = """      {
        __shared__ float s_pose[12];
        if (threadIdx.x == 0) {
          lm_step(G, lam, R, t, Rc, tc);
          for (int k = 0; k < 9; ++k) s_pose[k] = Rc[k];
          for (int k = 0; k < 3; ++k) s_pose[9 + k] = tc[k];
        }
        __syncthreads();
        for (int k = 0; k < 9; ++k) Rc[k] = s_pose[k];
        for (int k = 0; k < 3; ++k) tc[k] = s_pose[9 + k];
      }
"""
DIV_SOLVE = r"""// lm_step as the plain version computes it: 27 IEEE divisions by the
// Cholesky diagonal, products and sums rounded one by one
__device__ __forceinline__ void lm_step_div(const float (&G)[NACC], float lam,
                                        const float (&R)[9],
                                        const float (&t)[3], float (&Rc)[9],
                                        float (&tc)[3]) {
  float L[6][6], y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (j > i) continue;
      float s = G[gidx(j, i)];
      if (i == j) s = s + (lam * G[gidx(i, i)] + 1e-9f);
#pragma unroll
      for (int k = 0; k < 6; ++k)
        if (k < j) s -= L[i][k] * L[j][k];
      if (i == j)
        L[i][j] = sqrtf(fmaxf(s, 1e-12f));
      else
        L[i][j] = s / L[j][j];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = G[gidx(i, 6)];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      if (k < i) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      if (k > i) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
  const float rho[3] = {-x[0], -x[1], -x[2]};
  const float phi[3] = {-x[3], -x[4], -x[5]};
  const float ts = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const bool small = ts < 1e-8f;
  const float safe_ts = small ? 1.f : ts;
  const float theta = sqrtf(safe_ts);
  // sin and cos through sincospif: its range reduction is exact and needs
  // no local-memory table (sincosf's path for huge arguments does)
  float sn, cs;
  sincospif(theta * 0.318309886183790671f, &sn, &cs);
  const float ca = small ? 1.f - ts / 6.f : sn / theta;
  const float cb = small ? 0.5f - ts / 24.f : (1.f - cs) / safe_ts;
  const float cc = small ? 1.f / 6.f - ts / 120.f : (1.f - ca) / safe_ts;
  const float K[3][3] = {{0.f, -phi[2], phi[1]},
                         {phi[2], 0.f, -phi[0]},
                         {-phi[1], phi[0], 0.f}};
  float dR[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float P2 = phi[i] * phi[j] - (i == j ? ts : 0.f);  // K^2
      const float id = i == j ? 1.f : 0.f;
      dR[i][j] = id + ca * K[i][j] + cb * P2;
      V[i][j] = id + cb * K[i][j] + cc * P2;
    }
  float Rn[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Rn[i][j] = dR[i][0] * R[j] + dR[i][1] * R[3 + j] + dR[i][2] * R[6 + j];
    tc[i] = dR[i][0] * t[0] + dR[i][1] * t[1] + dR[i][2] * t[2] +
            (V[i][0] * rho[0] + V[i][1] * rho[1] + V[i][2] * rho[2]);
  }
  // Gram-Schmidt on the columns
  float cx[3] = {Rn[0][0], Rn[1][0], Rn[2][0]};
  float cy[3] = {Rn[0][1], Rn[1][1], Rn[2][1]};
  const float nx =
      fmaxf(sqrtf(cx[0] * cx[0] + cx[1] * cx[1] + cx[2] * cx[2]), 1e-12f);
#pragma unroll
  for (int i = 0; i < 3; ++i) cx[i] /= nx;
  const float d = cx[0] * cy[0] + cx[1] * cy[1] + cx[2] * cy[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) cy[i] -= d * cx[i];
  const float ny =
      fmaxf(sqrtf(cy[0] * cy[0] + cy[1] * cy[1] + cy[2] * cy[2]), 1e-12f);
#pragma unroll
  for (int i = 0; i < 3; ++i) cy[i] /= ny;
  const float cz[3] = {cx[1] * cy[2] - cx[2] * cy[1],
                       cx[2] * cy[0] - cx[0] * cy[2],
                       cx[0] * cy[1] - cx[1] * cy[0]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Rc[3 * i] = cx[i];
    Rc[3 * i + 1] = cy[i];
    Rc[3 * i + 2] = cz[i];
  }
}

"""
CTA_RANK = "template <int CL>\n__device__ __forceinline__ int cta_rank()"
SQRT_EDITS = tuple((new, old) for old, new in (
    ("""        L[i][i] = sqrtf(fmaxf(s, 1e-12f));
        inv[i] = 1.f / L[i][i];
""", """        inv[i] = rsqrtf(fmaxf(s, 1e-12f));
        L[i][i] = fmaxf(s, 1e-12f) * inv[i];
"""),
    ("""  const float theta = sqrtf(safe_ts);
""", """  const float itheta = rsqrtf(safe_ts), theta = safe_ts * itheta;
"""),
    ("sn / theta", "sn * itheta"),
    ("(1.f - cs) / safe_ts", "(1.f - cs) * (itheta * itheta)"),
    ("(1.f - ca) / safe_ts", "(1.f - ca) * (itheta * itheta)"),
    ("""  const float nx = fmaxf(
      sqrtf(fmaf(cx[0], cx[0], fmaf(cx[1], cx[1], cx[2] * cx[2]))), 1e-12f);
#pragma unroll
  for (int i = 0; i < 3; ++i) cx[i] /= nx;
""", """  const float inx = fminf(
      rsqrtf(fmaf(cx[0], cx[0], fmaf(cx[1], cx[1], cx[2] * cx[2]))), 1e12f);
#pragma unroll
  for (int i = 0; i < 3; ++i) cx[i] *= inx;
"""),
    ("""  const float ny = fmaxf(
      sqrtf(fmaf(cy[0], cy[0], fmaf(cy[1], cy[1], cy[2] * cy[2]))), 1e-12f);
#pragma unroll
  for (int i = 0; i < 3; ++i) cy[i] /= ny;
""", """  const float iny = fminf(
      rsqrtf(fmaf(cy[0], cy[0], fmaf(cy[1], cy[1], cy[2] * cy[2]))), 1e12f);
#pragma unroll
  for (int i = 0; i < 3; ++i) cy[i] *= iny;
"""),
))
COPY_POSE = """      for (int k = 0; k < 9; ++k) Rc[k] = R[k];
      for (int k = 0; k < 3; ++k) tc[k] = t[k];
"""
PLANS = {1024: ((128, 8, 1), (256, 4, 1), (128, 4, 2), (256, 2, 2),
                (128, 2, 4), (256, 1, 4), (128, 1, 8)),
         2048: ((256, 8, 1), (128, 8, 2), (256, 4, 2), (128, 4, 4),
                (256, 2, 4), (128, 2, 8), (256, 1, 8)),
         4096: ((128, 8, 4), (256, 4, 4), (128, 4, 8), (256, 2, 8))}
N_REDUCTIONS = 3 * (1 + 5)


def with_plans(src: str, plans) -> str:
    """src with `POSE_PLANS` instantiating exactly `plans`."""
    block = re.search(r"#define POSE_PLANS\(X\)(?:[^\n]*\\\n)*[^\n]*\n", src)
    if block is None:
        raise ValueError("the kernel no longer defines POSE_PLANS")
    body = " ".join(f"X({nt}, {p}, {cl})" for nt, p, cl in plans)
    return src.replace(block.group(0), f"#define POSE_PLANS(X) {body}\n")


def variants(src: str) -> dict:
    """name -> source, each instantiating every plan of PLANS; each edit
    must apply exactly once."""
    src = with_plans(src, sorted({p for v in PLANS.values() for p in v}))

    def edit(text, *pairs):
        for old, new in pairs:
            if text.count(old) != 1:
                raise ValueError(f"the kernel no longer holds {old!r}")
            text = text.replace(old, new)
        return text

    return {"full": src,
            "thread0_solve": edit(src, (SOLVE_CALL, THREAD0_SOLVE)),
            "no_solve": edit(src, (SOLVE_CALL, COPY_POSE)),
            "div_solve": edit(
                src, (CTA_RANK, DIV_SOLVE + CTA_RANK),
                (SOLVE_CALL, SOLVE_CALL.replace("lm_step(", "lm_step_div("))),
            "sqrt_solve": edit(src, *SQRT_EDITS)}


def build(sources: dict) -> dict:
    """nvcc every variant at once; name -> the loaded library."""
    out_dir = cuda_lib.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"pose_{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
             str(out_dir / f"libpose_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"libpose_{name}.so"))
        for fn_name, (restype, argtypes) in pof._SIGNATURES.items():
            fn = getattr(lib, fn_name)
            fn.restype, fn.argtypes = restype, argtypes
        libs[name] = lib
    return libs


def us(ms):
    """µs from the profiler's ms (None where it saw no event)."""
    return None if ms is None else ms * 1e3


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", nargs="+", type=int, default=[1000, 2000])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("times the card: no CUDA device is available")
    libs = build(variants((cuda_lib.CSRC / "pose_opt_fused.cu").read_text()))
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for N in args.points:
        X, uv, invs2, mask, K, _, _ = pose_case(N, seed=N)
        host = [torch.eye(3), torch.zeros(3)] + [
            torch.from_numpy(a) for a in (X, uv, invs2, mask)]
        on_dev = [a.to(dev) for a in host]
        ref = pose_opt.optimize_pose(*on_dev, *K)
        inputs, outputs = pof.launch_args(*on_dev)
        plans = next(v for cap, v in sorted(PLANS.items()) if N <= cap)
        for nt, p, cl in plans:
            plan = dict(threads=nt, points_per_thread=p, cluster=cl)
            for name, lib in libs.items():
                def launch():
                    cuda_lib.check(lib.pose_opt_launch(
                        *(t.data_ptr() for t in inputs), N, *map(float, K),
                        pose_opt.HUBER_MONO, res.CHI2_MONO, 3, 5,
                        nt, p, cl, *(t.data_ptr() for t in outputs), stream),
                        name)

                launch()
                torch.cuda.synchronize()
                pose_out, n_inl, inl = outputs
                agrees = (
                    (pose_out[:9].view(3, 3) - ref.R).abs().max().item() <= 5e-5
                    and (pose_out[9:12] - ref.t).abs().max().item() <= 5e-4
                    and bool((inl == ref.inliers).all())
                    and int(n_inl) == int(ref.n_inliers))
                dev_ms, _ = device_events(launch, ("pose_opt_kernel",),
                                          calls=50)
                print(json.dumps(dict(points=N, variant=name, **plan,
                                      device_us=us(dev_ms),
                                      agrees_with_plain=agrees)))
            out = torch.empty((), dtype=torch.float32, device=dev)
            floor_ms, _ = device_events(
                lambda: cuda_lib.check(libs["full"].pose_floor_launch(
                    nt, cl, N_REDUCTIONS, out.data_ptr(), stream), "floor"),
                ("pose_floor_kernel",), calls=50)
            print(json.dumps(dict(points=N, variant="latency_floor", **plan,
                                  device_us=us(floor_ms))))


if __name__ == "__main__":
    main()
