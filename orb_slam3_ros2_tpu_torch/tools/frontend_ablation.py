"""Where the packed frontend kernel's time goes: build variants of
`csrc/frontend_packed.cu` with one part taken out and time each on the card.

    python -m orb_slam3_ros2_tpu_torch.tools.frontend_ablation \\
        [--shapes 752x480 1241x376]

Variants (each a copy of the source with one edit, built by nvcc into
`build/kernels/ablation/`):

  full           the kernel as it is
  float_minmax   the FAST score by 2-input float min/max on the pixels
                 (158 a pixel) instead of 3-input DPX min/max on keys (80)
  no_score       the score replaced by the centre pixel (no ring, no
                 min/max); staging, blur, NMS and stores kept
  no_stores      the tiles' global stores never taken (the zero-fill kept)
  zero_fill_only the tile blocks return at once: only the cells outside the
                 levels are written

Prints one JSON line per variant and shape: device µs per launch
(torch.profiler over 50 launches, the kernel's own device time), and
whether score and raw equal the plain version's (expected for full and
float_minmax only). The variants are measurements, never used by the port.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from orb_slam3_ros2_tpu_torch.io.synthetic import render_sequence
from orb_slam3_ros2_tpu_torch.ops import cuda_lib
from orb_slam3_ros2_tpu_torch.ops import frontend_packed as fp
from orb_slam3_ros2_tpu_torch.ops import pyramid as pyr
from orb_slam3_ros2_tpu_torch.tools.kernel_timing import device_events

SCORE_CALL = "s = fast_score(s_key, s_img[cy][cx], cy, cx);"
TILE_STORE = "if (xs >= x0 && xs + 4 <= x0 + TW && xs + 4 <= p.W) {"
TILE_CELL_STORE = "        if (xs + j >= x0 && xs + j < xe) {"
TILE_CALL = "    process_tile(p, b, score_out, keep_out, blur_out, raw_out);"
FLOAT_SCORE = """
__device__ __forceinline__ float fast_score_float(const float (*s)[SW],
                                                  int cy, int cx) {
  const float c = s[cy][cx];
  const float p[16] = {
      s[cy - 3][cx],     s[cy - 3][cx + 1], s[cy - 2][cx + 2],
      s[cy - 1][cx + 3], s[cy][cx + 3],     s[cy + 1][cx + 3],
      s[cy + 2][cx + 2], s[cy + 3][cx + 1], s[cy + 3][cx],
      s[cy + 3][cx - 1], s[cy + 2][cx - 2], s[cy + 1][cx - 3],
      s[cy][cx - 3],     s[cy - 1][cx - 3], s[cy - 2][cx - 2],
      s[cy - 3][cx - 1]};
  float lo[16], hi[16], lo4[16], hi4[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo[k] = fminf(p[k], p[(k + 1) & 15]);
    hi[k] = fmaxf(p[k], p[(k + 1) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo4[k] = fminf(lo[k], lo[(k + 2) & 15]);
    hi4[k] = fmaxf(hi[k], hi[(k + 2) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo[k] = fminf(lo4[k], lo4[(k + 4) & 15]);
    hi[k] = fmaxf(hi4[k], hi4[(k + 4) & 15]);
  }
  float a = fminf(lo[0], p[8]), b = fmaxf(hi[0], p[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) {
    a = fmaxf(a, fminf(lo[k], p[(k + 8) & 15]));
    b = fminf(b, fmaxf(hi[k], p[(k + 8) & 15]));
  }
  return fmaxf(fmaxf(a - c, c - b), 0.f);
}

// Score, NMS, blur and raw of tile t"""


def variants(src: str) -> dict:
    """name -> source; each edit must apply exactly once."""

    def edit(text, *pairs):
        for old, new in pairs:
            if text.count(old) != 1:
                raise ValueError(f"the kernel no longer holds {old!r}")
            text = text.replace(old, new)
        return text

    return {
        "full": src,
        "float_minmax": edit(
            src, ("\n// Score, NMS, blur and raw of tile t", FLOAT_SCORE),
            (SCORE_CALL, "s = fast_score_float(s_img, cy, cx);")),
        "no_score": edit(src, (SCORE_CALL, "s = s_img[cy][cx];")),
        "no_stores": edit(
            src, (TILE_STORE, TILE_STORE.replace("if (", "if (p.W < 0 && ")),
            (TILE_CELL_STORE,
             TILE_CELL_STORE.replace("if (", "if (p.W < 0 && "))),
        "zero_fill_only": edit(src, (TILE_CALL, "")),
    }


def build(sources: dict) -> dict:
    """nvcc every variant at once; name -> the launch function."""
    out_dir = cuda_lib.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
             str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"lib{name}.so")).frontend_packed_launch
        fn.restype, fn.argtypes = fp._SIGNATURES["frontend_packed_launch"]
        fns[name] = fn
    return fns


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["752x480", "1241x376"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("times the card: no CUDA device is available")
    fns = build(variants((cuda_lib.CSRC / "frontend_packed.cu").read_text()))
    dev = torch.device("cuda", 0)
    for shape in args.shapes:
        width, height = (int(v) for v in shape.split("x"))
        img = render_sequence(n_frames=1, width=width, height=height,
                              fx=0.61 * width, fy=0.61 * width, seed=1)[0][0]
        levels = pyr.build_pyramid(torch.from_numpy(img).to(dev), 8, 1.2)
        ref = fp.frontend_pass_packed_ref(levels)
        plan = fp.plan_of(levels)
        ptrs = (ctypes.c_void_p * len(levels))(
            *[im.data_ptr() for im in levels])
        for name, fn in fns.items():
            outs = [torch.empty_like(x) for x in ref[:4]]

            def launch():
                cuda_lib.check(fn(plan.table, ptrs, fp._TAPS,
                                  *[cuda_lib.ptr(o) for o in outs],
                                  cuda_lib.stream_handle(dev)), name)

            dev_ms, _ = device_events(launch, ("frontend_packed_kernel",),
                                      calls=50)
            exact = (bool((outs[0] == ref[0]).all())
                     and bool((outs[3] == ref[3]).all()))
            print(json.dumps(dict(shape=shape, variant=name,
                                  device_us=dev_ms * 1e3,
                                  score_and_raw_exact=exact)))


if __name__ == "__main__":
    main()
