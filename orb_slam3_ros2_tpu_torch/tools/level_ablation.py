"""Where the per-level kernels' time goes: build variants of
`csrc/frontend_level.cu` with one part changed or taken out and time each
on the card.

    python -m orb_slam3_ros2_tpu_torch.tools.level_ablation \\
        [--shapes 752x480 1241x376] [--variants full no_score stage_only+no_m10]

Variants (each a copy of the source with one edit, built by nvcc into
`build/kernels/ablation/`):

  full           the kernels as they are
  lite_WxH       the tile without the moment maps (fast_nms, lite) W x H
                 instead of 64x16 (96x16, 128x16, 64x32, 64x8, 32x16)
  no_score       the FAST score replaced by the centre pixel (no ring, no
                 min/max); staging, blur, NMS and stores kept
  no_early_out   every interior cell listed for the score (no
                 compass-point test)
  mom_no_gather  the moment threads build the prefix sums and stop (m01,
                 m10 not written)
  no_moments     the moment threads stop after the staging: the pass is
                 the score warps alone
  no_m01, no_m10 the gather without the S rows (m01) or the V columns (m10)
  stage_only     the tile threads return after the staging: no score,
                 blur, NMS or stores (the moment threads kept)
  mom_384        the pass with the moment maps on 384 threads a block: 2
                 warps a map of 3 x 8 outputs a thread (not 4 of 3 x 4)

Names joined by "+" combine edits. Prints one JSON line per variant and level 0 of each shape: device µs per
launch of `fast_nms`, `frontend_pass_lite` and `frontend_pass` (torch.
profiler over 50 launches, the kernel's own device time), whether each
equals the zero-padding mirror (`ops/frontend_level.py` `*_zero`; expected
for full and the tile variants), and ptxas' registers and spills. The
variants are measurements, never used by the port.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import subprocess

import torch

from orb_slam3_ros2_tpu_torch.ops import cuda_lib
from orb_slam3_ros2_tpu_torch.ops import frontend_level as fl
from orb_slam3_ros2_tpu_torch.tools.kernel_timing import (device_events,
                                                          level_inputs)

LITE_TILE = "constexpr int LTW = 64, LTH = 16;"
SCORE_CALL = ("    s_sc[ly * SCW + lx + 3] = fast_score<T::KW>(s_key, ly + 3, "
              "lx + 3);")
ARC_TEST = ("              x < W - BORDER && arc_possible<T::KW>(s_key, ly + 3, "
            "lx + 3);")
CENTRE = ("    s_sc[ly * SCW + lx + 3] = __int_as_float(key_of(s_key[(ly + 3) "
          "* T::KW + lx + 3]));")
GATHER = "  group_sync(ROWS ? 1 : 3, NS);\n"
MOM_BRANCH = "    if (tid < NS) {\n"
TILE_BODY = ("  using T = Tile<TW, TH>;\n"
             "  constexpr int SCW = T::SCW, SVW = T::SVW, NG = T::NG, "
             "NPIX = T::NPIX;\n")
MOM_THREADS = "constexpr int NTM = 512;"
MOM_ROWS = "constexpr int MC = 3, MK = 4;"
MOM_WARPS = "constexpr int NM = 256;"
LITE_TILES = ((96, 16), (128, 16), (64, 32), (64, 8), (32, 16))


M01_ADD = ("          m[k][j] = __fmaf_rn((float)d, row[j + u + 1] - row[j - u], "
           "m[k][j]);\n")
M10_ADD = ("          m[k][j] = __fmaf_rn((float)d, col[(k + u + 1) * VP] - "
           "col[(k - u) * VP],\n                              m[k][j]);\n")
EDITS = dict(
    no_score=[(SCORE_CALL, CENTRE)],
    no_early_out=[(ARC_TEST, "              x < W - BORDER;")],
    mom_no_gather=[(GATHER, GATHER + "  return;\n")],
    no_moments=[(MOM_BRANCH, "    if (tid < NM) {\n    } else if (tid < NS) {\n")],
    no_m01=[(M01_ADD, "          ;\n")],
    no_m10=[(M10_ADD, "          ;\n")],
    stage_only=[(TILE_BODY, TILE_BODY + "  if (n > 0) return;\n")],
    mom_384=[(MOM_THREADS, "constexpr int NTM = 384;"),
             (MOM_ROWS, "constexpr int MC = 3, MK = 8;"),
             (MOM_WARPS, "constexpr int NM = 128;")],
    **{f"lite_{w}x{h}": [(LITE_TILE, f"constexpr int LTW = {w}, LTH = {h};")]
       for w, h in LITE_TILES})


def variant(src: str, name: str) -> str:
    """The source of a variant: "full", a name of EDITS, or names joined
    by "+" (their edits one after another)."""
    if name == "full":
        return src
    for part in name.split("+"):
        for old, new in EDITS[part]:
            if old not in src:
                raise ValueError(f"{name}: the source no longer holds {old!r}")
            src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    """{name: source} of "full" and every single edit."""
    return {name: variant(src, name) for name in ("full", *EDITS)}


def build(sources: dict) -> dict:
    """Compile each variant in parallel; {name: (library, ptxas lines)}."""
    out_dir = cuda_lib.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, text = item
        src = out_dir / f"level_{name}.cu"
        src.write_text(text)
        lib = out_dir / f"liblevel_{name}.so"
        proc = subprocess.run(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(lib), str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        info = [l.strip() for l in (proc.stdout + proc.stderr).splitlines()
                if "registers" in l or "spill" in l]
        return name, (lib, info)

    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(one, sources.items()))


def _calls(lib, img):
    """The three launches of one library on `img`, each returning its
    outputs as fast_nms / frontend_pass_lite / frontend_pass do."""
    H, W = img.shape
    dev = img.device
    stream = cuda_lib.stream_handle(dev)

    def maps(n):
        return [torch.empty((H, W), dtype=torch.float32, device=dev)
                for _ in range(n)]

    def keep():
        return torch.empty((H, W), dtype=torch.bool, device=dev)

    def fast_nms():
        score, k = maps(1)[0], keep()
        cuda_lib.check(lib.fast_nms_level_launch(
            cuda_lib.ptr(img), H, W, cuda_lib.ptr(score), cuda_lib.ptr(k),
            stream), "fast_nms")
        return score, k

    def frontend(with_moments):
        score, blur, m01, m10 = maps(4)
        k = keep()
        cuda_lib.check(lib.frontend_level_launch(
            cuda_lib.ptr(img), H, W, int(with_moments), cuda_lib.ptr(score),
            cuda_lib.ptr(k), cuda_lib.ptr(m01), cuda_lib.ptr(m10),
            cuda_lib.ptr(blur), stream), "frontend")
        if with_moments:
            return score, k, m01, m10, blur
        return score, k, blur

    return dict(fast_nms=fast_nms,
                frontend_pass_lite=lambda: frontend(False),
                frontend_pass=lambda: frontend(True))


def _equal_to_mirror(name, got, img) -> bool:
    want = getattr(fl, f"{name}_zero")(img)
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.bool:
            if not torch.equal(g, w):
                return False
            continue
        rtol, atol = ((2e-4, 2.0) if name == "frontend_pass" and i in (2, 3)
                      else (1e-5, 1e-3))
        if not bool(((g - w).abs() <= atol + rtol * w.abs()).all()):
            return False
    return True


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["752x480", "1241x376"])
    ap.add_argument("--variants", nargs="+", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("times the card: no CUDA device is available")
    src = (cuda_lib.CSRC / "frontend_level.cu").read_text()
    sources = ({k: variant(src, k) for k in args.variants} if args.variants
               else variants(src))
    libs = build(sources)
    dev = torch.device("cuda", 0)
    for shape in args.shapes:
        (_, img), = level_inputs(shape, "0", dev)
        for name, (path, info) in libs.items():
            lib = ctypes.CDLL(str(path))
            for fn, (restype, argtypes) in fl._SIGNATURES.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            row = dict(variant=name, shape=shape,
                       ptxas=[re.sub(r"\s+", " ", l) for l in info])
            for kernel, call in _calls(lib, img).items():
                us, ops = device_events(call, ("level_kernel",), calls=50)
                row[kernel] = dict(
                    device_us=None if us is None else us * 1e3,
                    mirror=_equal_to_mirror(kernel, call(), img))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
