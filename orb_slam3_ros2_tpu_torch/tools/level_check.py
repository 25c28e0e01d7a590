"""Hold the per-level kernels of any checkout to the Pallas kernels' function
on the whole image, on the card.

    python3 orb_slam3_ros2_tpu_torch/tools/level_check.py --root DIR \\
        [--label NAME] [--shapes 752x480 1241x376 512x512]

Runs `fast_nms`, `blur7`, `frontend_pass` and `frontend_pass_lite` of the
checkout at `--root` (this repository at any commit since the per-level
kernels were ported, e.g. unpacked with `git archive` into a directory that
`.gitignore` lists) twice on every level of the 8-level pyramid of the
rendered frame of each shape, and compares each output with a zero-padding
mirror: FAST score as `fast.fast_score`, NMS against 0 outside the image,
the 7x7 blur zero-padded, `orb_descriptor.moment_maps`. The mirror is
written out here from the checkout's plain pieces, because older checkouts
lack `ops/frontend_level.py`'s `*_zero`. Prints one JSON line: for each
kernel and output, the largest difference, the cells past the phase 2b
tolerances (score 1e-4; blur 1e-5 relative + 1e-3; moments 2e-4 relative +
2.0), the largest difference in the border band (4 px, 16 for the
moments), the keep cells that differ, and the levels whose two launches
differ.
"""

from __future__ import annotations

import argparse
import json
import sys

TOL = dict(score=(0.0, 1e-4), blur=(1e-5, 1e-3), moments=(2e-4, 2.0))
OUTPUTS = dict(fast_nms=("score", "keep"), blur7=("blur",),
               frontend_pass=("score", "keep", "moments", "moments", "blur"),
               frontend_pass_lite=("score", "keep", "blur"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--shapes", nargs="+",
                    default=["752x480", "1241x376", "512x512"])
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        ap.error("checks the card's kernels: no CUDA device is available")
    sys.path.insert(0, args.root)
    from orb_slam3_ros2_tpu_torch.ops import fast, frontend_level as fl
    from orb_slam3_ros2_tpu_torch.ops import orb_descriptor as desc
    from orb_slam3_ros2_tpu_torch.io.synthetic import render_sequence
    from orb_slam3_ros2_tpu_torch.ops import pyramid as pyr

    taps = [float(v) for v in pyr._gauss_kernel1d(7, 2.0)]

    def blur(img):
        H, W = img.shape
        x = F.pad(img[None, None], (0, 0, 3, 3))[0, 0]
        v = sum(taps[i] * x[i:i + H, :] for i in range(7))
        y = F.pad(v[None, None], (3, 3, 0, 0))[0, 0]
        return sum(taps[i] * y[:, i:i + W] for i in range(7))

    def nms(score):
        h, w = score.shape
        pad = F.pad(score, (1, 1, 1, 1), value=0.0)
        keep = torch.ones_like(score, dtype=torch.bool)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if (dy, dx) != (0, 0):
                    n = pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                    earlier = (dy, dx) < (0, 0) or (dy, dx) == (0, -1)
                    keep &= score > n if earlier else score >= n
        return keep

    def mirror(img):
        score = fast.fast_score(img)
        m01, m10 = desc.moment_maps(img)
        b = blur(img)
        return dict(fast_nms=(score, nms(score)), blur7=(b,),
                    frontend_pass=(score, nms(score), m01, m10, b),
                    frontend_pass_lite=(score, nms(score), b))

    def run(img):
        out = {name: getattr(fl, name)(img) for name in OUTPUTS}
        out["blur7"] = (out["blur7"],)
        return out

    dev = torch.device("cuda", 0)
    report = {}
    for shape in args.shapes:
        # kernel_timing.level_inputs' frame, built from the checkout's code
        width, height = (int(v) for v in shape.split("x"))
        img = render_sequence(n_frames=1, width=width, height=height,
                              fx=0.61 * width, fy=0.61 * width, seed=1)[0][0]
        levels = pyr.build_pyramid(torch.from_numpy(img).to(dev), 8, 1.2)
        for index, level in enumerate(levels):
            got, again, want = run(level), run(level), mirror(level)
            torch.cuda.synchronize()
            for name, kinds in OUTPUTS.items():
                for kind, g, a, w in zip(kinds, got[name], again[name],
                                         want[name]):
                    r = report.setdefault(f"{name}.{kind}", dict(
                        max_abs=0.0, past_tol=0, border_max=0.0,
                        keep_cells=0, repeat_differs=[]))
                    if not torch.equal(g, a):
                        r["repeat_differs"].append([shape, index])
                    if kind == "keep":
                        r["keep_cells"] += int((g != w).sum())
                        continue
                    rtol, atol = TOL[kind]
                    d = (g.double() - w.double()).abs()
                    r["max_abs"] = max(r["max_abs"], d.max().item())
                    r["past_tol"] += int(
                        (d > atol + rtol * w.double().abs()).sum())
                    b = 16 if kind == "moments" else 4
                    inner = torch.zeros_like(d, dtype=torch.bool)
                    inner[b:-b, b:-b] = True
                    r["border_max"] = max(r["border_max"],
                                          d[~inner].max().item())
    print(json.dumps(dict(label=args.label or args.root,
                          card=torch.cuda.get_device_name(0),
                          check=report)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
