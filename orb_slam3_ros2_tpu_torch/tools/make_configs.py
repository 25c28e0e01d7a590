"""Write the built-in dataset settings tree (`<root>/<Mode>/<Name>.yaml`)
from the calibration tables of `io/known_configs.py`: the generated
counterpart of the reference's hand-written `config/` directory.

    python -m orb_slam3_ros2_tpu_torch.tools.make_configs [ROOT]

Port of `scripts/make_configs.py`. ROOT defaults to `build/config`, never
the repository's `config/`; each file is the JAX package's byte for byte.
It prints each path it wrote.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> list:
    """Writes every supported (mode, dataset) file; returns their paths."""
    from orb_slam3_ros2_tpu_torch.io import known_configs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default="build/config")
    args = ap.parse_args(argv)
    paths = known_configs.write_all(args.root)
    for path in paths:
        print(path)
    return paths


if __name__ == "__main__":
    main()
