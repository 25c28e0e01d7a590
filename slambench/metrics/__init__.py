"""Per-layer metrics: one reader per metric, in a file named after it.
Each has `read(readings) -> float | None`; None where the run has nothing
for it to read (the harness then leaves the metric out)."""

import importlib.util
from pathlib import Path


def _load(name: str):
    """The reader module of metric `name` (its file's name may hold
    dots)."""
    path = Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"slambench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
