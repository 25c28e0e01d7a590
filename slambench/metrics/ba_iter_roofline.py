"""A BA iteration's share of its roofline, in %: the frozen algorithmic
bound of one iteration on the generated map (`slambench/roofline.
ba_iter_cost`, counted per observation, landmark, pair of observations of
a landmark and the reduced camera solve, never per (K, L) slot) over the
device time of one iteration."""

from slambench import roofline
from slambench.metrics import _load


def read(r):
    if r["kind"] != "solves":
        return None
    ms = _load("ba_iter_device_ms").read(r)
    return roofline.share(r["ba"]["bound_ms"], ms) if ms else None
