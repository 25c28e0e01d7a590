"""An inertial-BA LM iteration's share of its roofline, in %: the frozen
algorithmic bound of one iteration on the generated map (`slambench/
roofline_vi.vi_iter_cost`: the visual part as `roofline.ba_iter_cost`
counts it, the inertial residuals and Jacobians, JᵀJ, the (9K+8)² LU and
its triangular solves) over `vi_iter_device_ms`."""

from slambench import roofline
from slambench.metrics import _load


def read(r):
    if "vi" not in r:
        return None
    ms = _load("vi_iter_device_ms").read(r)
    return roofline.share(r["vi"]["bound_ms"], ms) if ms else None
