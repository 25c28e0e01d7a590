"""The packed frontend kernel's share of its roofline, in %: the frozen
bound of one pyramid (`slambench/roofline.frontend_cost`) over the mean
device time of the kernels named `frontend_packed` in the profiled
slice."""

from slambench import roofline


def read(r):
    sl = r.get("slice")
    if r["kind"] != "frames" or sl is None:
        return None
    d = [dur for n, c, _, dur in sl.events
         if c == "kernel" and "frontend_packed" in n]
    if not d:
        return None
    return roofline.share(r["frontend"]["bound_ms"], sum(d) / len(d) / 1e3)
