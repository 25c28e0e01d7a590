"""Share of a global BA solve's time in which no operation ran on the
device, in %: 1 - the device's busy time per solve in the profiled slice
(the union of its operations' intervals, which the profiler records on
the device's clock) over the host-clock time of a solve outside the slice.
A solve under the profiler takes longer on the host (its per-call
overhead), so the slice's own wall time would read that overhead as idle."""

from slambench import harness


def read(r):
    sl = r.get("slice")
    free = r.get("free_solve_s")
    if r["kind"] != "solves" or sl is None or not sl.units or not free:
        return None
    busy_s = harness.busy_us(sl.events) / 1e6 / sl.units
    return 100.0 * (1.0 - busy_s / free) if busy_s > 0 else None
