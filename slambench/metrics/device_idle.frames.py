"""Share of the profiled slice of frames in which no operation ran on the
device, in %: 1 - the union of the device's operation intervals over the
slice's host time."""

from slambench import harness


def read(r):
    sl = r.get("slice")
    if r["kind"] != "frames" or sl is None or sl.wall_s <= 0:
        return None
    return 100.0 * (1.0 - harness.busy_us(sl.events) / 1e6 / sl.wall_s)
