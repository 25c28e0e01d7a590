"""Device time of one BA iteration: the device's busy time in the
profiled slice of solves over their iterations."""

from slambench import harness


def read(r):
    sl = r.get("slice")
    if r["kind"] != "solves" or sl is None or not sl.units:
        return None
    busy = harness.busy_us(sl.events)
    return busy / 1e3 / (sl.units * r["n_iters"]) if busy > 0 else None
