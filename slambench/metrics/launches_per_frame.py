"""Device kernel launches per frame: the kernels in the profiled slice of
the window over its frames (the System's host-paced dispatch)."""


def read(r):
    sl = r.get("slice")
    if r["kind"] != "frames" or sl is None or not sl.units:
        return None
    n = sum(1 for _, c, _, _ in sl.events if c == "kernel")
    return n / sl.units
