"""Device time of the reduced camera solve an LM iteration, in ms: the
device's busy time inside the program's `ba.solve_cameras` spans (the
damping, the block-diagonal assembly, the dense solve) over the slice's
`ba.iteration` spans (`slambench/ba_spans.py`)."""

from slambench import ba_spans


def read(r):
    sl = r.get("slice")
    if sl is None:
        return None
    return ba_spans.per_iteration_ms(
        sl.events, ba_spans.device_us(sl.events, "ba.solve_cameras"))
