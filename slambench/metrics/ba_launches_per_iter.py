"""Launches an LM iteration: the launch calls (kernel launches, copies and
fills, through the runtime or the driver) whose host start lies inside
the program's `ba.iteration` spans, over those spans
(`slambench/ba_spans.py`)."""

from slambench import ba_spans


def read(r):
    sl = r.get("slice")
    if sl is None:
        return None
    n = ba_spans.launches(sl.events)
    return None if n is None else n / ba_spans.iterations(sl.events)
