"""Launch calls an inertial-BA LM iteration: the kernel launches, copies,
fills and graph launches whose host start lies inside the program's
`vi.iteration` spans, over those spans (`slambench/vi_spans.py`)."""

from slambench import vi_spans


def read(r):
    sl = r.get("slice")
    if sl is None:
        return None
    n = vi_spans.launches(sl.events)
    return None if n is None else n / vi_spans.iterations(sl.events)
