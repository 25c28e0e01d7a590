"""Device time of the dense solve an LM iteration, in ms: the device's
busy time inside the program's `vi.solve` spans (the (9K+8)² system's
assembly with its `block_diag` and the inertial scatter, the priors, the
damping and `solve_ex`) over the slice's `vi.iteration` spans
(`slambench/vi_spans.py`)."""

from slambench import vi_spans


def read(r):
    return vi_spans.stage_ms(r, ["vi.solve"])
