"""Device time of one inertial-BA LM iteration, in ms: the device's busy
time inside the device annotations of the program's `vi.*` stages (the
Schur reduce, the inertial terms, the solve, the back-substitution and
the costs) over the slice's `vi.iteration` spans (`slambench/
vi_spans.py`)."""

from slambench import vi_spans


def read(r):
    return vi_spans.stage_ms(r, vi_spans.STAGES)
