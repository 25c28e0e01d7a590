"""Device time of the inertial terms an LM iteration, in ms: the device's
busy time inside the program's `vi.inertial` spans (the preintegration
residuals of every interval, their forward-mode Jacobians and JᵀJ, Jᵀr)
over the slice's `vi.iteration` spans (`slambench/vi_spans.py`)."""

from slambench import vi_spans


def read(r):
    return vi_spans.stage_ms(r, ["vi.inertial"])
