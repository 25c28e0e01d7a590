"""Device idle time an LM iteration that the host's BA stages leave, in
ms: the device's idle gaps in the slice whose start lies inside the
program's `ba.iteration` spans (filed, as `harness.breakdown` files them,
under `ba.iteration` or a `ba.*` stage in it), over those spans
(`slambench/ba_spans.py`)."""

from slambench import ba_spans


def read(r):
    sl = r.get("slice")
    if sl is None:
        return None
    return ba_spans.per_iteration_ms(sl.events, ba_spans.idle_us(sl.events))
