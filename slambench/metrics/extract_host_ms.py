"""Mean host time of the System's `extract` stage in the window: the
enqueue of the extraction, with no device wait."""

import statistics


def read(r):
    xs = r.get("stages", {}).get("extract")
    return statistics.fmean(xs) * 1e3 if xs else None
