"""Mean host time of the System's `track_frame` stage in the window: it
ends in the fetch of the tracking summary, so it holds the frame's device
work."""

import statistics


def read(r):
    xs = r.get("stages", {}).get("track_frame")
    return statistics.fmean(xs) * 1e3 if xs else None
