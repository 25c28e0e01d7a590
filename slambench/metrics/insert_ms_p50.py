"""Median host time of the System's `insert_kf` stage (a keyframe
insertion, mapping and loop closing) in the window."""

import statistics


def read(r):
    xs = r.get("stages", {}).get("insert_kf")
    return statistics.median(xs) * 1e3 if xs else None
