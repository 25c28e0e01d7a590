"""Median host time of the System's `local_ba` stage in the window (the
inertial insertion's visual-inertial local BA, or the visual window BA
before the IMU is initialized); only the inertial sensors have it."""

import statistics


def read(r):
    xs = r.get("stages", {}).get("local_ba")
    return statistics.median(xs) * 1e3 if xs else None
