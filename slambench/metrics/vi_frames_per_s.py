"""Frames per second of the inertial cell, over the part of the traced
run's window after the profiled slice: the frames whose call returned in
it over its seconds. The end-to-end `frames_per_s` of the inertial cell
spread too widely between runs of one seed to hold a bound (PERF.md,
section 2), so it stands here, with the cell's `frame_ms_p95` as what it
moves."""


def read(r):
    if r["kind"] != "frames" or r.get("stage_s", 0) <= 0:
        return None
    return r["n_frames"] / r["stage_s"]
