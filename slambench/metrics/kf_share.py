"""Keyframes inserted over frames tracked in the window, in %."""


def read(r):
    if r["kind"] != "frames" or not r["n_frames"]:
        return None
    return 100.0 * r["n_insertions"] / r["n_frames"]
