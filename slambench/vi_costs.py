"""Records each LM iteration's two total costs in the program's
visual-inertial BA: the linearization point's and the candidate's, as the
program hands them to its accept (`backend/vi_ba.py` `accept`), device
tensors kept without a wait. Its accept decisions are candidate <
linearization point. A program without that function records nothing,
and the reference then takes its own decisions."""

from __future__ import annotations

from slambench import harness


class VICosts:
    """Wraps `vi_ba.accept`; records only between `start` and `record`,
    around the one solve that is compared."""

    def __init__(self):
        from orb_slam3_ros2_tpu_torch.backend import vi_ba

        self.pairs: list = []
        self.on = False
        if not hasattr(vi_ba, "accept"):
            return

        def wrap(orig):
            def f(c0, c1):
                if self.on:
                    self.pairs.append((c0, c1))
                return orig(c0, c1)
            return f

        harness.patch(vi_ba, "accept", wrap)

    def start(self):
        self.pairs = []
        self.on = True

    def record(self) -> list:
        """The (c0, c1) pairs of the solve recorded since `start`; the
        recording stops."""
        self.on = False
        return self.pairs


def accepts(pairs) -> list:
    """The accept decisions of a recorded solve, one bool an iteration."""
    return [bool(c1 < c0) for c0, c1 in pairs]
