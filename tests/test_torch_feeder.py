"""The port's host feeder against the JAX one (`orb_slam3_ros2_tpu/runtime/
feeder.py`, `tests/test_feeder.py`): over the same native library (and the
pure-Python fallback) the same pushes give the same frames, IMU rows, drop
counts and queue states."""

import numpy as np
import pytest

from orb_slam3_ros2_tpu.runtime import feeder as jfeeder
from orb_slam3_ros2_tpu_torch.runtime import feeder


@pytest.fixture(params=["native", "python"])
def pair(request):
    native = request.param == "native"
    if native and (feeder._lib() is None or jfeeder._LIB is None):
        pytest.skip("native library not loadable here")
    kw = dict(width=32, height=24, frame_cap=3, imu_cap=8,
              force_python=not native)
    port, ref = feeder.NativeFeeder(**kw), jfeeder.NativeFeeder(**kw)
    assert port.is_native == ref.is_native == native
    return port, ref


def _same_next(port, ref):
    a, b = port.next(), ref.next()
    if b is None:
        assert a is None
        return None
    assert a[0] == b[0]
    assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    return a


def test_frames_and_imu_equal_jax(pair):
    port, ref = pair
    rng = np.random.default_rng(0)
    for f in (port, ref):
        assert f.next() is None
    imgs = [rng.integers(0, 255, (48, 64, 3), dtype=np.uint8),
            rng.integers(0, 255, (24, 32), dtype=np.uint8),
            rng.integers(0, 255, (24, 32), dtype=np.uint8)]
    for i in range(14):  # 14 samples into a cap of 8: the oldest drop
        g, a = [0.1 * i, 0.0, -0.01 * i], [0.0, 0.0, 9.8]
        assert port.push_imu(0.01 * i, g, a) == ref.push_imu(0.01 * i, g, a)
    assert port.push_imu(0.2, [np.nan, 0, 0], [0, 0, 9.8]) is False
    assert ref.push_imu(0.2, [np.nan, 0, 0], [0, 0, 9.8]) is False
    for t, img in zip((0.075, 0.105, 0.135), imgs):
        assert port.push_frame(t, img) == ref.push_frame(t, img)
    assert port.push_frame(0.2, imgs[1]) == ref.push_frame(0.2, imgs[1])
    assert port.pending_frames() == ref.pending_frames() == 3
    assert port.stats() == ref.stats()
    assert port.stats()["dropped_frames"] == 1
    assert port.stats()["dropped_imu"] == 6
    first = _same_next(port, ref)
    assert first[1].shape == (24, 32) and first[2].shape[1] == 7
    while _same_next(port, ref) is not None:
        pass
