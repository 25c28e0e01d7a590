"""The port's generated settings tree against the JAX one
(`orb_slam3_ros2_tpu/io/known_configs.py`, `tests/test_known_configs.py`):
`config_text` is byte-identical for every supported (dataset, mode), the
port's settings parser reads each file as the JAX parser does, and an
unsupported pair raises in both."""

import os

import numpy as np
import pytest

from orb_slam3_ros2_tpu.io import known_configs as jkc
from orb_slam3_ros2_tpu.io import settings as jsettings
from orb_slam3_ros2_tpu_torch.io import known_configs as kc
from orb_slam3_ros2_tpu_torch.io import settings

PAIRS = [(n, m) for m in jkc.MODES for n in jkc.DATASETS]


def test_same_tables():
    assert kc.MODES == jkc.MODES
    assert list(kc.DATASETS) == list(jkc.DATASETS)
    assert [kc.supports(n, m) for n, m in PAIRS] == [
        jkc.supports(n, m) for n, m in PAIRS]


@pytest.mark.parametrize("mode", jkc.MODES)
def test_config_text_byte_identical(mode):
    n_supported = 0
    for name in jkc.DATASETS:
        if not jkc.supports(name, mode):
            with pytest.raises(ValueError):
                kc.config_text(name, mode)
            continue
        assert kc.config_text(name, mode).encode() == jkc.config_text(
            name, mode).encode(), name
        n_supported += 1
    assert n_supported > 0


def test_write_all_and_parse(tmp_path):
    paths = kc.write_all(str(tmp_path / "port"))
    ref = jkc.write_all(str(tmp_path / "jax"))
    assert len(paths) == len(ref) == 27
    for p, q in zip(paths, ref):
        assert os.path.relpath(p, tmp_path / "port") == os.path.relpath(
            q, tmp_path / "jax")
        assert open(p, "rb").read() == open(q, "rb").read()
        s, js = settings.load_settings(p), jsettings.load_settings(p)
        assert (s.camera.width, s.camera.height, s.n_features,
                s.sensor_type) == (js.camera.width, js.camera.height,
                                   js.n_features, js.sensor_type)
        assert np.allclose(s.camera.params, js.camera.params)
