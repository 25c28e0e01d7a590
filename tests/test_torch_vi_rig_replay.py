"""The IMU_STEREO System of the port and of the JAX package on the same
feature sets: those that an H100 extracts from the clip of
`tests/test_e2e_stereo_inertial.py` (`system_run.VI_RIGS
["synth_stereo_inertial"]`), recorded in
`tests/data/stereo_vi_card_features.npz` by `tools/vi_rig_diff.py
--save-features` on an NVIDIA H100 80GB HBM3. Both run on the CPU, fed
those sets in order instead of extracting (`tools/vi_rig_diff.
replay_features`, `scripts/jax_reference_runs.replay_features`). With the
extraction's rounding taken out, what follows it (stereo matching,
tracking, keyframe insertion, preintegration, the VI initialization, the
VI BA) must agree: the same keyframes, the same tracked poses to within
f32 rounding's drift over 60 frames, the same gyro bias and length ratio.

On the card's feature sets the JAX System itself reads a length ratio past
the e2e test's 12% (ROADMAP §3): the premise of `chip_smoke.py` phase
10b's bar for this clip, `STEREO_VI_LENGTH_JAX_CARD`."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.runtime.system import Sensor as JSensor
from orb_slam3_ros2_tpu.runtime.system import System as JSystem
from orb_slam3_ros2_tpu_torch.tools import system_run as sr
from orb_slam3_ros2_tpu_torch.tools import vi_rig_diff

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD_FEATURES = os.path.join(ROOT, "tests", "data",
                             "stereo_vi_card_features.npz")
# the two runs' online camera centres: f32 rounding in two programs that
# sum in different orders drifts apart over 60 frames of tracking and BA
# (measured: 1.08e-2 m at frame 40, 1.4e-3 m at the end; the H100 against
# the CPU on the same sets: 4.0e-3 m)
CENTRE_M = 2e-2
# the measures of the e2e test: gyro bias (its bar 6e-3; measured 1.8e-5
# apart) and the unaligned length ratio (its bar 12%; 3.6e-4 apart)
BG_ABS, LENGTH_ABS = 5e-5, 1e-3
LENGTH_TOL = 0.12  # tests/test_e2e_stereo_inertial.py


@pytest.fixture
def two_threads():
    """Leave the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_reference_runs", os.path.join(ROOT, "scripts",
                                           "jax_reference_runs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_run(rig, frames, path):
    slam = JSystem(None, os.path.join(ROOT, rig.settings),
                   JSensor(int(rig.sensor)))
    slam.VI_INIT_KFS = 6
    _jax_script().replay_features(slam, path)
    n_kf, centres = [], []
    for k in range(rig.n_frames):
        T = sr.track_vi_rig(slam, rig, frames, k)
        n_kf.append(int(slam.map.n_kf))
        centres.append(-T[:3, :3].T @ T[:3, 3])
    return n_kf, centres, sr.vi_rig_metrics(slam, rig, frames[2], frames[3])


def test_port_and_jax_agree_on_the_card_features(two_threads):
    rig = sr.VI_RIGS["synth_stereo_inertial"]
    frames = sr.render_vi_rig(rig)
    port = vi_rig_diff.run_clip(rig, frames, torch.device("cpu"),
                                "replayed", CARD_FEATURES)
    n_kf, centres, jax = _jax_run(rig, frames, CARD_FEATURES)

    assert n_kf == port["n_kf_per_frame"]
    assert jax["imu_initialized"] and port["imu_initialized"]
    d = np.linalg.norm(np.array(centres) - np.array(port["centres"]), axis=1)
    assert d.max() < CENTRE_M, (d.max(), d.argmax())
    assert abs(jax["bg_err"] - port["bg_err"]) < BG_ABS
    assert abs(jax["length_ratio"] - port["length_ratio"]) < LENGTH_ABS
    assert abs(jax["length_ratio"] - 1.0) > LENGTH_TOL
