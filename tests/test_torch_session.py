"""The port's `SlamSession` (`runtime/session.py`) against the JAX one: the
shutdown artifact set and its file formats (PCD, PGM + YAML, TUM
trajectory, JSON event log, video), the VIBA edge reset of the pose
history, and the periodic Atlas checkpoint
(`tests/test_system_atlas.py::test_session_periodic_checkpoint`), which
the port's and the JAX System both load with the keyframes it was saved
with."""

import json
import os

import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.runtime import outputs as jout
from orb_slam3_ros2_tpu.runtime.system import Sensor as JSensor
from orb_slam3_ros2_tpu.runtime.system import System as JSystem
from orb_slam3_ros2_tpu.runtime.system import TrackingState as JState
from orb_slam3_ros2_tpu_torch.io import synthetic
from orb_slam3_ros2_tpu_torch.runtime.session import SlamSession
from orb_slam3_ros2_tpu_torch.runtime.system import (Sensor, System,
                                                     TrackingState)

SETTINGS = os.path.join(os.path.dirname(__file__), "data", "synth_cam.yaml")
N = 24  # the port's own draws initialize this clip at frame 14


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)  # as tests/test_torch_e2e_mono.py
    yield _run(tmp_path_factory.mktemp("sess"))
    torch.set_num_threads(n_threads)


def _run(root):
    images, R_gt, t_gt, ts = synthetic.render_sequence(
        n_frames=N, width=320, height=240, fx=260.0, fy=260.0, fps=10.0,
        seed=1, plane_depths=(6.0, 9.0), traj_scale=1.6)
    sess = SlamSession(SETTINGS, Sensor.MONOCULAR, output_name="ckpt_t",
                       output_root=str(root), record_video=True,
                       checkpoint_every=8, device="cpu")
    ckpt = os.path.join(str(root), "ckpt_t", "checkpoint_atlas.npz")
    saved = {}
    for k in range(N):
        sess.feed(images[k], float(ts[k]))
        if (k + 1) % 8 == 0:
            saved[k + 1] = (os.path.getmtime(ckpt), int(sess.system.map.n_kf))
    n_kf = int(sess.system.map.n_kf)
    artifacts = sess.shutdown()
    return sess, artifacts, ckpt, saved, n_kf


def test_shutdown_artifacts(run):
    sess, artifacts, _, _, n_kf = run
    # the JAX session's set; no "atlas": the settings name no save path
    assert set(artifacts) == {"pcd", "grid", "trajectory", "events",
                              "video"}
    out = os.path.join(os.path.dirname(artifacts["pcd"]), "..")
    assert os.path.samefile(out, sess.out_dir)
    for p in artifacts.values():
        assert os.path.isfile(p), p
    cloud = jout.load_pcd(artifacts["pcd"])
    assert cloud.ndim == 2 and cloud.shape[1] == 3 and len(cloud) > 0
    assert os.path.isfile(artifacts["grid"][:-4] + ".yaml")
    with open(artifacts["grid"], "rb") as f:
        assert f.readline().strip() == b"P5"
    traj = np.loadtxt(artifacts["trajectory"])
    assert traj.shape == (N, 8)  # one row per frame the System took
    q = traj[:, 4:]
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-5)
    lines = open(artifacts["events"]).read().splitlines()
    assert len(lines) == N + 1
    assert set(json.loads(lines[0])) == {"t", "state", "ms"}
    last = json.loads(lines[-1])
    assert last["event"] == "shutdown" and last["keyframes"] == n_kf
    assert last["maps"] == 1 and last["landmarks"] == int(
        sess.system.map.lm_valid.sum())
    assert "extract" in last["stages"]
    assert os.path.getsize(artifacts["video"]) > 0
    assert len(sess.pose_history) == N
    assert sess.system.get_tracking_state() == TrackingState.OK


def test_periodic_checkpoint_loads_in_both_packages(run):
    sess, _, ckpt, saved, n_kf = run
    assert os.path.isfile(ckpt)
    assert saved[8][0] < saved[16][0] < saved[24][0]  # rewritten each time
    assert saved[24][1] == n_kf >= 2
    port = System(None, SETTINGS, Sensor.MONOCULAR, device="cpu",
                  map_cfg=sess.system.map_cfg, load_atlas=ckpt)
    assert int(port.map.n_kf) == n_kf
    assert port.get_tracking_state() == TrackingState.LOST
    ref = JSystem(None, SETTINGS, JSensor.MONOCULAR, load_atlas=ckpt)
    assert int(ref.map.n_kf) == n_kf
    assert ref.get_tracking_state() == JState.LOST
    np.testing.assert_array_equal(np.asarray(ref.map.kf_R[:n_kf]),
                                  sess.system.map.kf_R[:n_kf].numpy())


def test_viba_edges_reset_the_pose_history(tmp_path):
    images, _, _, ts = synthetic.render_sequence(
        n_frames=3, width=320, height=240, fx=260.0, fy=260.0, fps=10.0,
        seed=1)
    sess = SlamSession(SETTINGS, Sensor.MONOCULAR, output_name="v",
                       output_root=str(tmp_path), device="cpu")
    sess.feed(images[0], float(ts[0]))
    sess.feed(images[1], float(ts[1]), [[float(ts[1]), 0.0, 0.0, 0.1,
                                         0.0, 0.0, 9.81]])
    assert len(sess.pose_history) == 2
    sess.system.inertial_ba1 = True  # a VIBA1 edge: the wrapper resets
    sess.feed(images[2], float(ts[2]))
    assert len(sess.pose_history) == 1
    sess.feed(images[2], float(ts[2]) + 0.1)
    assert len(sess.pose_history) == 2  # no new edge


def test_session_raises_without_a_card_unless_asked():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        SlamSession(SETTINGS, Sensor.MONOCULAR, output_name="x")
