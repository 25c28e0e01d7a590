"""The port's live web viewer (`runtime/viewer.py`) against the JAX one:
a port System tracks a clip on the CPU and saves its Atlas; a port System
and a JAX System load that file (so neither runs the initializer and its
random draws) and take the tracked System's pose, trajectory, frame count
and state; the two viewers' state.json documents are equal."""

import json
import urllib.request

import numpy as np

from orb_slam3_ros2_tpu.runtime.system import Sensor as JSensor
from orb_slam3_ros2_tpu.runtime.system import System as JSystem
from orb_slam3_ros2_tpu.runtime.system import TrackingState as JState
from orb_slam3_ros2_tpu.runtime.viewer import LiveViewer as JLiveViewer
from orb_slam3_ros2_tpu_torch.io import synthetic
from orb_slam3_ros2_tpu_torch.runtime.system import Sensor, System
from orb_slam3_ros2_tpu_torch.runtime.viewer import LiveViewer
from tests.test_torch_e2e_stereo import two_threads  # noqa: F401

SETTINGS = "tests/data/synth_cam.yaml"


def _get(viewer, path):
    url = f"http://127.0.0.1:{viewer.port}{path}"
    return urllib.request.urlopen(url, timeout=10).read()


def _state(viewer):
    return json.loads(_get(viewer, "/state.json"))


def _take_frame_state(dst, src, state):
    """Give `dst` the pose, trajectory, frame count and tracking state of
    `src`, as copies (the viewer reads only these and the map)."""
    dst.Tcw = src.Tcw.copy()
    dst.trajectory = [(t, T.copy()) for t, T in src.trajectory]
    dst.n_frames = src.n_frames
    dst.state = state


def test_viewer_serves_page_and_state(tmp_path, two_threads):  # noqa: F811
    slam = System(None, SETTINGS, Sensor.MONOCULAR, device="cpu")
    n = 20  # the port's own draws initialize this clip at frame 14
    images, _, _, ts = synthetic.render_sequence(
        n_frames=n, width=320, height=240, fx=260.0, fy=260.0,
        fps=10.0, seed=1, plane_depths=(6.0, 9.0), traj_scale=1.6)
    for k in range(n):
        slam.track_monocular(images[k], float(ts[k]))

    v = LiveViewer(slam, port=0, max_points=50)  # ephemeral port
    try:
        assert b"tpu-slam live viewer" in _get(v, "/")
        d = _state(v)
        assert d["state"] == "OK"
        assert d["n_keyframes"] == int(slam.map.n_kf) >= 2
        assert d["n_landmarks"] > 50
        assert d["n_frames"] == n
        assert len(d["trajectory"]) == n
        assert np.isfinite(np.asarray(d["trajectory"])).all()
        try:
            _get(v, "/nothing")
            assert False, "expected 404"
        except urllib.error.HTTPError as e:
            assert e.code == 404
    finally:
        v.close()

    atlas = slam.save_atlas(str(tmp_path / "viewer_atlas.npz"))
    port = System(None, SETTINGS, Sensor.MONOCULAR, device="cpu",
                  load_atlas=atlas)
    ref = JSystem(None, SETTINGS, JSensor.MONOCULAR, load_atlas=atlas)
    assert int(port.map.n_kf) == int(ref.map.n_kf) == int(slam.map.n_kf)
    _take_frame_state(port, slam, slam.state)
    _take_frame_state(ref, slam, JState[slam.state.name])
    viewers = [LiveViewer(port, port=0, max_points=50),
               JLiveViewer(ref, port=0, max_points=50)]
    try:
        got, want = (_state(x) for x in viewers)
        assert got == want
        assert got == d  # the loaded map serves what the live one did
        assert _get(viewers[0], "/") == _get(viewers[1], "/")
    finally:
        for x in viewers:
            x.close()
