"""The port's ROS 2 bridge (`runtime/ros_bridge.py`) against the JAX one,
both driven through the rclpy stub of `tests/test_ros_bridge.py`, with the
port's session, camera info, PCD loader and Madgwick filter on the CPU.
The Madgwick node's orientations equal the JAX node's on the same
messages (atol 1e-6: the filters are the same arithmetic in float32 under
two frameworks); the SLAM nodes, resumed from one Atlas file, publish the
same odometry on the same image messages (atol 1e-3 m, see the test)."""

import importlib
import os
import sys
import types

import numpy as np
import pytest

from tests.test_ros_bridge import (CameraInfo, Image, Imu, Odometry,
                                   PointCloud2, PointField, PoseArray,
                                   TransformStamped, _CvBridge, _Stamp,
                                   _StubNode, _TFBroadcaster, _imu_msg)

from tests.test_torch_e2e_stereo import two_threads  # noqa: F401

SETTINGS = os.path.join(os.path.dirname(__file__), "data", "synth_cam.yaml")


@pytest.fixture()
def bridges():
    """Install the stubs, reload both bridges with HAVE_ROS=True, restore."""
    mods = {}

    def mod(name, **attrs):
        m = types.ModuleType(name)
        for k, v in attrs.items():
            setattr(m, k, v)
        mods[name] = m
        return m

    qos = mod("rclpy.qos", qos_profile_sensor_data=object())
    node_mod = mod("rclpy.node", Node=_StubNode)
    mod("rclpy", qos=qos, node=node_mod, init=lambda args=None: None,
        shutdown=lambda: None, spin=lambda n: None)
    mod("cv_bridge", CvBridge=_CvBridge)
    mod("geometry_msgs.msg", PoseArray=PoseArray,
        TransformStamped=TransformStamped)
    mod("geometry_msgs", msg=mods["geometry_msgs.msg"])
    mod("nav_msgs.msg", Odometry=Odometry)
    mod("nav_msgs", msg=mods["nav_msgs.msg"])
    mod("sensor_msgs.msg", Image=Image, Imu=Imu, PointCloud2=PointCloud2,
        PointField=PointField, CameraInfo=CameraInfo)
    mod("sensor_msgs", msg=mods["sensor_msgs.msg"])
    mod("tf2_ros", TransformBroadcaster=_TFBroadcaster)

    saved = {k: sys.modules.get(k) for k in mods}
    sys.modules.update(mods)
    import orb_slam3_ros2_tpu.runtime.ros_bridge as jrb
    import orb_slam3_ros2_tpu_torch.runtime.ros_bridge as rb

    try:
        rb, jrb = importlib.reload(rb), importlib.reload(jrb)
        assert rb.HAVE_ROS and jrb.HAVE_ROS
        yield rb, jrb
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
        importlib.reload(rb)
        importlib.reload(jrb)


def test_bridge_without_rclpy_has_no_nodes():
    import orb_slam3_ros2_tpu_torch.runtime.ros_bridge as rb

    if "rclpy" in sys.modules and sys.modules["rclpy"] is not None:
        pytest.skip("rclpy is installed")
    assert rb.HAVE_ROS is False and not hasattr(rb, "TpuSlamNode")


@pytest.mark.parametrize("window", [1, 4])
def test_madgwick_node_equals_jax(bridges, window):
    rb, jrb = bridges
    node = rb.MadgwickImuNode(window=window, device="cpu")
    ref = jrb.MadgwickImuNode(window=window)
    rng = np.random.default_rng(0)
    for i in range(10):
        g = tuple(rng.normal(0, 0.2, 3))
        a = tuple(np.array([0.0, 0.0, 9.81]) + rng.normal(0, 0.3, 3))
        t = 1.0 + 0.005 * i
        node.subs["orb_camera/imu"](_imu_msg(t, g, a))
        ref.subs["orb_camera/imu"](_imu_msg(t, g, a))
    node.subs["orb_camera/imu"](_imu_msg(1.2, (0.0, np.nan, 0.0),
                                         (0.0, 0.0, 9.81)))
    for n in (node, ref):
        for period, cb in n.timers:
            cb()  # the stream-gap flush of a partial window
    got, want = node.pubs["rtabmap/imu"].msgs, ref.pubs["rtabmap/imu"].msgs
    assert len(got) == len(want) == 10
    for m, jm in zip(got, want):
        np.testing.assert_allclose(
            [m.orientation.w, m.orientation.x, m.orientation.y,
             m.orientation.z],
            [jm.orientation.w, jm.orientation.x, jm.orientation.y,
             jm.orientation.z], atol=1e-6)
    assert len(node._tf.sent) == len(ref._tf.sent)
    assert node._tf.sent[0].header.frame_id == "odom"
    assert node._tf.sent[0].child_frame_id == "base_link"


def _image_msg(img, t):
    msg = Image()
    msg.header.stamp = _Stamp(0, int(float(t) * 1e9))
    msg.data = img.astype(np.uint8)
    return msg


def _odom_centre(node):
    for period, cb in node.timers:
        if abs(period - 0.1) < 1e-9:
            cb()
    p = node.pubs["orb_odom"].msgs[-1].pose.pose.position
    return np.array([p.x, p.y, p.z])


def test_slam_node_tracks_images_and_publishes_odom(
        bridges, tmp_path, monkeypatch, two_threads):  # noqa: F811
    """The port node tracks a clip and publishes the System's centre; then
    a port node and a JAX node resume from the same Atlas file (the
    settings' `System.LoadAtlasFromFile`, so neither runs the initializer
    and its random draws) and take the same image messages. Each node
    relocalizes into the loaded map and tracks; their odometry agrees
    within 1e-3 m (measured: 4e-4 m; the camera moves ~1e-2 m a frame).
    `tests/test_torch_tracking.py` holds the frame step to the JAX System
    at 5e-3 m: the two pyramids round apart."""
    rb, jrb = bridges
    from orb_slam3_ros2_tpu_torch.io import synthetic

    monkeypatch.chdir(tmp_path)  # the sessions write under ./output
    n, n_more = 16, 4
    images, _, _, ts = synthetic.render_sequence(
        n_frames=n + n_more, width=320, height=240, fx=260.0, fy=260.0,
        fps=10.0, seed=1, plane_depths=(6.0, 9.0), traj_scale=1.6)
    node = rb.TpuSlamNode(SETTINGS, sensor="monocular",
                          output_name="rosbridge", device="cpu")
    img_cb = node.subs["camera/camera/color/image_raw"]
    imu_cb = node.subs["camera/camera/imu"]
    imu_cb(_imu_msg(0.01, (0.0, 0.0, 0.0), (0.0, 0.0, 9.81)))
    for k in range(n):
        img_cb(_image_msg(images[k], ts[k]))
    slam = node.session.system
    assert slam.n_frames == n
    assert slam.get_tracking_state().name == "OK"
    T = slam.Tcw
    np.testing.assert_allclose(_odom_centre(node), -T[:3, :3].T @ T[:3, 3],
                               atol=1e-6)

    atlas = slam.save_atlas(str(tmp_path / "node_atlas.npz"))
    resume = tmp_path / "resume.yaml"
    with open(SETTINGS) as f:
        resume.write_text(f.read()
                          + f'\nSystem.LoadAtlasFromFile: "{atlas}"\n')
    port = rb.TpuSlamNode(str(resume), sensor="monocular",
                          output_name="resume_port", device="cpu")
    ref = jrb.TpuSlamNode(str(resume), sensor="monocular",
                          output_name="resume_jax")
    assert int(port.session.system.map.n_kf) == int(
        ref.session.system.map.n_kf) == int(slam.map.n_kf)
    for k in range(n, n + n_more):
        for nd in (port, ref):
            nd.subs["camera/camera/color/image_raw"](
                _image_msg(images[k], ts[k]))
        assert port.session.system.get_tracking_state().name == \
            ref.session.system.get_tracking_state().name == "OK", k
        np.testing.assert_allclose(_odom_centre(port), _odom_centre(ref),
                                   atol=1e-3, err_msg=f"frame {k}")


def test_camera_info_node_equals_jax(bridges):
    rb, jrb = bridges
    node, ref = rb.CameraInfoNode(SETTINGS), jrb.CameraInfoNode(SETTINGS)
    node._tick()
    ref._tick()
    m, jm = node.pubs["orb_camera_info"].msgs[0], ref.pubs[
        "orb_camera_info"].msgs[0]
    for f in ("width", "height", "distortion_model", "d", "k", "r", "p"):
        assert getattr(m, f) == getattr(jm, f), f
    assert m.width == 320 and abs(m.k[0] - 260.0) < 1e-6


def test_cloud_republisher_streams_pcd(bridges, tmp_path):
    rb, _ = bridges
    from orb_slam3_ros2_tpu_torch.runtime.outputs import save_pcd

    pts = np.random.default_rng(0).normal(0, 1, (50, 3)).astype(np.float32)
    d = tmp_path / "mymap" / "cloud"
    d.mkdir(parents=True)
    save_pcd(str(d / "mymap.pcd"), pts)
    node = rb.CloudRepublisherNode("mymap", output_root=str(tmp_path))
    node._tick()
    msg = node.pubs["full_cloud"].msgs[0]
    assert msg.width == 50 and msg.point_step == 12
    np.testing.assert_allclose(
        np.frombuffer(msg.data, np.float32).reshape(-1, 3), pts, atol=1e-6)
