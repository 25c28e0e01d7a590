"""Optional ROS 2 bridge — thin topic shim over SlamSession (L1 parity).

Reproduces the reference node's topic surface
(`src/imu_mono_realsense.cpp`):

subscriptions: image (RELIABLE, :116-120), IMU (BEST_EFFORT, :121-128)
publications (10 Hz timer, :370-496): `orb_odom` TF + nav_msgs/Odometry
(:398-422), PoseArray trajectory (:424-434), PointCloud2 filtered map
(:460-480); plus `orb_camera_info` at ~30 Hz from the settings YAML
(`src/orb_camera_info.cpp:16-39`), the offline cloud republisher
(`src/visualize.cpp:70-77`), and the Madgwick IMU orientation filter the
rtabmap stack inserts (`launch/rtabmap.launch.py:67-84`).

This container has no rclpy; the module is import-gated so the same code
runs as a real ROS 2 node where ROS is present and is unit-tested through
`SlamSession` here. The engine never depends on ROS: the bridge is a thin
host feeder into it.

Copied from `orb_slam3_ros2_tpu/runtime/ros_bridge.py`, over the port's
`SlamSession`, `cam_source`, `outputs.load_pcd` and `imu/madgwick.py`.
`TpuSlamNode` and `MadgwickImuNode` take a `device` (None: the card, as
every entry point of the port), and the Madgwick node reads the filter's
quaternions back with one `.cpu()` per window.
"""

from __future__ import annotations

from typing import Optional

try:
    import rclpy  # type: ignore
    from rclpy.node import Node  # type: ignore

    HAVE_ROS = True
except ImportError:  # pragma: no cover - exercised only on ROS images
    HAVE_ROS = False
    Node = object  # type: ignore


if HAVE_ROS:  # pragma: no cover - requires a ROS 2 environment

    import numpy as np
    from cv_bridge import CvBridge  # type: ignore
    from geometry_msgs.msg import PoseArray  # type: ignore
    from nav_msgs.msg import Odometry  # type: ignore
    from sensor_msgs.msg import Image, Imu, PointCloud2, PointField  # type: ignore

    from orb_slam3_ros2_tpu_torch.runtime.session import SlamSession
    from orb_slam3_ros2_tpu_torch.runtime.system import ImuPoint, Sensor

    class TpuSlamNode(Node):
        """`imu_mono_node_cpp` equivalent backed by the engine."""

        def __init__(self, settings_path: str, sensor: str = "imu_monocular",
                     output_name: Optional[str] = None, device=None):
            super().__init__("tpu_slam_node")
            mode = (Sensor.IMU_MONOCULAR if "imu" in sensor
                    else Sensor.MONOCULAR)
            self.session = SlamSession(
                settings_path, mode, output_name=output_name,
                record_video=True, device=device,
            )
            self.bridge = CvBridge()
            self.imu_buf = []
            self.create_subscription(
                Image, "camera/camera/color/image_raw", self.image_cb, 10
            )
            self.create_subscription(
                Imu, "camera/camera/imu", self.imu_cb,
                rclpy.qos.qos_profile_sensor_data,
            )
            self.odom_pub = self.create_publisher(Odometry, "orb_odom", 10)
            self.posearray_pub = self.create_publisher(
                PoseArray, "orb_pose_array", 10
            )
            self.cloud_pub = self.create_publisher(
                PointCloud2, "orb_point_cloud", 10
            )
            self.create_timer(0.1, self.timer_cb)

        def imu_cb(self, msg):
            t = msg.header.stamp.sec + msg.header.stamp.nanosec * 1e-9
            self.imu_buf.append(ImuPoint(
                [msg.linear_acceleration.x, msg.linear_acceleration.y,
                 msg.linear_acceleration.z],
                [msg.angular_velocity.x, msg.angular_velocity.y,
                 msg.angular_velocity.z], t,
            ))

        def image_cb(self, msg):
            t = msg.header.stamp.sec + msg.header.stamp.nanosec * 1e-9
            img = self.bridge.imgmsg_to_cv2(msg, "mono8")
            imu, self.imu_buf = (
                [p for p in self.imu_buf if p.t <= t],
                [p for p in self.imu_buf if p.t > t],
            )
            self.session.system.track_monocular(img, t, imu)

        def timer_cb(self):
            T = self.session.system.Tcw
            R, tt = T[:3, :3], T[:3, 3]
            c = -R.T @ tt
            msg = Odometry()
            msg.header.frame_id = "map"
            msg.header.stamp = self.get_clock().now().to_msg()
            msg.pose.pose.position.x = float(c[0])
            msg.pose.pose.position.y = float(c[1])
            msg.pose.pose.position.z = float(c[2])
            self.odom_pub.publish(msg)

    class CameraInfoNode(Node):
        """`orb_camera_info_node` equivalent: CameraInfo from the settings
        YAML at ~33 ms (`src/orb_camera_info.cpp:16-39`)."""

        def __init__(self, settings_path: str,
                     topic: str = "orb_camera_info"):
            super().__init__("orb_camera_info")
            from sensor_msgs.msg import CameraInfo as CameraInfoMsg  # type: ignore

            from orb_slam3_ros2_tpu_torch.runtime.cam_source import (
                camera_info_from_settings,
            )

            info = camera_info_from_settings(settings_path)
            msg = CameraInfoMsg()
            msg.width, msg.height = info.width, info.height
            msg.distortion_model = info.distortion_model
            msg.d = [float(v) for v in info.d]
            msg.k = [float(v) for v in info.k.ravel()]
            msg.r = [float(v) for v in info.r.ravel()]
            msg.p = [float(v) for v in info.p.ravel()]
            self._msg = msg
            self._pub = self.create_publisher(CameraInfoMsg, topic, 10)
            self.create_timer(0.033, self._tick)

        def _tick(self):
            self._msg.header.stamp = self.get_clock().now().to_msg()
            self._pub.publish(self._msg)

    class CloudRepublisherNode(Node):
        """`visualize_node` equivalent: load `output/<name>/cloud/<name>.pcd`
        and republish at 1 Hz (`src/visualize.cpp:51-77`)."""

        def __init__(self, output_name: str, output_root: str = "output"):
            super().__init__("visualize")
            import os

            from orb_slam3_ros2_tpu_torch.runtime.outputs import load_pcd

            path = os.path.join(output_root, output_name, "cloud",
                                f"{output_name}.pcd")
            self._pts = load_pcd(path).astype(np.float32)
            self._pub = self.create_publisher(PointCloud2, "full_cloud", 10)
            self.create_timer(1.0, self._tick)

        def _tick(self):
            msg = PointCloud2()
            msg.header.frame_id = "map"
            msg.header.stamp = self.get_clock().now().to_msg()
            msg.height, msg.width = 1, self._pts.shape[0]
            msg.fields = [
                PointField(name=n, offset=4 * i,
                           datatype=PointField.FLOAT32, count=1)
                for i, n in enumerate("xyz")
            ]
            msg.point_step, msg.row_step = 12, 12 * self._pts.shape[0]
            msg.is_dense = True
            msg.data = self._pts.tobytes()
            self._pub.publish(msg)

    class MadgwickImuNode(Node):
        """`imu_filter_madgwick` equivalent: fill IMU orientation via the
        Madgwick AHRS filter (`launch/rtabmap.launch.py:67-84`:
        `orb_camera/imu` in, orientation-filled `rtabmap/imu` out,
        use_mag=false, world_frame=odom, publish_tf=true).

        The reference node republishes each message immediately; this node
        does the same by default (window=1) — downstream rtabmap sync needs
        a steady stream. A window > 1 batches samples into one filter call
        (replay / offline throughput mode); a timer flushes any partial
        window so a paused stream never strands samples. With
        `publish_tf=True` the filtered odom→base_link orientation is also
        broadcast on TF, matching the reference launch parameters."""

        def __init__(self, in_topic: str = "orb_camera/imu",
                     out_topic: str = "rtabmap/imu", beta: float = 0.1,
                     window: int = 1, publish_tf: bool = True,
                     world_frame: str = "odom",
                     base_link_frame: str = "base_link", device=None):
            super().__init__("imu_filter_madgwick")
            from orb_slam3_ros2_tpu_torch.imu.madgwick import MadgwickFilter

            self._filter = MadgwickFilter(beta=beta, device=device)
            self._window = max(int(window), 1)
            self._buf = []  # (msg, t, gyro, acc) pending one filter call
            self._pub = self.create_publisher(Imu, out_topic, 10)
            self.create_subscription(Imu, in_topic, self._imu_cb, 50)
            self._world_frame = world_frame
            self._base_link_frame = base_link_frame
            self._tf = None
            if publish_tf:
                try:
                    from tf2_ros import TransformBroadcaster  # type: ignore

                    self._tf = TransformBroadcaster(self)
                except ImportError:
                    self.get_logger().warning(
                        "tf2_ros unavailable; Madgwick TF disabled")
            # stream-gap flush: partial windows publish promptly even when
            # the IMU stream pauses mid-window
            if self._window > 1:
                self.create_timer(0.05, self._flush_pending)

        def _imu_cb(self, msg):
            t = msg.header.stamp.sec + msg.header.stamp.nanosec * 1e-9
            g = (msg.angular_velocity.x, msg.angular_velocity.y,
                 msg.angular_velocity.z)
            a = (msg.linear_acceleration.x, msg.linear_acceleration.y,
                 msg.linear_acceleration.z)
            if not all(np.isfinite(v) for v in (*g, *a)):
                return  # NaN rejection, src/imu_mono_realsense.cpp:355-366
            self._buf.append((msg, t, g, a))
            if len(self._buf) >= self._window:
                self._flush()

        def _flush_pending(self):
            if self._buf:
                self._flush()

        def _flush(self):
            msgs = self._buf
            self._buf = []
            qs = self._filter.update(
                np.array([b[2] for b in msgs], np.float32),
                np.array([b[3] for b in msgs], np.float32),
                np.array([b[1] for b in msgs]),
            ).cpu().numpy()
            for (msg, _, _, _), (w, x, y, z) in zip(msgs, qs):
                msg.orientation.w = float(w)
                msg.orientation.x = float(x)
                msg.orientation.y = float(y)
                msg.orientation.z = float(z)
                self._pub.publish(msg)
            if self._tf is not None and msgs:
                from geometry_msgs.msg import TransformStamped  # type: ignore

                tf = TransformStamped()
                tf.header.stamp = msgs[-1][0].header.stamp
                tf.header.frame_id = self._world_frame
                tf.child_frame_id = self._base_link_frame
                w, x, y, z = (float(v) for v in qs[-1])
                tf.transform.rotation.w = w
                tf.transform.rotation.x = x
                tf.transform.rotation.y = y
                tf.transform.rotation.z = z
                self._tf.sendTransform(tf)

    def main(args=None):  # pragma: no cover
        import sys

        rclpy.init(args=args)
        node = TpuSlamNode(sys.argv[1])
        try:
            rclpy.spin(node)
        finally:
            node.session.shutdown()
            rclpy.shutdown()
