"""Place recognition and loop closing (port of `orb_slam3_ros2_tpu/loop/`)."""
