"""The benchmark of the PyTorch/CUDA port (`orb_slam3_ros2_tpu_torch`):
`python3 -m slambench.run --workload CELL --seed N --seconds S --trace 0|1`
(see README.md)."""
