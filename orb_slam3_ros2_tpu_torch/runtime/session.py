"""Live/replay session runner — the wrapper-node equivalent (L1 layer).

Reproduces the behavior of the reference's main bridge node
`imu_mono_node_cpp` (`src/imu_mono_realsense.cpp`):

* consumes an image + IMU stream (here: via the native feeder or a dataset
  iterator instead of DDS topics),
* feeds the engine per frame (§3.2 hot path) with correctly interleaved IMU,
* maintains the 10 Hz-style output products (§3.3): current odometry pose,
  growing trajectory, filtered map cloud,
* on shutdown saves `output/<name>/cloud/<name>.pcd` and
  `output/<name>/grid/<name>.{pgm,yaml}` (ctor/on_shutdown paths :140-170)
  and an annotated tracking video (:174-185),
* resets accumulated outputs on VIBA1/VIBA2 transitions (:485-495).

Port of `orb_slam3_ros2_tpu/runtime/session.py` over the port's `System`.
The one new argument is `device`, passed to the `System` the session makes
(None: the card; "cpu" only when the caller asks). The artifacts are the
JAX session's, in the same formats: the Atlas checkpoint is the `.npz` both
packages read, and the shutdown record reads the map's tensors with one
`.cpu()` each. A checkpoint is timed as the System tracer's `checkpoint`
stage.
"""

from __future__ import annotations

import os
import time
from typing import Iterable, Optional, Tuple

import numpy as np

from orb_slam3_ros2_tpu_torch.runtime import outputs as out_mod
from orb_slam3_ros2_tpu_torch.runtime.system import ImuPoint, Sensor, System


class SlamSession:
    def __init__(
        self,
        settings_path: str,
        sensor: Sensor = Sensor.MONOCULAR,
        output_name: Optional[str] = None,
        output_root: str = "output",
        record_video: bool = False,
        system: Optional[System] = None,
        checkpoint_every: Optional[int] = None,
        device=None,
    ):
        self.system = system or System(None, settings_path, sensor,
                                       device=device)
        # periodic atlas checkpoint for host-failure recovery (SURVEY §5:
        # the reference only saves on clean shutdown; long multi-host runs
        # need restartability). Resume via System.LoadAtlasFromFile or
        # run_slam --load-atlas.
        self.checkpoint_every = checkpoint_every
        self._frames_fed = 0
        self.name = output_name or time.strftime("%Y-%m-%d_%H-%M-%S")
        self.out_dir = os.path.join(output_root, self.name)
        self.video: Optional[out_mod.VideoRecorder] = None
        if record_video:
            self.video = out_mod.VideoRecorder(
                os.path.join(self.out_dir, "video", f"{self.name}.mp4"),
                fps=self.system.cam.fps,
                size=(640, 500),
            )
        self._last_ba1 = False
        self._last_ba2 = False
        self.pose_history = []  # reset on VIBA transitions like the wrapper

    def feed(self, img: np.ndarray, t: float, imu: Iterable = ()) -> np.ndarray:
        imu_points = [
            p if isinstance(p, ImuPoint) else ImuPoint(p[4:7], p[1:4], p[0])
            for p in imu
        ]
        T = self.system.track_monocular(img, t, imu_points)

        # VIBA edge detection → reset accumulated outputs (wrapper :485-495)
        ba1, ba2 = self.system.get_inertial_ba1(), self.system.get_inertial_ba2()
        if (ba1 and not self._last_ba1) or (ba2 and not self._last_ba2):
            self.pose_history = []
        self._last_ba1, self._last_ba2 = ba1, ba2

        self.pose_history.append((t, T))
        self.maybe_checkpoint()
        if self.video is not None:
            frame = self.system.get_pretty_frame(np.asarray(img, np.uint8))
            if frame is not None:
                self.video.write(frame)
        return T

    def maybe_checkpoint(self) -> Optional[str]:
        """Checkpoint the atlas every `checkpoint_every` fed frames."""
        self._frames_fed += 1
        if (self.checkpoint_every
                and self._frames_fed % self.checkpoint_every == 0):
            path = os.path.join(self.out_dir, "checkpoint_atlas.npz")
            os.makedirs(self.out_dir, exist_ok=True)
            with self.system.tracer.stage("checkpoint"):
                return self.system.save_atlas(path)
        return None

    def filtered_cloud(self) -> np.ndarray:
        return out_mod.filter_point_cloud(self.system.get_map_pcl())

    def save_trajectory_tum(self, path: Optional[str] = None) -> str:
        """TUM-format trajectory (t x y z qx qy qz qw) — the standard ATE
        evaluation input (upstream ORB-SLAM3 saves the same format)."""
        from scipy.spatial.transform import Rotation

        path = path or os.path.join(self.out_dir, f"{self.name}_traj.txt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            for t, T in self.system.get_frame_trajectory():
                R, tt = T[:3, :3], T[:3, 3]
                # camera center + world-from-camera quaternion
                c = -R.T @ tt
                q = Rotation.from_matrix(R.T).as_quat()  # x, y, z, w
                f.write(
                    f"{t:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
                )
        return path

    def save_trajectory_kitti(self, path: Optional[str] = None) -> str:
        """KITTI-format trajectory (12 numbers per row: flattened 3x4
        world-from-camera [R|t]) — upstream `SaveTrajectoryKITTI` parity,
        the KITTI odometry benchmark's input format."""
        path = path or os.path.join(self.out_dir,
                                    f"{self.name}_traj_kitti.txt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            for _, T in self.system.get_frame_trajectory():
                R, tt = T[:3, :3], T[:3, 3]
                Rwc, twc = R.T, -R.T @ tt
                row = np.column_stack([Rwc, twc]).ravel()
                f.write(" ".join(f"{v:.6e}" for v in row) + "\n")
        return path

    def shutdown(self) -> dict:
        """Save artifacts (reference on_shutdown hook :158-170)."""
        artifacts = {}
        cloud = self.filtered_cloud()
        pcd = os.path.join(self.out_dir, "cloud", f"{self.name}.pcd")
        out_mod.save_pcd(pcd, cloud)
        artifacts["pcd"] = pcd
        grid, origin = out_mod.point_cloud_to_occupancy_grid(cloud)
        base = os.path.join(self.out_dir, "grid", self.name)
        out_mod.save_occupancy_grid(base, grid, origin)
        artifacts["grid"] = base + ".pgm"
        artifacts["trajectory"] = self.save_trajectory_tum()
        # structured event log (SURVEY §5 metrics/logging): one JSON line per
        # tracked frame + a final summary with per-stage timing stats
        import json

        ev_path = os.path.join(self.out_dir, f"{self.name}_events.jsonl")
        with open(ev_path, "w") as f:
            for rec in self.system.tracking_log:
                f.write(json.dumps(rec) + "\n")
            f.write(json.dumps({
                "event": "shutdown",
                "keyframes": int(self.system.map.n_kf),
                "landmarks": int(self.system.map.lm_valid.sum()),
                "maps": int(self.system.atlas.n_maps()),
                "stages": self.system.tracer.report(),
            }) + "\n")
        artifacts["events"] = ev_path
        if self.video is not None:
            self.video.close()
            artifacts["video"] = os.path.join(
                self.out_dir, "video", f"{self.name}.mp4"
            )
        atlas_path = self.system.save_atlas()
        if atlas_path:
            artifacts["atlas"] = atlas_path
        self.system.shutdown()
        return artifacts
