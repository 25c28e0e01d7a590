"""The port runs where JAX is absent: in a fresh interpreter whose `jax`
import fails, every module of `orb_slam3_ros2_tpu_torch` imports (the
stereo module by name too), `frame_step` tracks a small image on the CPU,
`System.track_monocular` takes two frames (the second one runs the matcher
and the initializer), `System.track_stereo` takes one rendered pair
(stereo matching and the one-frame initialization), and so does an
IMU_STEREO System with an IMU sample, beside a preintegration and a VI
initialization (the forward-mode Jacobians), and a `SlamSession` takes two
frames and writes its PCD cloud, PGM grid and TUM trajectory on
`shutdown()`."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
import torch
import orb_slam3_ros2_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
assert "orb_slam3_ros2_tpu_torch.frontend.stereo" in names
for name in names:
    importlib.import_module(name)
assert not any(k in ("jax", "orb_slam3_ros2_tpu")
               or k.startswith(("jax.", "orb_slam3_ros2_tpu."))
               for k, v in sys.modules.items() if v is not None)
# importing parallel/ starts no process group
import torch.distributed as dist
assert not (dist.is_available() and dist.is_initialized())
assert "orb_slam3_ros2_tpu_torch.parallel.live_session" in names

from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
from orb_slam3_ros2_tpu_torch.io.synthetic import _texture
from orb_slam3_ros2_tpu_torch.models import cameras
from orb_slam3_ros2_tpu_torch.runtime import system

H, W, F = 120, 160, 150.0
img = torch.from_numpy(_texture(H, W, seed=3).astype(np.float32))
cam = cameras.make_camera("PinHole", F, F, W / 2, H / 2, (0.0,) * 4, W, H)
cfg = ex.ExtractorConfig(n_features=200, n_levels=3, height=H, width=W)
f = ex.make_extractor(cfg)(img)
z = 5.0
X = torch.stack([(f.uv[:, 0] - W / 2) / F * z, (f.uv[:, 1] - H / 2) / F * z,
                 torch.full_like(f.uv[:, 0], z)], -1)
m = ms.empty_map(ms.MapConfig(max_kf=4, max_lm=512, n_feat=200))
R, t = torch.eye(3), torch.zeros(3)
m = ms.insert_keyframe(m, R, t, 0.0, f.uv, f.level, f.bits, f.mask,
                       torch.full((200,), -1, dtype=torch.int32))
ids = torch.arange(200, dtype=torch.int32)
m = ms.add_landmarks(m, X, f.bits, f.mask, 0, 0, ids, 0, ids)
m2, f_u, obs, R1, t1, s = system.frame_step(m, R, t, R, t, img, cam, cfg)
assert s.shape == (16,) and torch.isfinite(s).all()
assert int(s[13]) >= 15, s
assert float((t1 - t).abs().max()) < 1e-3

import os, tempfile
from orb_slam3_ros2_tpu_torch.backend import ba, schur
from orb_slam3_ros2_tpu_torch.frontend import initializer
from orb_slam3_ros2_tpu_torch.io.synthetic import render_sequence
from orb_slam3_ros2_tpu_torch.ops import frontend_level
from orb_slam3_ros2_tpu_torch.runtime.system import System, TrackingState

SW, SH, SF = 320, 240, 260.0
imgs, _, _, ts = render_sequence(n_frames=3, width=SW, height=SH, fx=SF,
                                 fy=SF, fps=10.0, seed=1)
cfg_path = os.path.join(tempfile.mkdtemp(), "cam.yaml")
with open(cfg_path, "w") as fh:
    fh.write("%YAML:1.0\nCamera.type: \"Rectified\"\n"
             f"Camera1.fx: {SF}\nCamera1.fy: {SF}\nCamera1.cx: {SW / 2}\n"
             f"Camera1.cy: {SH / 2}\nCamera.width: {SW}\n"
             f"Camera.height: {SH}\nCamera.fps: 10\n"
             "ORBextractor.nFeatures: 400\nORBextractor.nLevels: 3\n"
             "loopClosing: 0\n")
init_calls = []
init_fn = initializer.initialize
initializer.initialize = lambda *a, **kw: init_calls.append(1) or init_fn(
    *a, **kw)
slam = System(None, cfg_path, device="cpu")
for k in (0, 2):
    T = slam.track_monocular(imgs[k], float(ts[k]))
    assert T.shape == (4, 4) and np.isfinite(T).all()
assert slam.n_frames == 2 and init_calls == [1], init_calls
assert slam.get_tracking_state() in (TrackingState.NOT_INITIALIZED,
                                     TrackingState.OK)

from orb_slam3_ros2_tpu_torch.frontend import stereo
from orb_slam3_ros2_tpu_torch.runtime.system import Sensor

imgs_l, imgs_r, _, _, ts = render_sequence(
    n_frames=1, width=SW, height=SH, fx=SF, fy=SF, fps=10.0, seed=2,
    plane_depths=(5.0, 8.0), stereo_baseline=0.12)
with open(cfg_path, "a") as fh:
    fh.write("Stereo.b: 0.12\n")
rig = System(None, cfg_path, Sensor.STEREO, device="cpu")
obs = []
stereo_obs = rig._stereo_obs
rig._stereo_obs = lambda *a: obs.append(stereo_obs(*a)) or obs[-1]
T = rig.track_stereo(imgs_l[0], imgs_r[0], float(ts[0]))
assert T.shape == (4, 4) and np.isfinite(T).all()
assert isinstance(obs[0], stereo.StereoObs) and int(obs[0].valid.sum()) >= 80
assert rig.get_tracking_state() == TrackingState.OK
assert int(rig.map.n_lm) == int(obs[0].valid.sum())

from orb_slam3_ros2_tpu_torch.imu import preintegration, vi_init
from orb_slam3_ros2_tpu_torch.runtime.system import ImuPoint

vi = System(None, cfg_path, Sensor.IMU_STEREO, device="cpu")
T = vi.track_stereo(imgs_l[0], imgs_r[0], float(ts[0]),
                    [ImuPoint([0.0, 0.0, 9.81], [0.0, 0.0, 0.1], 0.0)])
assert np.isfinite(T).all() and len(vi._kf_imu_buf) == 1
g = torch.tensor([[0.0, 0.0, 0.1]] * 20)
a = torch.tensor([[0.0, 0.0, 9.81]] * 20)
pres = preintegration.stack([preintegration.preintegrate(
    g, a, torch.full((20,), 0.005), torch.ones(20, dtype=torch.bool))] * 2)
out = vi_init.vi_init(pres, torch.eye(3).repeat(3, 1, 1),
                      torch.zeros((3, 3)), n_iters=2, fix_scale=True)
assert torch.isfinite(out.R_wg).all() and float(out.scale) == 1.0

from orb_slam3_ros2_tpu_torch.runtime.session import SlamSession

sess = SlamSession(cfg_path, Sensor.MONOCULAR, output_name="nojax",
                   output_root=tempfile.mkdtemp(), device="cpu")
for k in (0, 2):
    sess.feed(imgs[k], float(k) * 0.1)
art = sess.shutdown()
for key in ("pcd", "grid", "trajectory"):
    assert os.path.isfile(art[key]), (key, art)
assert len(open(art["trajectory"]).read().splitlines()) == 2
assert not any(k in ("jax", "orb_slam3_ros2_tpu")
               or k.startswith(("jax.", "orb_slam3_ros2_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("ok", len(names), int(s[13]))
"""


def test_port_imports_and_tracks_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")
