"""The port runs where JAX is absent: in a fresh interpreter whose `jax`
import fails, every module of `orb_slam3_ros2_tpu_torch` imports and
`frame_step` tracks a small image on the CPU."""

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
for name in names:
    importlib.import_module(name)
assert not any(k in ("jax", "orb_slam3_ros2_tpu")
               or k.startswith(("jax.", "orb_slam3_ros2_tpu."))
               for k, v in sys.modules.items() if v is not None)

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
print("ok", len(names), int(s[13]))
"""


def test_port_imports_and_tracks_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")
