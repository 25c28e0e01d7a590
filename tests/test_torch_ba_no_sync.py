"""The global BA on the card makes no host sync (`backend/ba.py`: "the
loop makes no host sync"), held under `torch.cuda.set_sync_debug_mode
("error")`; marked `cuda`, it skips without a card. `tiny_map` is the small
map this test and the CPU span tests of `tests/test_torch_tracing.py`
solve."""

import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
from orb_slam3_ros2_tpu_torch.frontend import tracking as trk

CAM = (200.0, 200.0, 160.0, 120.0)  # fx, fy, cx, cy of a 320x240 pinhole


def tiny_map(device, n_kf: int = 6, max_kf: int = 8, n_lm: int = 64,
             seed: int = 0):
    """(map, n_kf): n_kf keyframes (of max_kf slots) on a line looking
    down +z at n_lm landmarks 4-8 m away, each keyframe observing about
    80% of them with 0.5 px of noise; poses (but keyframe 0) moved 2 cm and
    points 3 cm off the truth."""
    rng = np.random.default_rng(seed)
    K, L = max_kf, n_lm
    fx, fy, cx, cy = CAM
    X = np.stack([rng.uniform(-2.0, 2.0, L), rng.uniform(-1.5, 1.5, L),
                  rng.uniform(4.0, 8.0, L)], -1)
    centre = np.zeros((K, 3))
    centre[:, 0] = 0.2 * np.arange(K)
    xc = X[None] - centre[:, None]
    uv = np.stack([fx * xc[..., 0] / xc[..., 2] + cx,
                   fy * xc[..., 1] / xc[..., 2] + cy], -1)
    uv += 0.5 * rng.standard_normal(uv.shape)
    seen = (rng.uniform(size=(K, L)) < 0.8) & (np.arange(K) < n_kf)[:, None]
    t = -centre + 0.02 * rng.standard_normal((K, 3))
    t[0] = -centre[0]
    fields = dict(
        kf_R=np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)),
        kf_t=t.astype(np.float32), kf_valid=np.arange(K) < n_kf,
        kf_time=np.arange(K, dtype=np.float32),
        kf_uv=np.where(seen[..., None], uv, 0.0).astype(np.float32),
        kf_level=np.zeros((K, L), np.int32),
        kf_bits=np.zeros((K, L, 8), np.int32), kf_feat_valid=seen,
        kf_obs_lm=np.where(seen, np.arange(L), -1).astype(np.int32),
        lm_X=(X + 0.03 * rng.standard_normal(X.shape)).astype(np.float32),
        lm_valid=np.ones(L, bool), lm_bits=np.zeros((L, 8), np.int32),
        lm_ref_kf=np.zeros(L, np.int32),
        lm_n_obs=seen.sum(0).astype(np.int32),
        lm_found=np.ones(L, np.int32), lm_visible=np.ones(L, np.int32),
        n_kf=np.int32(n_kf), n_lm=np.int32(L))
    return ms.from_numpy(fields, device=device), n_kf


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_global_ba_makes_no_host_sync(cuda_device):
    """A second global BA (the first makes the libraries' handles) on a
    16-keyframe, 1024-landmark map raises on any synchronizing call."""
    m, n_kf = tiny_map(cuda_device, n_kf=14, max_kf=16, n_lm=1024)
    trk.global_ba(m, n_kf, *CAM, n_iters=8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = trk.global_ba(m, n_kf, *CAM, n_iters=8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.lm_X).all())
    assert not torch.equal(out.lm_X, m.lm_X)
