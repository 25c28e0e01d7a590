"""The plain references against the program's plain versions on the CPU,
at tiny sizes: where both compute the same thing, they agree."""

import numpy as np
import pytest
import torch

from slambench import harness, scene
from slambench.gen import gba_map
from slambench.reference import ba as ref_ba
from slambench.reference import extract as ref_ex
from slambench.reference import pose as ref_pose
from slambench.reference import preint as ref_pre

PARAMS = (229.327, 228.648, 183.6075, 124.1875, -0.28340811, 0.07395907,
          0.00019359, 1.76187114e-05, 0.0)


def _image(h=240, w=376):
    dev = torch.device("cpu")
    planes = scene.room_planes(0, dev, tex_hw=(180, 240))
    rays = scene.pinhole_rays(PARAMS, w, h, dev)
    orbit = scene.Orbit.from_params(harness.load_json(
        harness.ROOT / "slambench" / "traffic" / "orbit.json")["orbit"])
    R, t = scene.lap_poses(orbit, 1, 20.0)
    frame = scene.render_rays(planes, rays, torch.as_tensor(R).float(),
                              torch.as_tensor(t).float())
    g = torch.Generator().manual_seed(1)
    return scene.photometric(frame, scene.vignette_of(rays),
                             torch.ones(1), 3.0, g)[0].float()


def test_extractor_equals_the_programs_plain_extractor():
    from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
    from orb_slam3_ros2_tpu_torch.models import cameras
    from orb_slam3_ros2_tpu_torch.runtime import system as sysm

    img = _image()
    cfg = ex.ExtractorConfig(n_features=500, n_levels=8, scale_factor=1.2,
                             ini_th_fast=20.0, min_th_fast=7.0,
                             height=240, width=376)
    f = ex.make_extractor(cfg)(img)
    cam = cameras.make_camera("PinHole", *PARAMS[:4], dist=PARAMS[4:],
                              width=376, height=240)
    prog = dict(uv=sysm.undistort(cam, f.uv), level=f.level, bits=f.bits,
                mask=f.mask)
    ref = ref_ex.extract(img, 500, 8, 1.2, 20.0, 7.0, PARAMS)
    bad, tot = ref_ex.mismatch(prog, ref, uv_tol=0.0)
    assert tot > 300 and bad == 0
    # a changed image changes features
    ref2 = ref_ex.extract(img.flip(1), 500, 8, 1.2, 20.0, 7.0, PARAMS)
    assert ref_ex.mismatch(prog, ref2)[0] > 0.5 * tot


def _tiny_map(seed=5, K=16, L=400):
    cfg = harness.load_json(harness.ROOT / "slambench/configs/euroc_mono.json")
    tr = harness.load_json(harness.ROOT / "slambench/traffic/gba_map.json")
    tr.update(keyframes=K, landmarks=L, candidates=3000)
    return gba_map.make_map(cfg, tr, seed, torch.device("cpu"))


def test_ba_matches_the_programs_global_ba():
    from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
    from orb_slam3_ros2_tpu_torch.frontend import tracking as trk

    fields, p, cam = _tiny_map()
    m = ms.from_numpy(fields)
    out = trk.global_ba(m, p.R.shape[0], *cam, n_iters=20)
    # the solve leaves its input as it was: the window reuses it
    assert torch.equal(m.lm_X, torch.as_tensor(fields["lm_X"]))
    ref = ref_ba.bundle_adjust(p, cam, 20)
    kf = torch.ones(p.R.shape[0], dtype=torch.bool)
    moved = torch.zeros(p.X.shape[0], dtype=torch.bool)
    moved[p.l] = True
    g = ref_ba.gaps(p, cam, (out.kf_R, out.kf_t, out.lm_X), ref, moved, kf)
    assert g["cost_gap"] < 1e-6 and g["pose_gap"] < 1e-5
    assert g["point_gap"] < 1e-3 and g["rot_gap"] < 1e-5
    # the initial map is far from the solve
    g0 = ref_ba.gaps(p, cam, (p.R, p.t, p.X), ref, moved, kf)
    assert g0["cost_gap"] > 1e-2 and g0["pose_gap"] > 1e-3


def test_pose_refinement_matches_the_programs_pose_lm():
    from orb_slam3_ros2_tpu_torch.backend import pose_opt

    g = torch.Generator().manual_seed(3)
    cam = (458.654, 457.296, 367.215, 248.375)
    X = torch.rand((300, 3), generator=g) * torch.tensor([8.0, 6.0, 6.0]) \
        - torch.tensor([4.0, 3.0, -2.0])
    uv = torch.stack([cam[0] * X[:, 0] / X[:, 2] + cam[2],
                      cam[1] * X[:, 1] / X[:, 2] + cam[3]], -1)
    uv = uv + torch.randn(uv.shape, generator=g)
    lv = torch.randint(0, 8, (300,), generator=g, dtype=torch.int32)
    R0 = torch.eye(3)
    t0 = torch.tensor([0.05, -0.03, 0.04])
    inv_s2 = 1.2 ** (-2.0 * lv.float())
    mask = torch.ones(300, dtype=torch.bool)
    mask[::50] = False
    res = pose_opt.optimize_pose(R0, t0, X, uv, inv_s2, mask, *cam)
    Rr, tr, inl = ref_pose.optimize(R0, t0, X, uv, inv_s2, mask, cam)
    assert torch.equal(inl, res.inliers)
    depth = float((X.double() @ Rr.T + tr)[:, 2].median())
    assert ref_pose.gap(res.R, res.t, Rr, tr, depth) < 1e-5
    assert ref_pose.gap(R0, t0, Rr, tr, depth) > 1e-3
    Rc, tc, _ = ref_pose.optimize(R0, t0, X, uv, inv_s2, mask, cam,
                                  dtype=torch.bfloat16)
    assert ref_pose.gap(Rc, tc, Rr, tr, depth) > 1e-4


def test_preintegration_matches_the_programs():
    from orb_slam3_ros2_tpu_torch.imu import preintegration as pre_mod

    orbit = scene.Orbit.from_params(harness.load_json(
        harness.ROOT / "slambench/traffic/orbit.json")["orbit"])
    t = np.arange(1, 401) / 200.0
    gy, ac = scene.make_imu(scene.BodyTrajectory(orbit, np.eye(4)), t)
    g, a, d = ref_pre.interval_samples(t, gy, ac, 0.3, 0.6, 160)
    assert len(d) == 60 and abs(d.sum() - 0.3) < 1e-9
    bg, ba = np.array([0.01, 0.0, -0.01]), np.zeros(3)
    ref = ref_pre.preintegrate(g, a, d, bg, ba)
    f = lambda v: torch.as_tensor(np.asarray(v, np.float32))
    pre = pre_mod.preintegrate(f(g), f(a), f(d), torch.ones(len(d), dtype=bool),
                               f(bg), f(ba))
    assert ref_pre.gap((pre.dR, pre.dv, pre.dp), ref) < 1e-5
    ctl = ref_pre.preintegrate(g, a, d, bg, ba, dtype=torch.bfloat16)
    assert ref_pre.gap(ctl, ref) > 1e-3


@pytest.mark.parametrize("L", [50, 400])
def test_pairs_cover_every_pair_of_a_landmark(L):
    g = torch.Generator().manual_seed(L)
    l = torch.randint(0, L, (3 * L,), generator=g)
    a, b = ref_ba._pairs(l, L)
    counts = torch.bincount(l, minlength=L)
    assert a.shape[0] == int((counts ** 2).sum())
    assert bool((l[a] == l[b]).all())
    assert len(set(zip(a.tolist(), b.tolist()))) == a.shape[0]
