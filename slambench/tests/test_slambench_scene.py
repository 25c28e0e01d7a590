"""The benchmark's world against the program's numpy originals it was
copied from, at a tiny size on the CPU."""

import numpy as np
import pytest
import torch

from slambench import scene

pytest.importorskip("cv2")


def test_torch_renderer_matches_numpy_renderer():
    """`render_rays` samples the same planes along the same rays as the
    numpy `_render_planes_rays` (cv2.remap, whose fixed-point weights are
    1/32 px): the two agree to a fraction of a grey level, but along the
    seams between planes, where cv2 blends a plane's last texel with its
    -1 border and this renderer keeps the plane out to its last texel."""
    from orb_slam3_ros2_tpu_torch.io import synthetic

    dev = torch.device("cpu")
    planes = scene.room_planes(0, dev, tex_hw=(72, 96))
    params = (458.654 / 8, 457.296 / 8, 367.215 / 8, 248.375 / 8,
              -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)
    rays = scene.pinhole_rays(params, 94, 60, dev)
    orbit = scene.Orbit.from_params({
        "lap_s": 12.0, "centre": [0.0, 0.0, -0.5],
        "pos_sin": [[1.0, 0.0, 0.0]], "pos_cos": [[0.0, 0.0, 0.6]],
        "rot_sin": [[0.0, 0.3, 0.0]], "rot_cos": [[0.06, 0.0, 0.04]]})
    R, t = scene.lap_poses(orbit, 3, 1.0)
    ours = scene.render_rays(planes, rays, torch.as_tensor(R).float(),
                             torch.as_tensor(t).float()).numpy()
    np_planes = [synthetic._Plane(origin=p.origin, ax_u=p.ax_u,
                                  ax_v=p.ax_v, tex=p.tex.numpy())
                 for p in planes]
    dirs = rays.double().numpy()
    for k in range(3):
        ref, _ = synthetic._render_planes_rays(np_planes, dirs, R[k], t[k])
        d = np.abs(ours[k] - ref)
        assert np.median(d) < 0.01
        assert np.mean(d > 1.0) < 0.05


def test_orbit_closes_in_pose_and_velocity():
    import json
    from slambench import harness

    tr = json.loads((harness.ROOT / "slambench" / "traffic"
                     / "orbit.json").read_text())
    orbit = scene.Orbit.from_params(tr["orbit"])
    gap = scene.lap_seam_gap(orbit)
    assert gap["position_m"] < 1e-9
    assert gap["velocity_m_s"] < 1e-6
    assert gap["rotation_rad"] < 1e-7
    assert tr["lap_frames"] == round(orbit.lap_s * tr["fps"])
    # the IMU of a lap repeats in the next one
    body = scene.BodyTrajectory(orbit, np.eye(4))
    t = np.arange(1, 41) / 200.0
    g0, a0 = scene.make_imu(body, t)
    g1, a1 = scene.make_imu(body, t + orbit.lap_s)
    np.testing.assert_allclose(g0, g1, atol=1e-6)
    np.testing.assert_allclose(a0, a1, atol=1e-4)


def test_make_imu_matches_the_programs_copy():
    from orb_slam3_ros2_tpu_torch.io import synthetic

    traj = synthetic.default_trajectory(seed=3, scale=1.5)
    t, g_ref, a_ref = synthetic.make_imu(traj, 0.0, 0.5,
                                         gyro_bias=np.array([0.01, 0, 0]))
    g, a = scene.make_imu(traj, t, gyro_bias=np.array([0.01, 0, 0]))
    np.testing.assert_allclose(g, g_ref, atol=1e-12)
    np.testing.assert_allclose(a, a_ref, atol=1e-9)


def test_photometric_pool_is_uint8_and_seeded():
    frames = torch.full((2, 12, 16), 100.0)
    vig = torch.ones((12, 16))
    gains = torch.ones(2)
    out = []
    for _ in range(2):
        g = torch.Generator().manual_seed(7)
        out.append(scene.photometric(frames, vig, gains, 3.0, g))
    assert out[0].dtype == torch.uint8
    assert torch.equal(out[0], out[1])
    assert 95 <= float(out[0].float().mean()) <= 105
