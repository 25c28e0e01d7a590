"""End-to-end monocular SLAM through the port's `System.track_monocular`
from a blank map, on the rendered 40-frame clip of `tests/test_e2e_mono.py`
and held to that test's bounds: state OK at the end, >= 4 keyframes, > 100
valid landmarks, > 20 tracked frames, Sim3-aligned ATE < 0.05 m on the
export surface (`get_frame_trajectory`) and < 0.12 m on the raw online
trajectory. The settings are `tests/data/synth_cam.yaml` with loop closing
off (this slice does not port it).

Both Systems key initialization attempt n by the frame index n, but their
generators cannot draw the same numbers, and on this clip the ATE depends
on the draw in both packages (the frame the initializer first accepts, and
the hypotheses it keeps). The run here draws each attempt's RANSAC samples
as the JAX System does for the same frame, `PRNGKey(n)`: the port is held
to the reference's bounds on the reference's own draws."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.frontend import initializer as jinit
from orb_slam3_ros2_tpu_torch.frontend import initializer as tinit
from orb_slam3_ros2_tpu_torch.io import synthetic
from orb_slam3_ros2_tpu_torch.runtime.system import (Sensor, System,
                                                     TrackingState)

SETTINGS = os.path.join(os.path.dirname(__file__), "data", "synth_cam.yaml")


def mono_settings(tmp_path) -> str:
    path = tmp_path / "synth_cam_no_loop.yaml"
    with open(SETTINGS) as f:
        path.write_text(f.read() + "\nloopClosing: 0\n")
    return str(path)


@pytest.fixture(scope="module")
def rendered():
    return synthetic.render_sequence(
        n_frames=40, width=320, height=240, fx=260.0, fy=260.0,
        fps=10.0, seed=1, plane_depths=(6.0, 9.0), traj_scale=1.6)


@pytest.fixture
def two_threads():
    """Two intra-op threads: the run takes ~20 s alone, and its time stays
    near that when the suite's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _centers(sys_, traj, R_gt, t_gt):
    est, gt = [], []
    for k, (_, T) in enumerate(traj):
        if sys_.tracking_log[k]["state"] != int(TrackingState.OK):
            continue
        est.append(-T[:3, :3].T @ T[:3, 3])
        gt.append(-R_gt[k].T @ t_gt[k])
    return np.array(est), np.array(gt)


@pytest.fixture
def jax_draws(monkeypatch):
    """Feed each initialization attempt the JAX System's samples for its
    frame; records the (seed, device) of the System's generators."""
    seen = []

    def initialize(gen, uv1, uv2, mask, *args, **kwargs):
        seen.append((gen.initial_seed(), gen.device))
        kh, kf = jax.random.split(jax.random.PRNGKey(gen.initial_seed()))
        m = jnp.asarray(mask.numpy())
        idx_h = np.array(jinit._sample_indices(kh, m, jinit.N_HYPO, 4))
        idx_f = np.array(jinit._sample_indices(kf, m, jinit.N_HYPO, 8))
        return tinit.initialize_from_samples(
            uv1, uv2, mask, torch.from_numpy(idx_h), torch.from_numpy(idx_f),
            *args, **kwargs)

    monkeypatch.setattr(tinit, "initialize", initialize)
    return seen


def test_port_e2e_mono_tracks_and_ate(rendered, tmp_path, two_threads,
                                      jax_draws):
    images, R_gt, t_gt, ts = rendered
    sys_ = System(None, mono_settings(tmp_path), Sensor.MONOCULAR,
                  device="cpu")
    attempts = []
    for k in range(images.shape[0]):
        n = len(jax_draws)
        T = sys_.track_monocular(images[k], float(ts[k]))
        assert T.shape == (4, 4) and np.isfinite(T).all()
        attempts += [k] * (len(jax_draws) - n)
    # every attempt is keyed by its frame index, on the System's device
    assert attempts and [s for s, _ in jax_draws] == attempts
    assert all(d == torch.device("cpu") for _, d in jax_draws)

    assert sys_.get_tracking_state() == TrackingState.OK
    n_kf = int(sys_.map.n_kf)
    assert n_kf >= 4, f"only {n_kf} keyframes"
    n_lm = int(sys_.map.lm_valid.sum())
    assert n_lm > 100, f"only {n_lm} landmarks"
    assert len(sys_.get_map_pcl()) == n_lm

    est, gt = _centers(sys_, sys_.get_frame_trajectory(), R_gt, t_gt)
    assert len(est) > 20, "too few tracked frames"
    ate = synthetic.ate_rmse(est, gt)
    assert ate < 0.05, f"ATE {ate:.4f} m"
    est_raw, gt_raw = _centers(sys_, sys_.get_trajectory(), R_gt, t_gt)
    ate_raw = synthetic.ate_rmse(est_raw, gt_raw)
    assert ate_raw < 0.12, f"raw online ATE {ate_raw:.4f} m"
    assert len(sys_.kf_times) == n_kf
    assert all(isinstance(t, float) for t in sys_.kf_times)


@pytest.mark.parametrize("kwargs,item", [
    (dict(sensor=Sensor.IMU_STEREO), "7"), (dict(sensor=Sensor.IMU_RGBD), "7"),
    (dict(sensor=Sensor.IMU_MONOCULAR), "7"), (dict(pipelined=True), "10"),
    (dict(vocab_path="vocab.txt"), "8"), (dict(load_atlas="atlas"), "8")])
def test_left_out_parts_raise(tmp_path, kwargs, item):
    settings = mono_settings(tmp_path)
    vocab = kwargs.pop("vocab_path", None)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        System(vocab, settings, device="cpu", **kwargs)


def test_loop_closing_settings_and_lost_branch_raise(tmp_path, rendered):
    with pytest.raises(NotImplementedError, match="item 8"):
        System(None, SETTINGS, device="cpu")  # loopClosing defaults to 1
    sys_ = System(None, mono_settings(tmp_path), device="cpu")
    sys_.state = TrackingState.LOST
    with pytest.raises(NotImplementedError, match="item 8"):
        sys_.track_monocular(rendered[0][0], 0.0)


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_system_without_a_card_raises(tmp_path, monkeypatch, device):
    """The System runs on the card unless the caller asks for the CPU:
    without one, the default device and any CUDA device raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kwargs = {} if device is None else dict(device=device)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        System(None, mono_settings(tmp_path), **kwargs)
    assert System(None, mono_settings(tmp_path),
                  device="cpu").device.type == "cpu"


def test_system_run_without_a_card_exits(monkeypatch, capsys):
    from orb_slam3_ros2_tpu_torch.tools import system_run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        system_run.main([])
    assert exit_info.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
