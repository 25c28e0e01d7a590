"""End-to-end monocular SLAM through the port's `System.track_monocular`
from a blank map, on the rendered 40-frame clip of `tests/test_e2e_mono.py`
and held to that test's bounds: state OK at the end, >= 4 keyframes, > 100
valid landmarks, > 20 tracked frames, Sim3-aligned ATE < 0.05 m on the
export surface (`get_frame_trajectory`) and < 0.12 m on the raw online
trajectory. The settings are `tests/data/synth_cam.yaml` as the JAX test
takes them (loop closing on: `loopClosing` is absent and defaults to 1).

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


def jax_initialize(seen: list):
    """A stand-in for `initializer.initialize` that draws each attempt's
    samples as the JAX System does for its frame, appending the (seed,
    device) of the System's generator to `seen`."""

    def initialize(gen, uv1, uv2, mask, *args, **kwargs):
        seen.append((gen.initial_seed(), gen.device))
        kh, kf = jax.random.split(jax.random.PRNGKey(gen.initial_seed()))
        m = jnp.asarray(mask.numpy())
        idx_h = np.array(jinit._sample_indices(kh, m, jinit.N_HYPO, 4))
        idx_f = np.array(jinit._sample_indices(kf, m, jinit.N_HYPO, 8))
        return tinit.initialize_from_samples(
            uv1, uv2, mask, torch.from_numpy(idx_h), torch.from_numpy(idx_f),
            *args, **kwargs)

    return initialize


@pytest.fixture
def jax_draws(monkeypatch):
    """Feed each initialization attempt the JAX System's samples for its
    frame; records the (seed, device) of the System's generators."""
    seen = []
    monkeypatch.setattr(tinit, "initialize", jax_initialize(seen))
    return seen


def test_port_e2e_mono_tracks_and_ate(rendered, two_threads,
                                      jax_draws):
    images, R_gt, t_gt, ts = rendered
    sys_ = System(None, SETTINGS, Sensor.MONOCULAR, device="cpu")
    assert sys_.settings.loop_closing
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


@pytest.mark.parametrize("sensor", [Sensor.IMU_MONOCULAR, Sensor.IMU_STEREO,
                                    Sensor.IMU_RGBD])
def test_imu_sensors_construct_and_take_samples(sensor):
    """Each inertial sensor constructs on the CPU from the test settings
    and takes three frames with their IMU samples: poses stay finite and
    the samples wait in the keyframe buffer (the rig sensors initialize on
    the first frame and track the next two; the monocular initialization
    starts the first interval, and the buffer, on its keyframe)."""
    from orb_slam3_ros2_tpu_torch.runtime.system import ImuPoint

    stereo = sensor == Sensor.IMU_STEREO
    kw = (dict(stereo_baseline=0.12) if stereo
          else dict(return_depth=True) if sensor == Sensor.IMU_RGBD else {})
    frames = synthetic.render_sequence(
        n_frames=3, width=320, height=240, fx=260.0, fy=260.0, fps=10.0,
        seed=2, plane_depths=(5.0, 8.0), traj_scale=1.4, **kw)
    ts = frames[-1]
    settings = SETTINGS.replace("synth_cam", "synth_stereo") if stereo \
        else SETTINGS
    sys_ = System(None, settings, sensor, device="cpu")
    assert sys_.sensor == sensor and not sys_.is_imu_initialized()
    n = 0
    for k in range(3):
        pts = [ImuPoint([0.0, 0.0, 9.81], [0.0, 0.0, 0.01], ts[k] - j * 0.005)
               for j in (3, 2, 1, 0)]
        n += len(pts)
        if sensor == Sensor.IMU_MONOCULAR:
            T = sys_.track_monocular(frames[0][k], float(ts[k]), pts)
        elif stereo:
            T = sys_.track_stereo(frames[0][k], frames[1][k], float(ts[k]),
                                  pts)
        else:
            T = sys_.track_rgbd(frames[0][k], frames[1][k], float(ts[k]), pts)
        assert T.shape == (4, 4) and np.isfinite(T).all()
    t_start = (sys_.kf_times[-1] if sensor == Sensor.IMU_MONOCULAR
               and sys_.kf_times else -np.inf)
    assert [p.t for p in sys_._kf_imu_buf] == [
        ts[k] - j * 0.005 for k in range(3) for j in (3, 2, 1, 0)
        if ts[k] > t_start] and n == 12
    if sensor != Sensor.IMU_MONOCULAR:
        assert sys_.get_tracking_state() == TrackingState.OK


@pytest.mark.parametrize("case", ["vocab_path", "load_atlas"])
def test_vocab_and_atlas_inputs_accepted(tmp_path, case):
    """A DBoW2 text vocabulary is installed as the System's codebook; an
    atlas path that names no file starts a new Atlas."""
    from orb_slam3_ros2_tpu_torch.loop import dbow2, vocab

    if case == "vocab_path":
        book = np.where(np.random.default_rng(4).random((1024, 256)) < 0.5,
                        -1.0, 1.0).astype(np.float32)
        path = dbow2.save_dbow2_text(str(tmp_path / "ORBvoc.txt"), book)
        sys_ = System(path, SETTINGS, device="cpu")
        np.testing.assert_array_equal(sys_.vocab.anchors.numpy(), book)
    else:
        sys_ = System(None, SETTINGS, device="cpu",
                      load_atlas=str(tmp_path / "atlas"))
        np.testing.assert_array_equal(sys_.vocab.anchors.numpy(),
                                      vocab._anchors_np())
        assert sys_.atlas.n_maps() == 1
    assert sys_.get_tracking_state() == TrackingState.NOT_INITIALIZED


def test_loop_closing_settings_and_lost_branch_accepted(rendered):
    """The settings file as published (loopClosing defaults to 1) runs, and
    a lost frame goes to relocalization: with an empty map nothing is
    found, so the System stays LOST and counts the frame."""
    sys_ = System(None, SETTINGS, device="cpu")
    assert sys_.settings.loop_closing
    sys_.state = TrackingState.LOST
    T = sys_.track_monocular(rendered[0][0], 0.0)
    assert np.isfinite(T).all()
    assert sys_.get_tracking_state() == TrackingState.LOST
    assert sys_.frames_lost == 1


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_system_without_a_card_raises(monkeypatch, device):
    """The System runs on the card unless the caller asks for the CPU:
    without one, the default device and any CUDA device raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kwargs = {} if device is None else dict(device=device)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        System(None, SETTINGS, **kwargs)
    assert System(None, SETTINGS, device="cpu").device.type == "cpu"


def test_system_run_without_a_card_exits(monkeypatch, capsys):
    from orb_slam3_ros2_tpu_torch.tools import system_run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        system_run.main([])
    assert exit_info.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
