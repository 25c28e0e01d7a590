"""The port's pipelined mode (`System(pipelined=True)`) against the JAX
package's on the CPU.

Copies of `tests/test_pipelined.py` (its 60-frame 320x240 clip at fps 20,
seed 1, and its bars), then the port against the JAX pipelined System on
the same clip: the first frame of the pipelined path, the tracking state
of every frame and the keyframe count; a blank frame mid-clip (LOST
decided one frame late, the frame in flight dropped, both recorded at the
last good pose); the readers' flushes; `_pack_pipe_imu` and
`frame_step_vi` against the JAX System's; and `track_frame`, which makes
no Python number of a tensor. The port's runs draw each initialization
attempt's samples as the JAX System does for its frame (`jax_initialize`
of `tests/test_torch_e2e_mono.py`), and each run is made once, in a
module-scoped fixture. The IMU_MONOCULAR run on `tests/test_e2e_vi.py`'s
clip is marked `slow`, as the JAX e2e VI tests are."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.atlas import map_state as jms
from orb_slam3_ros2_tpu.runtime import system as jsys
from orb_slam3_ros2_tpu_torch.atlas import map_state as tms
from orb_slam3_ros2_tpu_torch.frontend import extractor as tex
from orb_slam3_ros2_tpu_torch.frontend import initializer as tinit
from orb_slam3_ros2_tpu_torch.frontend import tracking as ttrk
from orb_slam3_ros2_tpu_torch.io import synthetic
from orb_slam3_ros2_tpu_torch.models import cameras as tcam
from orb_slam3_ros2_tpu_torch.runtime import staging
from orb_slam3_ros2_tpu_torch.runtime import system as tsys
from orb_slam3_ros2_tpu_torch.runtime.system import (ImuPoint, Sensor,
                                                     System, TrackingState)
from orb_slam3_ros2_tpu_torch.tools.system_run import imu_points
from tests.test_torch_e2e_mono import jax_initialize
from tests.test_torch_tracking import (CX, CY, H, W, _map_np,  # noqa: F401
                                       _seed_map_jax, frames, setup)

DATA = os.path.join(os.path.dirname(__file__), "data")
SETTINGS = os.path.join(DATA, "synth_cam.yaml")
N = 60  # tests/test_pipelined.py's clip
BLANK_AT, N_LOST = 16, 26  # the blank frame, and the frames fed around it
N_FLUSH = 12  # frames before the readers' flushes


@pytest.fixture(scope="module")
def clip():
    return synthetic.render_sequence(
        n_frames=N, width=320, height=240, fx=260.0, fy=260.0, fps=20.0,
        seed=1, traj_scale=1.0)


@pytest.fixture(scope="module")
def draws():
    """The JAX draws for every port run of the module, and two intra-op
    threads (the suite's other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tinit, "initialize", jax_initialize([]))
        yield
    torch.set_num_threads(n)


def _feed(sys_, images, ts):
    """Track every image; returns the first frame after which a frame is
    in flight (the first of the pipelined path), or None."""
    first = None
    for k in range(len(images)):
        sys_.track_monocular(images[k], float(ts[k]))
        if first is None and sys_._pend is not None:
            first = k
    return first


def _ate(sys_, clip, n):
    _, R_gt, t_gt, _ = clip
    traj = sys_.get_frame_trajectory()
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for _, T in traj])
    gt = np.stack([-R_gt[k].T @ t_gt[k] for k in range(n)])
    ok = np.array([st["state"] == int(TrackingState.OK)
                   for st in sys_.tracking_log])
    return float(synthetic.ate_rmse(est[ok], gt[ok])), traj


def _run(clip, pipelined: bool, package=tsys):
    images, _, _, ts = clip
    kw = dict(device="cpu") if package is tsys else {}
    sys_ = package.System(None, SETTINGS, package.Sensor.MONOCULAR,
                          pipelined=pipelined, **kw)
    first = _feed(sys_, images, ts)
    ate, traj = _ate(sys_, clip, len(images))
    return sys_, ate, traj, first


@pytest.fixture(scope="module")
def staged(clip, draws):
    return _run(clip, False)


@pytest.fixture(scope="module")
def piped(clip, draws):
    return _run(clip, True)


@pytest.fixture(scope="module")
def jax_piped(clip):
    return _run(clip, True, jsys)


def _states(sys_):
    return [st["state"] for st in sys_.tracking_log]


# ------------------------------------------- copies of test_pipelined.py

def test_pipelined_record_per_frame(piped):
    sys_, _, traj, _ = piped
    assert len(traj) == N
    assert len(sys_.tracking_log) == N
    assert len(sys_.frame_refs) == N
    t = [x for x, _ in traj]
    assert all(b > a for a, b in zip(t, t[1:]))


def test_pipelined_matches_staged_accuracy(staged, piped):
    ate_staged, ate_piped = staged[1], piped[1]
    assert ate_piped < max(2.0 * ate_staged, 0.08), (
        f"pipelined ATE {ate_piped} vs staged {ate_staged}")


def test_pipelined_keyframes_and_state(piped):
    sys_ = piped[0]
    assert int(sys_.map.n_kf) >= 5
    assert sys_.state == TrackingState.OK


# ----------------------------------------------------- against JAX's mode

def test_pipelined_path_matches_jax(piped, jax_piped):
    """The same first frame of the pipelined path, the same tracking state
    on every frame, and the keyframe count within 1 of JAX's."""
    sys_, _, _, first = piped
    ref, _, _, first_j = jax_piped
    assert first is not None and first == first_j
    assert _states(sys_) == _states(ref)
    assert abs(int(sys_.map.n_kf) - int(ref.map.n_kf)) <= 1
    # the port's tracer reads the JAX pipelined stages
    rep = sys_.tracer.report()
    assert rep["frame_step"]["n"] == N - first
    assert rep["summary_fetch"]["n"] >= N - first - 1
    assert rep["mapping_dispatch"]["n"] >= 1
    assert "insert_kf" not in rep


def _lost_run(clip, package):
    images, _, _, ts = clip
    images = images[:N_LOST].copy()
    images[BLANK_AT] = 0.0
    kw = dict(device="cpu") if package is tsys else {}
    sys_ = package.System(None, SETTINGS, package.Sensor.MONOCULAR,
                          pipelined=True, **kw)
    in_flight = []
    for k in range(N_LOST):
        sys_.track_monocular(images[k], float(ts[k]))
        in_flight.append(sys_._pend is not None)
    return sys_, sys_.get_trajectory(), in_flight


def test_late_lost_matches_jax(clip, draws):
    """A blank frame while the pipelined path runs: LOST is decided when
    it is consumed (the next call), the frame in flight is dropped, and
    both are recorded at the last good pose; one record per frame fed,
    and the same records and states as the JAX System's."""
    sys_, traj, in_flight = _lost_run(clip, tsys)
    ref, traj_j, in_flight_j = _lost_run(clip, jsys)
    assert in_flight[BLANK_AT] and not in_flight[BLANK_AT + 1]
    assert in_flight == in_flight_j
    assert len(traj) == len(sys_.tracking_log) == N_LOST == len(traj_j)
    states = _states(sys_)
    assert states == _states(ref)
    assert states[BLANK_AT] == states[BLANK_AT + 1] == int(TrackingState.LOST)
    assert states[BLANK_AT - 1] == int(TrackingState.OK)
    last_good = traj[BLANK_AT - 1][1]
    np.testing.assert_array_equal(traj[BLANK_AT][1], last_good)
    np.testing.assert_array_equal(traj[BLANK_AT + 1][1], last_good)
    assert [t for t, _ in traj] == [t for t, _ in traj_j]


@pytest.fixture(scope="module")
def flushed(clip, draws):
    images, _, _, ts = clip
    sys_ = System(None, SETTINGS, Sensor.MONOCULAR, pipelined=True,
                  device="cpu")
    _feed(sys_, images[:N_FLUSH], ts[:N_FLUSH])
    return sys_


def test_get_trajectory_flushes(flushed):
    """After n frames one is in flight; get_trajectory() consumes it and
    returns n records."""
    sys_ = flushed
    assert sys_._pend is not None and len(sys_.trajectory) == N_FLUSH - 1
    traj = sys_.get_trajectory()
    assert len(traj) == N_FLUSH and sys_._pend is None
    assert sys_._chain is None and sys_._pend_kf is None


def test_save_atlas_drains_in_flight(flushed, clip, tmp_path):
    """Two more frames put one in flight again; save_atlas drains it (and
    any dispatched keyframe) before it writes."""
    images, _, _, ts = clip
    sys_ = flushed
    n0 = len(sys_.get_trajectory())
    _feed(sys_, images[n0:n0 + 2], ts[n0:n0 + 2])
    assert sys_._pend is not None
    path = sys_.save_atlas(str(tmp_path / "atlas"))
    assert os.path.isfile(path)
    assert sys_._pend is None and sys_._pend_kf is None
    assert len(sys_.trajectory) == n0 + 2


def test_rig_sensors_keep_the_synchronous_path():
    """track_stereo never takes the pipelined path, whatever the flag."""
    frames_ = synthetic.render_sequence(
        n_frames=3, width=320, height=240, fx=260.0, fy=260.0, fps=10.0,
        seed=2, plane_depths=(5.0, 8.0), traj_scale=1.4,
        stereo_baseline=0.12)
    sys_ = System(None, os.path.join(DATA, "synth_stereo.yaml"),
                  Sensor.STEREO, pipelined=True, device="cpu")
    for k in range(3):
        sys_.track_stereo(frames_[0][k], frames_[1][k], float(frames_[-1][k]))
        assert sys_._pend is None and sys_._chain is None
    assert sys_.state == TrackingState.OK
    assert len(sys_.trajectory) == 3


# --------------------------------------------------- the IMU batch packing

def _pack_case(name):
    """(chain time, t_img, sample times) of each case; P = 4."""
    return {
        "before_chain": (1.0, 1.1, [0.90, 0.95, 1.0]),
        "inside": (1.0, 1.1, [1.02, 1.05, 1.08, 1.1]),
        "past_t_img": (1.0, 1.1, [1.05, 1.1 + 5e-10, 1.12, 1.2]),
        "past_cap": (1.0, 1.1, [1.01, 1.02, 1.03, 1.04, 1.05, 1.06, 1.07]),
        "mixed": (1.0, 1.1, [0.97, 1.0, 1.01, 1.03, 1.04, 1.06, 1.07, 1.09,
                             1.1, 1.15]),
        "no_chain": (None, 1.1, [1.0, 1.1, 1.2]),
    }[name]


@pytest.mark.parametrize("case", ["before_chain", "inside", "past_t_img",
                                  "past_cap", "mixed", "no_chain"])
def test_pack_pipe_imu_matches_jax(case):
    """The same arrays and the same kept samples as the JAX
    `_pack_pipe_imu`; the samples in the window past the P-th are counted
    in `dropped_imu_samples`."""
    chain_time, t_img, times = _pack_case(case)
    rng = np.random.default_rng(len(times))
    samples = [(rng.normal(size=3), rng.normal(size=3), t) for t in times]
    port = System(None, SETTINGS, Sensor.IMU_MONOCULAR, pipelined=True,
                  device="cpu")
    ref = jsys.System(None, SETTINGS, jsys.Sensor.IMU_MONOCULAR,
                      pipelined=True)
    for s, point in ((port, ImuPoint), (ref, jsys.ImuPoint)):
        s._pre_cap = 4
        s._chain_time = chain_time
        s._pipe_imu = [point(a, g, t) for a, g, t in samples]
    got = port._pack_pipe_imu(t_img)
    want = ref._pack_pipe_imu(t_img)
    for g_arr, w_arr in zip(got, want):
        assert g_arr.dtype == np.asarray(w_arr).dtype
        np.testing.assert_array_equal(g_arr, np.asarray(w_arr))
    assert [p.t for p in port._pipe_imu] == [p.t for p in ref._pipe_imu]
    t0 = chain_time if chain_time is not None else t_img
    in_window = sum(t0 < t <= t_img + 1e-9 for t in times)
    assert port.dropped_imu_samples == max(in_window - 4, 0)


# ------------------------------------------------------------ frame_step_vi

# body from camera: a rotation of 0.2 rad about (1, 2, 3) and a 5 cm offset
_RBC = tsys.System._so3_exp_np(0.2 * np.array([1.0, 2.0, 3.0])
                               / np.sqrt(14.0))
T_BC = np.eye(4)
T_BC[:3, :3] = _RBC
T_BC[:3, 3] = (0.05, -0.02, 0.01)
P_VI = 16  # the batch; the last 6 samples masked out
DT_FRAME = 0.05


def _vi_settings(path):
    data = ", ".join(f"{v:.12f}" for v in T_BC.reshape(-1))
    path.write_text(
        "%YAML:1.0\nCamera.type: \"PinHole\"\n"
        f"Camera1.fx: 260.0\nCamera1.fy: 260.0\nCamera1.cx: {CX}\n"
        f"Camera1.cy: {CY}\nCamera1.k1: 0.0\nCamera1.k2: 0.0\n"
        "Camera1.p1: 0.0\nCamera1.p2: 0.0\n"
        f"Camera.width: {W}\nCamera.height: {H}\nCamera.fps: 20\n"
        "ORBextractor.nFeatures: 500\nORBextractor.scaleFactor: 1.2\n"
        "ORBextractor.nLevels: 4\nORBextractor.iniThFAST: 20\n"
        "ORBextractor.minThFAST: 7\n"
        "IMU.T_b_c1: !!opencv-matrix\n  rows: 4\n  cols: 4\n  dt: f\n"
        f"  data: [{data}]\nIMU.NoiseGyro: 0.00017\nIMU.NoiseAcc: 0.002\n"
        "IMU.Frequency: 200.0\n")
    return str(path)


def _vi_inputs(R0, t0, R1, t1):
    """An IMU batch that carries the body from frame 0's pose to frame
    1's at constant velocity and rate (10 samples over DT_FRAME), the
    biases, and 6 masked samples of noise after them."""
    R_bc, t_bc = T_BC[:3, :3], T_BC[:3, 3]

    def body(R, t):  # T_cw -> (R_wb, p_wb)
        R_bw = R_bc @ R
        t_bw = R_bc @ t + t_bc
        return R_bw.T, -R_bw.T @ t_bw

    Rw0, p0 = body(R0.astype(np.float64), t0.astype(np.float64))
    Rw1, p1 = body(R1.astype(np.float64), t1.astype(np.float64))
    v0 = (p1 - p0) / DT_FRAME
    rel = Rw0.T @ Rw1
    ang = np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1))
    axis = np.array([rel[2, 1] - rel[1, 2], rel[0, 2] - rel[2, 0],
                     rel[1, 0] - rel[0, 1]]) / (2 * np.sin(ang) + 1e-12)
    bg = np.array([0.003, -0.002, 0.001])
    ba = np.array([0.02, -0.01, 0.03])
    rng = np.random.default_rng(7)
    gyro = rng.normal(size=(P_VI, 3))
    acc = rng.normal(size=(P_VI, 3))
    dts = rng.uniform(0.001, 0.01, P_VI)
    mask = np.zeros(P_VI, bool)
    mask[:10] = True
    gyro[:10] = axis * ang / DT_FRAME + bg
    acc[:10] = Rw0.T @ np.array([0.0, 0.0, 9.81]) + ba
    dts[:10] = DT_FRAME / 10
    return dict(v=v0.astype(np.float32), gyro=gyro.astype(np.float32),
                acc=acc.astype(np.float32), dts=dts.astype(np.float32),
                mask=mask, bg=bg.astype(np.float32), ba=ba.astype(np.float32))


def _frame_step_vi_pair(jsys_, m_j, frames_arr, R0, t0, inp):
    """frame 1 through the JAX System's `_frame_step_vi` and the port's
    `frame_step_vi` on the same map, pose, velocity and IMU batch."""
    imgs = frames_arr[0]
    outs_j = jsys_._frame_step_vi(
        m_j, jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(inp["v"]),
        jnp.asarray(imgs[1]), jnp.asarray(inp["gyro"]),
        jnp.asarray(inp["acc"]), jnp.asarray(inp["dts"]),
        jnp.asarray(inp["mask"]), jnp.asarray(inp["bg"]),
        jnp.asarray(inp["ba"]), jnp.asarray(DT_FRAME, jnp.float32))
    cam = tcam.make_camera("PinHole", 260.0, 260.0, CX, CY, (0.0,) * 4, W, H)
    ex_cfg = tex.ExtractorConfig(n_features=500, n_levels=4, height=H,
                                 width=W)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa
    outs_t = tsys.frame_step_vi(
        tms.from_numpy(_map_np(m_j)), f32(R0), f32(t0), f32(inp["v"]),
        f32(imgs[1]), f32(inp["gyro"]), f32(inp["acc"]), f32(inp["dts"]),
        torch.from_numpy(inp["mask"]), f32(inp["bg"]), f32(inp["ba"]),
        torch.tensor(DT_FRAME, dtype=torch.float32), f32(T_BC[:3, :3]),
        f32(T_BC[:3, 3]), cam, ex_cfg)
    return outs_j, outs_t


@pytest.fixture(scope="module")
def vi_system(tmp_path_factory):
    path = _vi_settings(tmp_path_factory.mktemp("vi") / "cam.yaml")
    return jsys.System(None, path, jsys.Sensor.IMU_MONOCULAR,
                       map_cfg=jms.MapConfig(max_kf=8, max_lm=1024,
                                             n_feat=500))


def test_frame_step_vi_matches_jax_system(vi_system, frames):  # noqa: F811
    """On the depth-seeded map of test_frame_step_matches_jax_system, with
    a masked-tail IMU batch: R within 1e-3, t within 5e-3 m, inliers
    within 5%, v_new within 5e-3 m / dt_frame, the (19,) summary's tail
    equal to v_new, and both within 0.05 m of ground truth."""
    imgs, depths, R_gt, t_gt = frames
    m = _seed_map_jax(vi_system._extract, imgs[0], depths[0], R_gt[0],
                      t_gt[0], vi_system.map_cfg, 260.0, 260.0, CX, CY)
    inp = _vi_inputs(R_gt[0], t_gt[0], R_gt[1], t_gt[1])
    oj, ot = _frame_step_vi_pair(vi_system, m, frames, R_gt[0], t_gt[0], inp)
    _, _, _, Rj, tj, vj, sj = (np.asarray(x) if i >= 3 else x
                               for i, x in enumerate(oj))
    m2, f_u, _, Rt, tt, vt, st = ot
    st = st.numpy()
    assert st.shape == (19,) and sj.shape == (19,)
    assert st[13] >= 15
    assert abs(st[13] - sj[13]) <= 0.05 * sj[13]
    np.testing.assert_allclose(Rt.numpy(), Rj, atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), tj, atol=5e-3)
    np.testing.assert_allclose(vt.numpy(), vj, atol=5e-3 / DT_FRAME)
    np.testing.assert_array_equal(st[16:], vt.numpy())
    assert np.abs(tt.numpy() - t_gt[1]).max() < 0.05
    assert f_u.uv.shape == (500, 2)
    assert int(m2.lm_visible.sum()) > 0


def test_frame_step_vi_prediction_matches_jax(vi_system,
                                              frames):  # noqa: F811
    """The IMU prediction alone: on a map with no landmarks the pose LM
    has nothing to move, so the returned pose is the prediction; the port
    and JAX agree within 1e-5 on it and on v_new."""
    imgs, _, R_gt, t_gt = frames
    m = jms.empty_map(vi_system.map_cfg)
    inp = _vi_inputs(R_gt[0], t_gt[0], R_gt[1], t_gt[1])
    oj, ot = _frame_step_vi_pair(vi_system, m, frames, R_gt[0], t_gt[0], inp)
    Rj, tj, vj = (np.asarray(x) for x in oj[3:6])
    Rt, tt, vt = (x.numpy() for x in ot[3:6])
    assert int(ot[6][12]) == 0  # no match: the LM kept the prediction
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    np.testing.assert_allclose(tt, tj, atol=1e-5)
    np.testing.assert_allclose(vt, vj, atol=1e-5)
    # the masked samples are no-ops: the prediction is frame 1's pose
    np.testing.assert_allclose(tt, t_gt[1], atol=1e-3)


# ------------------------------------------------------ no host number

@pytest.mark.parametrize("perturb", [0.0, 0.35])
def test_track_frame_makes_no_python_number(setup, perturb):  # noqa: F811
    """track_frame turns no tensor into a Python number (int, bool,
    float, item): on the card each would wait for the device. 0.35 m takes
    the widened retry."""
    _, _, tm, tf = setup
    t0 = torch.tensor([perturb, 0.0, 0.0])
    R0 = torch.eye(3)

    def refuse(*args, **kwargs):
        raise AssertionError("track_frame made a Python number of a tensor")

    names = ("__int__", "__bool__", "__float__", "__index__", "item")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    try:
        for n in names:
            setattr(torch.Tensor, n, refuse)
        _, _, _, s = ttrk.track_frame(
            tm, tf["uv"], tf["bits"], tf["mask"], tf["level"], R0, t0,
            260.0, 260.0, CX, CY, W, H, min_matches=15)
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)
    assert s.shape == (16,) and s[13] >= 15


def test_staging_on_the_cpu_reads_the_tensors():
    """On the CPU the staging uploads a copy and reads the summary
    itself, with no event."""
    st = staging.PipeStaging(torch.device("cpu"), 8)
    vals = np.arange(5, dtype=np.float32)
    up = st.upload(vals)
    vals[0] = 7.0
    assert up.tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]
    s = torch.arange(19, dtype=torch.float32)
    f = st.fetch(s)
    assert f.event is None and f.host is s
    out = st.read(f)
    s[0] = 5.0
    np.testing.assert_array_equal(out, np.arange(19, dtype=np.float32))


# --------------------------------------------------------- mono-inertial

@pytest.mark.slow
def test_pipelined_e2e_vi_metric_scale(draws):
    """tests/test_e2e_vi.py's clip and bars with IMU_MONOCULAR pipelined:
    after 80 frames the IMU is initialized, the gyro bias within 2e-2, and
    after the VI init more than 20 frames on the export surface, the
    Umeyama scale within 10% and the unaligned length within 35%; frames
    after the VI init take the pipelined path."""
    from tests.test_torch_e2e_vi import _centres, _mono_clip

    images, R_gt, t_gt, ts, imu, true_bg = _mono_clip()
    sys_ = System(None, SETTINGS, Sensor.IMU_MONOCULAR, pipelined=True,
                  device="cpu")
    sys_.VI_INIT_KFS = 6
    t_prev, n_piped = -1.0, 0
    for k in range(len(images)):
        sys_.track_monocular(images[k], float(ts[k]),
                             imu_points(imu, t_prev, float(ts[k])))
        t_prev = float(ts[k])
        n_piped += sys_._pend is not None
    assert n_piped > 20
    assert len(sys_.get_trajectory()) == len(images)
    assert sys_.get_tracking_state() == TrackingState.OK
    assert sys_.is_imu_initialized() and sys_.get_inertial_ba1()
    np.testing.assert_allclose(sys_.bg, true_bg, atol=2e-2)
    t_init = sys_.kf_times[min(len(sys_.kf_times) - 1, sys_.VI_INIT_KFS)]
    est, gt = _centres(sys_, R_gt, t_gt, t_from=t_init)
    assert len(est) > 20
    s_uma = synthetic.umeyama_scale(est, gt)
    assert abs(s_uma - 1.0) < 0.10, s_uma
    len_est = np.linalg.norm(np.diff(est, axis=0), axis=1).sum()
    len_gt = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert abs(len_est - len_gt) / len_gt < 0.35, (len_est, len_gt)
