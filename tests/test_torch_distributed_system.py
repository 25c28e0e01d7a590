"""The port's distributed operating mode: `parallel/distributed_map.py`
against the JAX module on the 8-device CPU mesh, and
`System(mesh=...)._run_global_ba` through the landmark-sharded solver
against the System without a mesh, on tests/test_distributed_system.py's
maps."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.frontend import tracking as jtrk
from orb_slam3_ros2_tpu.geom import lie as jlie
from orb_slam3_ros2_tpu.io import synthetic
from orb_slam3_ros2_tpu.parallel import distributed_map as jdm
from orb_slam3_ros2_tpu.parallel import mesh as jmesh
from orb_slam3_ros2_tpu_torch.atlas import map_state as tms
from orb_slam3_ros2_tpu_torch.parallel import distributed_map as tdm
from orb_slam3_ros2_tpu_torch.parallel import mesh as tmesh
from orb_slam3_ros2_tpu_torch.runtime import system as tsys
from tests.test_distributed_system import CX, CY, FX, FY, _scene_map
from tests.test_torch_sharded_ba import two_threads  # noqa: F401

SETTINGS = os.path.join(os.path.dirname(__file__), "data", "synth_cam.yaml")
R_ATOL, T_ATOL = 1e-4, 3e-3  # tests/test_multiprocess.py:107-109
X_ATOL = 1e-2  # landmarks (metres, 5 cm of initial noise)


def port_map(m) -> tms.MapState:
    return tms.from_numpy({k: np.asarray(v) for k, v in m._asdict().items()})


def cpu_mesh(n=8):
    return tmesh.make_mesh(n, devices=["cpu"] * n)


def test_distributed_map_ba_matches_jax():
    sc, m = _scene_map()
    K = 8
    ids = jnp.arange(m.kf_R.shape[0], dtype=jnp.int32).clip(0, K - 1)
    fix = jnp.arange(ids.shape[0]) == 0
    ref = jdm.distributed_map_ba(m, ids, fix, jmesh.make_mesh(8), FX, FY,
                                 CX, CY, n_iters=10)
    out = tdm.distributed_map_ba(
        port_map(m), torch.from_numpy(np.array(ids)),
        torch.from_numpy(np.array(fix)), cpu_mesh(), FX, FY, CX, CY,
        n_iters=10)
    np.testing.assert_allclose(out.kf_R.numpy(), np.asarray(ref.kf_R),
                               atol=R_ATOL)
    np.testing.assert_allclose(out.kf_t.numpy(), np.asarray(ref.kf_t),
                               atol=T_ATOL)
    np.testing.assert_allclose(out.lm_X.numpy(), np.asarray(ref.lm_X),
                               atol=X_ATOL)
    # against JAX's single-device local BA, as the JAX test holds its own
    single = jtrk.local_ba(m, ids, fix, FX, FY, CX, CY, n_iters=10)
    e0 = np.linalg.norm(np.asarray(m.kf_t[:K]) - sc.t_cw, axis=-1).mean()
    ed = np.linalg.norm(out.kf_t[:K].numpy() - sc.t_cw, axis=-1).mean()
    es = np.linalg.norm(np.asarray(single.kf_t[:K]) - sc.t_cw,
                        axis=-1).mean()
    assert ed < 0.3 * e0, (ed, e0)
    assert abs(ed - es) < 5e-3, (ed, es)
    assert torch.equal(out.lm_valid, port_map(m).lm_valid)


def _load_scene(s, K=8, NF=600):
    """tests/test_distributed_system.py:101-133's map, in the port."""
    cam = s.cam
    sc = synthetic.make_scene(n_frames=K, n_points=160, noise_px=0.3,
                              seed=3, fps=2.0, fx=cam.fx, fy=cam.fy,
                              cx=cam.cx, cy=cam.cy)
    rng = np.random.default_rng(3)
    xi = rng.normal(0, 0.02, (K, 6)).astype(np.float32)
    xi[0] = 0
    R0, t0 = jlie.se3_retract(jnp.asarray(sc.R_cw), jnp.asarray(sc.t_cw),
                              jnp.asarray(xi))
    X0 = sc.X + rng.normal(0, 0.05, sc.X.shape)
    obs = np.full((K, NF), -1, np.int32)
    obs[:, :160] = np.where(sc.vis > 0, np.arange(160)[None, :], -1)
    fv = np.zeros((K, NF), bool)
    fv[:, :160] = sc.vis > 0
    uvf = np.zeros((K, NF, 2), np.float32)
    uvf[:, :160] = sc.uv
    fields = tms.to_numpy(s.map)
    fields["kf_valid"] = np.arange(16) < K
    fields["kf_R"][:K] = np.asarray(R0)
    fields["kf_t"][:K] = np.asarray(t0)
    fields["kf_uv"][:K] = uvf
    fields["kf_obs_lm"][:K] = obs
    fields["kf_feat_valid"][:K] = fv
    fields["lm_X"] = X0.astype(np.float32)
    fields["lm_valid"] = np.ones(160, bool)
    fields["n_kf"] = np.asarray(K, np.int32)
    fields["n_lm"] = np.asarray(160, np.int32)
    s.map = tms.from_numpy(fields)
    return sc


def test_system_global_ba_dispatches_to_mesh():
    """System(mesh=...) runs `_run_global_ba` through
    `distributed_map_ba` over 8 CPU shards and lands on the map of the
    System without a mesh."""
    K = 8
    cfg = tms.MapConfig(max_kf=16, max_lm=160, n_feat=600)
    sys_d = tsys.System(None, SETTINGS, tsys.Sensor.MONOCULAR, map_cfg=cfg,
                        mesh=cpu_mesh(), device="cpu")
    sys_s = tsys.System(None, SETTINGS, tsys.Sensor.MONOCULAR, map_cfg=cfg,
                        device="cpu")
    sc = _load_scene(sys_d)
    _load_scene(sys_s)
    sys_d._run_global_ba(n_iters=10)
    sys_s._run_global_ba(n_iters=10)
    assert sys_d.n_mesh_solves == 1 and sys_s.n_mesh_solves == 0
    ed = np.linalg.norm(sys_d.map.kf_t[:K].numpy() - sc.t_cw, axis=-1).mean()
    es = np.linalg.norm(sys_s.map.kf_t[:K].numpy() - sc.t_cw, axis=-1).mean()
    assert ed < 8e-3, ed
    assert abs(ed - es) < 5e-3, (ed, es)
    np.testing.assert_allclose(sys_d.map.kf_R[:K].numpy(),
                               sys_s.map.kf_R[:K].numpy(), atol=R_ATOL)
    np.testing.assert_allclose(sys_d.map.kf_t[:K].numpy(),
                               sys_s.map.kf_t[:K].numpy(), atol=T_ATOL)


def test_mesh_needs_a_card_unless_devices_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(1)


def test_mesh_shapes_and_padding():
    m = tmesh.make_mesh(8, axis_names=(tmesh.KF_AXIS, tmesh.LM_AXIS),
                        devices=["cpu"] * 8)
    assert m.shape == {"kf": 2, "lm": 4} and m.size == 8
    assert list(cpu_mesh(4).local_shards()) == [0, 1, 2, 3]
    x = torch.arange(5.0)
    assert tmesh.pad_to_multiple(x, 0, 4, fill=-1).tolist() == [
        0, 1, 2, 3, 4, -1, -1, -1]
    assert tmesh.pad_to_multiple(x, 0, 5) is x


def test_corridor_loop_closes_through_the_mesh():
    """The in-map loop closure of `system_run.run_corridor_loop` (the
    corridor of the JAX loop-closing tests) with the System's global BA
    over 8 CPU shards: the loop closes on the second detection, the global
    BA went through the mesh, and the corrected keyframe centres equal
    the run without a mesh within chip_smoke.py's phase 9b bar (1e-3 m)."""
    from orb_slam3_ros2_tpu_torch.tools import system_run

    ref, _ = system_run.run_corridor_loop("cpu")
    r, _ = system_run.run_corridor_loop("cpu", mesh=cpu_mesh())
    assert r["loops_closed_after"] == [0, 1] and r["last_loop_kf"] == 18
    assert r["mesh_solves"] >= 1 and ref["mesh_solves"] == 0
    assert r["finite"]
    d = max(float(np.abs(np.subtract(r["centres"][k], ref["centres"][k])
                         ).max()) for k in r["centres"])
    assert d <= 1e-3, d
