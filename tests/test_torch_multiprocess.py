"""The port's solvers across processes: two OS processes x four CPU shards
each, in a gloo group that meets through a file store under the test's
tmp_path (no TCP port, so parallel test workers cannot collide), against
the same solve in one process over eight shards. One case per solver
family: the landmark-sharded BA through its entry point
(`python -m orb_slam3_ros2_tpu_torch.parallel.multiproc`, the port of
`tests/test_multiprocess.py`), the edge-sharded pose graph and the sharded
VI BA through workers in this file (`python -m
tests.test_torch_multiprocess`).

Also here, in one process: the session's weld (`weld_peer`,
`merge_gathered`) on two maps against the JAX functions, and the live
session's anchor timestamps, which stay float64 and resolve at epoch
scale where the JAX module's float32 rows do not. This module imports
JAX only inside the tests, so the workers run without it."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = 2
LOCAL_SHARDS = 4
# tests/test_multiprocess.py:107-109: gloo's sum order is not the
# in-process one, and the damped LM iterations amplify the difference
R_ATOL, T_ATOL, COST_RTOL = 1e-4, 3e-3, 2e-2
TIMEOUT_S = 300


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads in this process (the workers take one): the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _spawn(argv_of_rank):
    """Run one process per rank and wait; returns their stdout lines."""
    procs = [subprocess.Popen(argv_of_rank(r), cwd=REPO, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORKERS)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err[-3000:]}"
    return [o for _, o, _ in outs]


def _store(tmp_path) -> str:
    return f"file://{tmp_path / 'store'}"


def _cpu_mesh(n):
    from orb_slam3_ros2_tpu_torch.parallel import mesh as mesh_mod

    return mesh_mod.make_mesh(n, devices=["cpu"] * n)


# ---------------------------------------------------------------- workers

def _load(path):
    d = np.load(path)
    return {k: torch.from_numpy(d[k]) for k in d.files}


def _pose_graph(d, mesh):
    from orb_slam3_ros2_tpu_torch.parallel import sharded_pose_graph as spg

    out = spg.make_sharded_pose_graph(mesh, d["R"].shape[0], n_iters=6)(
        d["R"], d["t"], d["s"], d["ei"], d["ej"], d["Rm"], d["tm"], d["sm"],
        d["valid"], d["fixed"])
    return dict(R=out.R, t=out.t, s=out.s, cost=out.cost)


def _vi_ba(d, mesh):
    from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod
    from orb_slam3_ros2_tpu_torch.imu import preintegration as pre_mod
    from orb_slam3_ros2_tpu_torch.parallel import sharded_vi_ba as svi

    p = ba_mod.BAProblem(*(d[f] for f in ba_mod.BAProblem._fields))
    pres = pre_mod.Preintegrated(*(d["pre_" + f]
                                   for f in pre_mod.Preintegrated._fields))
    z = torch.zeros(3)
    out = svi.make_sharded_vi_ba(mesh, float(d["fx"]), float(d["fy"]),
                                 float(d["cx"]), float(d["cy"]), n_iters=10,
                                 prior_bg=1e1, prior_ba=1e0, opt_gravity=True)(
        p, pres, d["v0"], z, z)
    return dict(R=out.R, t=out.t, v=out.v, bg=out.bg, thg=out.thg,
                cost=out.cost)


SOLVERS = {"pose_graph": _pose_graph, "vi_ba": _vi_ba}


def _worker(solver, rank, store, problem, out):
    """One rank: join the gloo group, solve over LOCAL_SHARDS CPU shards
    of the global mesh, rank 0 writes the replicated result."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=store, world_size=WORKERS,
                            rank=rank)
    try:
        mesh = _cpu_mesh(LOCAL_SHARDS)
        assert mesh.size == WORKERS * LOCAL_SHARDS
        res = SOLVERS[solver](_load(problem), mesh)
        if rank == 0:
            np.savez(out, **{k: v.numpy() for k, v in res.items()})
        print(json.dumps({"rank": rank, "shards": mesh.size}), flush=True)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- tests

def _ba_problem(path):
    from tests.test_multiprocess import _make_problem

    _make_problem(path)


def test_two_process_sharded_ba_matches_one_process(tmp_path):
    from orb_slam3_ros2_tpu_torch.parallel import multiproc  # noqa: F401
    from orb_slam3_ros2_tpu_torch.parallel import sharded_ba

    problem, out = str(tmp_path / "problem.npz"), str(tmp_path / "out.npz")
    _ba_problem(problem)
    outs = _spawn(lambda r: [
        sys.executable, "-m", "orb_slam3_ros2_tpu_torch.parallel.multiproc",
        "--process-id", str(r), "--num-processes", str(WORKERS),
        "--coordinator", _store(tmp_path), "--problem", problem,
        "--out", out, "--iters", "6", "--local-devices", str(LOCAL_SHARDS),
        "--device", "cpu"])
    line = json.loads(outs[0].strip().splitlines()[-1])
    assert line["devices"] == 8 and line["processes"] == 2
    assert line["backend"] == "gloo"

    d = _load(problem)
    from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod

    p = ba_mod.BAProblem(
        R=d["R"].float(), t=d["t"].float(), X=d["X"].float(),
        uv=d["uv"].float(), w=d["w"].float(), fixed=d["fixed"],
        point_valid=d["point_valid"])
    ref = sharded_ba.make_sharded_ba(_cpu_mesh(8), 350.0, 350.0, 320.0,
                                     240.0, n_iters=6)(p)
    got = np.load(out)
    np.testing.assert_allclose(got["R"], ref.R.numpy(), atol=R_ATOL)
    np.testing.assert_allclose(got["t"], ref.t.numpy(), atol=T_ATOL)
    np.testing.assert_allclose(got["cost"], float(ref.cost), rtol=COST_RTOL)


def _run_workers(tmp_path, solver, arrays):
    problem, out = str(tmp_path / "problem.npz"), str(tmp_path / "out.npz")
    np.savez(problem, **arrays)
    _spawn(lambda r: [sys.executable, "-m", "tests.test_torch_multiprocess",
                      solver, str(r), _store(tmp_path), problem, out])
    got = np.load(out)
    ref = SOLVERS[solver](_load(problem), _cpu_mesh(WORKERS * LOCAL_SHARDS))
    return got, ref


def test_two_process_pose_graph_matches_one_process(tmp_path):
    from tests.test_sharded_pose_graph import _loop_problem

    names = ("R", "t", "s", "ei", "ej", "Rm", "tm", "sm", "valid", "fixed")
    arrays = {k: np.array(v) for k, v in zip(names, _loop_problem()[:10])}
    got, ref = _run_workers(tmp_path, "pose_graph", arrays)
    # tests/test_sharded_pose_graph.py:103-108
    np.testing.assert_allclose(got["R"], ref["R"].numpy(), atol=5e-4)
    np.testing.assert_allclose(got["t"], ref["t"].numpy(), atol=5e-3)
    np.testing.assert_allclose(got["s"], ref["s"].numpy(), atol=5e-4)


def test_two_process_vi_ba_matches_one_process(tmp_path):
    from tests.test_sharded_vi_ba import _vi_problem

    sc, p, pres, v_init, _, _ = _vi_problem(K=6, L=128)
    arrays = {f: np.array(getattr(p, f)) for f in p._fields}
    arrays.update({"pre_" + f: np.array(getattr(pres, f))
                   for f in pres._fields})
    arrays.update(v0=np.array(v_init), fx=sc.fx, fy=sc.fy, cx=sc.cx,
                  cy=sc.cy)
    got, ref = _run_workers(tmp_path, "vi_ba", arrays)
    np.testing.assert_allclose(got["R"], ref["R"].numpy(), atol=R_ATOL)
    np.testing.assert_allclose(got["t"], ref["t"].numpy(), atol=T_ATOL)
    np.testing.assert_allclose(got["v"], ref["v"].numpy(), atol=3e-3)
    np.testing.assert_allclose(got["bg"], ref["bg"].numpy(), atol=1e-4)
    np.testing.assert_allclose(got["thg"], ref["thg"].numpy(), atol=1e-3)
    np.testing.assert_allclose(got["cost"], ref["cost"].numpy(),
                               rtol=COST_RTOL)


def test_process_allgather_without_a_group_stacks_one_copy():
    from orb_slam3_ros2_tpu_torch.parallel import mesh as mesh_mod

    tree = dict(a=np.arange(3, dtype=np.float64), b=np.array([True, False]),
                c=np.array([2**32 - 1], np.uint32))
    g = mesh_mod.process_allgather(tree)
    for k, v in tree.items():
        assert g[k].dtype == v.dtype and g[k].shape == (1,) + v.shape
        np.testing.assert_array_equal(g[k][0], v)


# ------------------------------------------------------- session pieces

def _pair_of_maps():
    """Two port maps of tests/test_weld_refine.py's pair (one scene, the
    second in a Sim3-moved world with noisy depth), and the JAX maps."""
    from orb_slam3_ros2_tpu_torch.atlas import map_state as tms
    from tests.test_weld_refine import _build_pair

    built = _build_pair()
    A, O = built[0], built[1]
    to_port = lambda m: tms.from_numpy(  # noqa: E731
        {k: np.asarray(v) for k, v in m._asdict().items()})
    return A, O, to_port(A), to_port(O)


def test_kf_signatures_match_jax():
    from orb_slam3_ros2_tpu.parallel import distributed_session as jds
    from orb_slam3_ros2_tpu_torch.parallel import distributed_session as tds

    A, O, tA, tO = _pair_of_maps()
    for jm, tm in ((A, tA), (O, tO)):
        np.testing.assert_allclose(tds.kf_signatures(tm),
                                   jds.kf_signatures(jm), atol=1e-6)


def test_weld_peer_and_merge_gathered_match_jax():
    """The weld of the old map into the active one: the same decision and
    keyframe count as the JAX weld, and its welded keyframe as close to
    the truth (the two packages draw the Sim3 samples from different
    generators, so the inlier sets may differ by a few points)."""
    from orb_slam3_ros2_tpu.atlas import map_state as jms
    from orb_slam3_ros2_tpu.parallel import distributed_session as jds
    from orb_slam3_ros2_tpu_torch.atlas import map_state as tms
    from orb_slam3_ros2_tpu_torch.parallel import distributed_session as tds
    from tests.test_weld_refine import CX, CY, FX, FY

    A, O, tA, tO = _pair_of_maps()
    cfg = tms.MapConfig(max_kf=8, max_lm=512, n_feat=256)
    jcfg = jms.MapConfig(max_kf=8, max_lm=512, n_feat=256)
    intr = (FX, FY, CX, CY)
    t_merged, t_ok = tds.weld_peer(tA, tO, cfg, seed=7, intrinsics=intr,
                                   min_inliers=20)
    j_merged, j_ok = jds.weld_peer(A, O, jcfg, seed=7, intrinsics=intr,
                                   min_inliers=20)
    assert t_ok and j_ok
    assert int(t_merged.n_kf) == int(j_merged.n_kf) == 2
    # the PnP inliers aliased as duplicates (of 120 shared landmarks) may
    # differ by the points that the two draws' refinements classify apart
    assert abs(int(t_merged.lm_valid.sum())
               - int(np.asarray(j_merged.lm_valid).sum())) <= 3
    # the welded old keyframe's true pose in the active world is the
    # identity: both welds within tests/test_weld_refine.py's bars on the
    # refined Sim3 (|dR| < 0.05, |dt| < 0.1)
    for R, t in ((t_merged.kf_R[1].numpy(), t_merged.kf_t[1].numpy()),
                 (np.asarray(j_merged.kf_R[1]), np.asarray(j_merged.kf_t[1]))):
        assert np.linalg.norm(R - np.eye(3)) < 0.05
        assert np.linalg.norm(t) < 0.1
    unwelded = []
    merged, n = tds.merge_gathered([tA, tO], cfg, seed=7, intrinsics=intr,
                                   unwelded=unwelded)
    assert n == 1 and unwelded == []
    assert int(merged.n_kf) == 2


EPOCH = 1.7e9 + 37.25  # s: a ROS header stamp's scale, off the f32 grid


def test_slot_of_resolves_epoch_scale_anchors():
    """Anchor timestamps 0.1 s apart at epoch scale resolve to their
    keyframes from the float64 side array; stored in a float32 row, as the
    JAX module stores them (its live_session.py:345), they land up to 64 s
    away and resolve to no keyframe."""
    from orb_slam3_ros2_tpu_torch.parallel import live_session as tls

    times = EPOCH + 0.1 * np.arange(12)
    for k in (0, 5, 11):
        assert tls.slot_of(times, float(times[k])) == k
        assert tls.slot_of(times, float(np.float32(times[k]))) == -1
    assert tls.slot_of(times[:0], float(times[0])) == -1


def test_edge_anchor_times_stay_float64_through_a_compaction():
    """A keyframe compaction (`System.kf_remap_listeners`) keeps each
    surviving edge's float64 anchor times beside its row and drops the
    edges whose local anchor was culled."""
    from orb_slam3_ros2_tpu_torch.parallel import live_session as tls

    settings = os.path.join(REPO, "tests", "data", "synth_cam.yaml")
    sess = tls.LiveSession(0, 2, settings, device="cpu")
    assert sess._on_kf_remap in sess.sys.kf_remap_listeners
    assert sess.edge_times.dtype == np.float64
    for row, (a, ta) in enumerate(((2, 0.2), (5, 0.5), (7, 0.7))):
        sess.edges[row, 0] = a
        sess.edges[row, 1] = 1
        sess.edge_times[row] = (EPOCH + ta, EPOCH + 10 + ta)
    sess.n_edges = 3
    remap = np.array([0, 1, -1, 2, 3, -1, 4, 5], np.int32)  # 2 and 5 culled
    for cb in sess.sys.kf_remap_listeners:
        cb(remap, 8)
    assert sess.n_edges == 1
    assert int(sess.edges[0, 0]) == 5  # keyframe 7's new slot
    assert sess.edge_times[0, 0] == EPOCH + 0.7
    assert sess.edge_times[0, 1] == EPOCH + 10.7


if __name__ == "__main__":
    # a worker of the two-process tests: SOLVER RANK STORE PROBLEM OUT
    _worker(sys.argv[1], int(sys.argv[2]), *sys.argv[3:6])
