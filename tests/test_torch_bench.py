"""The port's benchmark (`tools/bench.py`) against `bench.py` and the JAX
package, on the CPU at small sizes.

- The tracking map, the frames and the BA problem are built from the
  same seeds and draws as `bench.py` builds them, restated here from the
  JAX package's own functions (`bench.py` is not imported: its `main`
  runs everything), and must be bit-equal.
- One chained step of extract -> match_to_map -> track_pose at 240x320,
  300 features and 512 landmarks against the same JAX functions under
  `lax.scan`: on the bench's own map (noise frames and random landmarks:
  no match in either package, the pose stays where it started), and on a
  rendered clip tracked against its first frame's features, where the
  two packages extract their own features (their descriptors differ at a
  few BRIEF near-ties), so the chained poses agree within 5e-3 m and
  1e-3 and the inlier counts within 5% (measured: 2.2e-3 m, 3.8e-4, 7 of
  223).
- 3 iterations of the BA slope's problem at K = 8, L = 1024 against the
  JAX `bundle_adjust`.
- `_bench_system_fps_steady` at 12 frames of 320x240, and the JSON line
  of `main`, with `bench.py`'s keys (read from its source).
"""

import ast
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu.atlas import map_state as jms
from orb_slam3_ros2_tpu.backend import ba as jba
from orb_slam3_ros2_tpu.frontend import extractor as jex
from orb_slam3_ros2_tpu.frontend import tracking as jtrk
from orb_slam3_ros2_tpu.io import synthetic as jsynthetic
from orb_slam3_ros2_tpu.ops import orb_descriptor as jdesc
from orb_slam3_ros2_tpu_torch.atlas import map_state as tms
from orb_slam3_ros2_tpu_torch.backend import ba as tba
from orb_slam3_ros2_tpu_torch.frontend import extractor as tex
from orb_slam3_ros2_tpu_torch.tools import bench
from tests.test_torch_e2e_stereo import two_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_threads")

BENCH_PY = Path(__file__).resolve().parents[1] / "bench.py"


def _jax_bench_map(rng, cfg, L):
    """`bench.py:60-75`, restated."""
    m = jms.empty_map(jms.MapConfig(max_kf=64, max_lm=8192,
                                    n_feat=jex.total_capacity(cfg)))
    X = np.stack(
        [rng.uniform(-4, 4, L), rng.uniform(-3, 3, L), rng.uniform(4, 10, L)],
        axis=-1,
    ).astype(np.float32)
    return m._replace(
        lm_X=m.lm_X.at[:L].set(jnp.asarray(X)),
        lm_valid=m.lm_valid.at[:L].set(True),
        lm_bits=m.lm_bits.at[:L].set(
            jnp.asarray(rng.integers(0, 2**32, (L, 8), dtype=np.uint32))),
    )


def _as_np(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def test_tracking_map_and_frames_equal_bench_py():
    """The published 752x480 / 1000-feature map of 8192 slots and the two
    B = 32 batches drawn after it (warm-up, timed), bit for bit."""
    jcfg = jex.ExtractorConfig(n_features=1000, n_levels=8, height=480,
                               width=752)
    rng = np.random.default_rng(0)
    ref = _jax_bench_map(rng, jcfg, 4096)
    ref_frames = [np.asarray(jnp.asarray(
        rng.uniform(0, 255, (32, 480, 752)).astype(np.float32)))
        for _ in range(2)]
    cfg = tex.ExtractorConfig(n_features=1000, n_levels=8, height=480,
                              width=752)
    rng = np.random.default_rng(0)
    got = bench.tracking_map(rng, cfg, "cpu")
    frames = [bench.noise_frames(rng, 32, 480, 752, "cpu") for _ in range(2)]
    assert got._fields == ref._fields
    for name in ref._fields:
        a, b = _as_np(getattr(ref, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for a, b in zip(ref_frames, frames):
        assert np.array_equal(a, b.numpy())


def test_ba_problem_equals_bench_py():
    """`bench.py:158-179`'s 64-keyframe x 8192-landmark problem, bit for
    bit."""
    K, L = 64, 8192
    rng = np.random.default_rng(0)
    sc = jsynthetic.make_scene(n_frames=K, n_points=512, noise_px=0.5,
                               seed=1, fx=458.0, fy=458.0, cx=367.0, cy=248.0)
    reps = L // 512
    X = np.tile(sc.X, (reps, 1)) + rng.normal(0, 0.05, (L, 3))
    uv = np.tile(sc.uv, (1, reps, 1))
    w = np.tile(sc.vis, (1, reps)).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    ref = jba.BAProblem(
        R=jnp.asarray(sc.R_cw, jnp.float32),
        t=jnp.asarray(sc.t_cw + rng.normal(0, 0.02, (K, 3)), jnp.float32),
        X=jnp.asarray(X, jnp.float32), uv=jnp.asarray(uv, jnp.float32),
        w=jnp.asarray(w), fixed=jnp.asarray(fixed),
        point_valid=jnp.ones(L, bool),
    )
    got = bench.ba_problem("cpu", K, L)
    assert got._fields == ref._fields
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name


H, W = 240, 320


@functools.lru_cache(maxsize=None)
def _jax_track_batch(cfg, cam):
    """`bench.py`'s `track_batch` scan (`:80-92`), compiled once."""
    fx, fy, cx, cy = cam[:4]
    extract = jex.make_extractor(cfg)

    @jax.jit
    def track_batch(frames, m, lm_signs, R0, t0):
        def step(carry, img):
            R, t = carry
            feats = extract(img)
            tm = jtrk.match_to_map(m, feats.uv, feats.signs, feats.mask,
                                   R, t, fx, fy, cx, cy, W, H,
                                   lm_signs=lm_signs)
            res, _ = jtrk.track_pose(m, tm.obs_lm, feats.uv, feats.level,
                                     R, t, fx, fy, cx, cy)
            return (res.R, res.t), (res.R, res.t, res.n_inliers)
        return jax.lax.scan(step, (R0, t0), frames)[1]

    return track_batch


def _jax_chain(cfg, m, frames, R0, t0, cam):
    """The scan over `frames`; each step's R, t and n_inliers."""
    R, t, n = _jax_track_batch(cfg, cam)(
        jnp.asarray(frames), m, jdesc.signs_from_bits(m.lm_bits),
        jnp.asarray(R0), jnp.asarray(t0))
    return np.asarray(R), np.asarray(t), np.asarray(n)


def _port_chain(m, frames, R0, t0, cam):
    cfg = tex.ExtractorConfig(n_features=300, n_levels=8, height=H, width=W)
    extract = tex.make_extractor(cfg)
    R, t = torch.from_numpy(R0), torch.from_numpy(t0)
    out = []
    for img in torch.from_numpy(frames):
        R, t, n = bench.track_step(extract, m, img, R, t, cam)
        out.append((R.numpy(), t.numpy(), int(n)))
    return out


def _clip_map(jcfg, cam):
    """A map of the first rendered frame's JAX features at their true
    depths (bits from those features), and the next two frames."""
    fx, fy, cx, cy = cam[:4]
    imgs, depth, R_gt, t_gt, _ = jsynthetic.render_sequence(
        n_frames=3, width=W, height=H, fx=fx, fy=fy, fps=10.0, seed=1,
        return_depth=True)
    f0 = jex.make_extractor(jcfg)(jnp.asarray(imgs[0]))
    uv, valid = np.asarray(f0.uv), np.asarray(f0.mask)
    z = depth[0][np.clip(uv[:, 1].astype(int), 0, H - 1),
                 np.clip(uv[:, 0].astype(int), 0, W - 1)]
    Xc = np.stack([(uv[:, 0] - cx) / fx * z, (uv[:, 1] - cy) / fy * z, z],
                  -1)
    Xw = ((R_gt[0].T @ (Xc - t_gt[0]).T).T).astype(np.float32)
    idx = np.flatnonzero(valid)[:512]
    L = idx.size
    m = jms.empty_map(jms.MapConfig(max_kf=64, max_lm=8192,
                                    n_feat=jex.total_capacity(jcfg)))
    m = m._replace(lm_X=m.lm_X.at[:L].set(jnp.asarray(Xw[idx])),
                   lm_valid=m.lm_valid.at[:L].set(True),
                   lm_bits=m.lm_bits.at[:L].set(
                       jnp.asarray(np.asarray(f0.bits)[idx])))
    return m, np.stack(imgs[1:]).astype(np.float32), R_gt[0], t_gt[0]


CAM = (260.0, 260.0, W / 2.0, H / 2.0, W, H)


@pytest.mark.parametrize("case", ["bench_map", "rendered_clip"])
def test_tracking_step_chain_matches_jax_scan(case):
    jcfg = jex.ExtractorConfig(n_features=300, n_levels=8, height=H, width=W)
    if case == "bench_map":
        rng = np.random.default_rng(0)
        m = _jax_bench_map(rng, jcfg, 512)
        frames = rng.uniform(0, 255, (2, H, W)).astype(np.float32)
        R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    else:
        m, frames, R0, t0 = _clip_map(jcfg, CAM)
    tm = tms.from_numpy({k: _as_np(v) for k, v in m._asdict().items()})
    if case == "bench_map":  # the port's own construction gives this map
        tcfg = tex.ExtractorConfig(n_features=300, n_levels=8, height=H,
                                   width=W)
        own = bench.tracking_map(np.random.default_rng(0), tcfg, "cpu", 512)
        for name in tms.MapState._fields:
            assert torch.equal(getattr(own, name), getattr(tm, name)), name
    Rj, tj, nj = _jax_chain(jcfg, m, frames, R0, t0, CAM)
    got = _port_chain(tm, frames, R0, t0, CAM)
    for k, (R, t, n) in enumerate(got):
        if case == "bench_map":
            assert n == nj[k] == 0
            assert np.array_equal(R, Rj[k]) and np.array_equal(t, tj[k])
            assert np.array_equal(R, R0) and np.array_equal(t, t0)
        else:
            assert nj[k] > 150
            assert abs(n - int(nj[k])) <= 0.05 * nj[k], (k, n, nj[k])
            assert np.abs(R - Rj[k]).max() < 1e-3
            assert np.abs(t - tj[k]).max() < 5e-3


def _reprojections(R, t, X):
    fx, fy, cx, cy = bench.BA_CAMERA
    Xc = (np.einsum("kij,lj->kli", R.astype(np.float64), X.astype(np.float64))
          + t.astype(np.float64)[:, None, :])
    return np.stack([fx * Xc[..., 0] / Xc[..., 2] + cx,
                     fy * Xc[..., 1] / Xc[..., 2] + cy], -1)


def test_ba_iterations_match_jax():
    """3 LM iterations of the slope's problem at K = 8, L = 1024: the same
    poses (within 1e-4; measured 2e-6), inlier weights and cost (1e-4
    relative; measured 2e-7). The 8 keyframes span a short baseline, so a
    point's depth is weakly held: summed in another order, the points
    move along their rays (up to 6.5 mm, 1e-3 of their distance), so they
    are compared by their reprojection into every keyframe that observes
    them, within 1e-2 px (measured 9.5e-4)."""
    p = bench.ba_problem("cpu", 8, 1024)
    got = tba.bundle_adjust(p, *bench.BA_CAMERA, n_iters=3)
    jp = jba.BAProblem(*(jnp.asarray(getattr(p, k).numpy())
                         for k in p._fields))
    ref = jba.bundle_adjust(jp, *bench.BA_CAMERA, n_iters=3)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)
    np.testing.assert_array_equal(got.inlier_w.numpy(),
                                  np.asarray(ref.inlier_w))
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-4)
    seen = p.w.numpy() > 0
    d_uv = np.abs(_reprojections(got.R.numpy(), got.t.numpy(),
                                 got.X.numpy())
                  - _reprojections(np.asarray(ref.R), np.asarray(ref.t),
                                   np.asarray(ref.X)))[seen]
    assert d_uv.max() < 1e-2, d_uv.max()
    assert float(got.cost) < float(tba.bundle_adjust(
        p, *bench.BA_CAMERA, n_iters=0).cost)


def _bench_py_function(func_name: str) -> ast.FunctionDef:
    tree = ast.parse(BENCH_PY.read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == func_name)


def _bench_py_extra_keys(func_name: str) -> set:
    """The keys of the dict literal assigned to `extra` in `bench.py`'s
    function `func_name`."""
    node = next(n for n in ast.walk(_bench_py_function(func_name))
                if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                and getattr(n.targets[0], "id", None) == "extra")
    return {k.value for k in node.value.keys}


def _bench_py_line_keys():
    """The keys of the JSON line `bench.py`'s `main` prints, and of its
    `extra`."""
    call = next(n for n in ast.walk(_bench_py_function("main"))
                if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dumps")
    line = call.args[0]
    extra = line.values[[k.value for k in line.keys].index("extra")]
    return {k.value for k in line.keys}, {k.value for k in extra.keys}


def _bench_py_template(func_name: str) -> str:
    node = next(n for n in ast.walk(_bench_py_function(func_name))
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "tmpl")
    return node.value.value


def test_settings_equal_bench_py_templates():
    assert bench.settings_text() == _bench_py_template(
        "_bench_system_fps_steady")
    assert bench.settings_text(imu=True) == _bench_py_template(
        "_bench_system_fps_steady_vi")


def test_system_fps_steady_small_has_the_jax_keys():
    fps, extra = bench._bench_system_fps_steady(
        "cpu", n=12, width=320, height=240, fx=260.0, n_features=600)
    assert set(extra) == _bench_py_extra_keys("_bench_system_fps_steady")
    assert np.isfinite(fps) and fps > 0
    assert extra["frames_measured"] == 6
    assert extra["keyframes"] >= 2
    assert extra["summary_fetch_ms_median"] is not None


def test_main_prints_the_bench_py_line(monkeypatch, capsys):
    """`main` on stand-in parts: one JSON line with `bench.py`'s keys, and
    in `extra` `bench.py`'s keys plus the card's name and power limit and
    the per-repeat times; `--only` leaves the other numbers null; without
    a card the default device stops the run."""
    vi_keys = _bench_py_extra_keys("_bench_system_fps_steady_vi")
    monkeypatch.setattr(bench, "_bench_tracking", lambda dev: (
        40.0, {"repeat_s": {"32": [1.0], "256": [6.6]}, "frames": 1152}))
    monkeypatch.setattr(bench, "_bench_ba_iters", lambda dev: (
        90.0, {"repeat_s": {"10": [0.2], "30": [0.4]}}))
    monkeypatch.setattr(bench, "_bench_system_fps_steady",
                        lambda dev: (30.0, {"keyframes": 9}))
    monkeypatch.setattr(bench, "_bench_system_fps_steady_vi",
                        lambda dev: (20.0, dict.fromkeys(vi_keys)))
    blob = bench.main(["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1 and json.loads(line[0]) == blob
    top, jax_extra = _bench_py_line_keys()
    assert set(blob) == top
    assert set(blob["extra"]) == jax_extra | {
        "name", "power.limit", "tracking_repeat_s", "ba_repeat_s"}
    assert blob["value"] == 40.0 and blob["vs_baseline"] == 40.0 / 30.0
    assert blob["extra"]["tracking_repeat_s"] == {"32": [1.0],
                                                  "256": [6.6]}
    assert blob["extra"]["name"] is None  # a CPU run names no card
    only = bench.main(["--device", "cpu", "--only", "ba"])
    assert only["value"] is None and only["extra"]["system_fps_steady"] is None
    assert only["extra"]["ba_iters_per_s_per_chip"] == 90.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        bench.main([])
