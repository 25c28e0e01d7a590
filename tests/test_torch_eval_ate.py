"""The port's evaluation entry point (`tools/eval_ate.py`) against
`scripts/eval_ate.py`, on the CPU.

- The synthetic suite (full and `--quick`) equals the JAX script's, loaded
  with `importlib` (its JAX imports are inside functions).
- The table writer gives the JAX script's table, line for line, on the
  same rows (the JAX `main` run over stand-in rows).
- `eval_real_sequence` runs on a 12-frame EuRoC-layout directory written
  here from `render_sequence` at 5 frames/s (the settings cut to the
  320x240 camera of `tests/data/synth_cam.yaml`), and `discover_real`
  finds it.
- The JAX rows of EVAL.md, and the bar of a row, worked by hand.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu_torch.io import recording, synthetic
from orb_slam3_ros2_tpu_torch.tools import eval_ate
from tests.test_torch_e2e_stereo import two_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_eval_ate", ROOT / "scripts" / "eval_ate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("quick", [False, True])
def test_synthetic_suite_equals_the_jax_script(jax_script, quick):
    assert eval_ate.synthetic_suite(quick) == jax_script.synthetic_suite(quick)


def test_config_for_equals_the_jax_script(jax_script):
    for name in ("MH_01_easy", "tumvi_room1"):
        for mode in ("mono", "vi", "stereo", "stereo_vi"):
            assert (eval_ate._config_for(name, mode)
                    == jax_script._config_for(name, mode))
            assert Path(eval_ate._config_for(name, mode)).is_file()


ROWS = [
    {"sequence": "synth_easy", "mode": "mono", "ate_rmse_m": 0.0174,
     "kf_ate_rmse_m": 0.0038, "tracked_frames": 108, "frames": 120,
     "wall_s": 57.1, "fps": 2.1, "fps_steady": 11.7, "frame_ms_p95": 150.9,
     "frame_ms_max": 400.0, "frames_over_33ms": 60, "status": "ok"},
    {"sequence": "synth_hard_vi_s0", "mode": "vi", "ate_rmse_m": 0.0343,
     "kf_ate_rmse_m": 0.0129, "tracked_frames": 116, "frames": 120,
     "fps": 2.1, "fps_steady": 14.3, "frame_ms_p95": 1183.5,
     "scale_err_pct": 8.8, "scale_err_end_pct": 0.5, "status": "ok",
     "imu_initialized": True},
    {"sequence": "synth_kb8_stereo", "mode": "fisheye_stereo(KB8 640x480)",
     "ate_rmse_m": 0.0121, "kf_ate_rmse_m": None, "tracked_frames": 40,
     "frames": 40, "fps": 0.5, "scale_err_pct": 3.8, "status": "ok"},
    {"sequence": "synth_loopy", "mode": "mono+loop", "ate_rmse_m": 0.373,
     "kf_ate_rmse_m": None, "tracked_frames": 208, "frames": 280,
     "fps": 3.7, "loops_closed": 1, "ate_loop_off_m": 0.5953,
     "status": "ok"},
    {"sequence": "synth_hard", "mode": "mono", "ate_rmse_m": None,
     "tracked_frames": 3, "frames": 120, "status": "tracking failed"},
]


def test_table_equals_the_jax_script(jax_script, monkeypatch, tmp_path,
                                     capsys):
    """The JAX `main` over stand-in rows prints the table the port's
    `results_table` gives for them, line for line; the port's `main` over
    the same rows writes it, the JSON and the bars."""
    import jax

    cache = jax.config.jax_compilation_cache_dir
    cases = [dict(name=r["sequence"], mode=r["mode"]) for r in ROWS]
    rows = {r["sequence"]: r for r in ROWS}
    monkeypatch.setattr(jax_script, "synthetic_suite", lambda quick: cases)
    monkeypatch.setattr(jax_script, "eval_synthetic",
                        lambda case: dict(rows[case["name"]]))
    monkeypatch.setattr("sys.argv", [
        "eval_ate.py", "--data", str(tmp_path / "none"), "--out",
        str(tmp_path / "j.json"), "--out-md", str(tmp_path / "J.md")])
    try:
        assert jax_script.main() == 0
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
    jax_table = capsys.readouterr().out.strip()
    assert jax_table == eval_ate.results_table(ROWS)
    assert jax_table.splitlines()[0] == eval_ate.TABLE_HEADER

    monkeypatch.setattr(eval_ate, "synthetic_suite", lambda quick: cases)
    monkeypatch.setattr(eval_ate, "eval_synthetic",
                        lambda case: dict(rows[case["name"]]))
    blob = eval_ate.main(["--data", str(tmp_path / "none"), "--device",
                          "cpu", "--out", str(tmp_path / "t.json"),
                          "--out-md", str(tmp_path / "T.md")])
    assert capsys.readouterr().out.strip() == jax_table
    assert json.loads((tmp_path / "t.json").read_text()) == blob
    md = (tmp_path / "T.md").read_text()
    assert jax_table in md and "# EVAL_TORCH" in md
    assert blob["card"] == {"name": None, "power.limit": None}
    # EVAL.md's own rows meet their bar; a failed row misses it
    assert [b["met"] for b in blob["bars"]] == [True] * 4 + [False]
    defaults = eval_ate.build_parser().parse_args([])
    assert (defaults.out, defaults.out_md) == (
        str(ROOT / "eval_results_torch.json"), str(ROOT / "EVAL_TORCH.md"))


def test_eval_md_rows_are_the_jax_table():
    rows = eval_ate.eval_md_rows()
    assert len(rows) == 10
    assert rows["synth_loopy"] == {"ate_rmse_m": 0.3730, "tracked_frames": 208,
                                   "frames": 280, "loops_closed": 1}
    assert rows["synth_hard_vi_s2"]["ate_rmse_m"] == 0.0326
    assert rows["synth_kb8_stereo"]["tracked_frames"] == 40


def test_row_bar_by_hand():
    ref = {"ate_rmse_m": 0.0174, "tracked_frames": 108, "frames": 120,
           "loops_closed": None}
    row = {"sequence": "synth_easy", "mode": "mono", "ate_rmse_m": 0.0261,
           "tracked_frames": 103, "frames": 120}
    bar = eval_ate.row_bar(row, ref)
    # max(1.5 x 0.0174, 0.0174 + 0.01) = 0.0274; 0.95 x 108 = 102.6
    assert bar["ate_max_m"] == pytest.approx(0.0274)
    assert bar["tracked_min"] == pytest.approx(102.6)
    assert bar["met"]
    assert not eval_ate.row_bar(dict(row, tracked_frames=102), ref)["met"]
    assert not eval_ate.row_bar(dict(row, ate_rmse_m=0.0275), ref)["met"]
    # 1.5 x 0.373 = 0.5595 > 0.383; a 40-frame row: 0.95 x 108 / 120 x 40
    loop = dict(ref, ate_rmse_m=0.373)
    bar = eval_ate.row_bar(dict(row, ate_rmse_m=0.5, loops_closed=0), loop)
    assert bar["ate_max_m"] == pytest.approx(0.5595)
    assert bar["checks"] == {"ate": True, "tracked": True,
                             "loops_closed": False}
    vi = dict(row, mode="vi", frames=40, tracked_frames=35)
    bar = eval_ate.row_bar(dict(vi, imu_initialized=False), ref)
    assert bar["tracked_min"] == pytest.approx(34.2)
    assert bar["checks"] == {"ate": True, "tracked": True,
                             "imu_initialized": False}
    assert eval_ate.row_bar(row, None) is None


def _write_euroc_clip(root: Path, n: int = 12):
    imgs, R_cw, t_cw, ts = synthetic.render_sequence(
        n_frames=n, width=320, height=240, fx=260.0, fy=260.0, fps=5.0,
        seed=1)
    rec = recording.SequenceRecorder(str(root))
    for k in range(n):
        t = 1.0 + float(ts[k])
        rec.add_frame(np.clip(imgs[k], 0, 255).astype(np.uint8), t)
        rec.add_groundtruth(t, -R_cw[k].T @ t_cw[k])
    return rec.close()


def test_eval_real_sequence_on_a_euroc_directory(tmp_path, monkeypatch,
                                                 two_threads):  # noqa: F811
    data = tmp_path / "datasets"
    _write_euroc_clip(data / "MH_synth")
    assert eval_ate.discover_real(str(data)) == [
        ("MH_synth", str(data / "MH_synth"))]
    monkeypatch.setattr(eval_ate, "_config_for",
                        lambda name, mode: str(ROOT / "tests" / "data"
                                               / "synth_cam.yaml"))
    row = eval_ate.eval_real_sequence(str(data / "MH_synth"), "MH_synth",
                                      "mono", device="cpu")
    assert set(row) == {"sequence", "mode", "ate_rmse_m", "tracked_frames",
                        "frames", "wall_s", "fps", "status"}
    assert row["status"] == "ok" and row["frames"] == 12
    assert row["tracked_frames"] >= 10
    # the online pose of each frame: the e2e mono test's bound on the raw
    # trajectory (measured 0.072 m over 11 frames)
    assert row["ate_rmse_m"] < 0.12
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        eval_ate.main(["--data", str(data)])


def test_loop_case_is_the_loopy_clip(monkeypatch):
    """`chip_smoke.py` phase 15 takes its `synth_loopy` row from phase 9's
    runs (`tools/system_run.run_loopy` on `render_loopy()`), so the suite's
    case (`runtime/bench_eval.run_loop_closure_case`) must render the same
    clip and build its System on the same settings, loop closing on and
    off. Both are stopped at their System, with the renderer and the
    trajectory recorded."""
    import dataclasses

    from orb_slam3_ros2_tpu_torch.io.settings import load_settings
    from orb_slam3_ros2_tpu_torch.runtime import bench_eval
    from orb_slam3_ros2_tpu_torch.runtime import system as sysm
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    class Stop(Exception):
        pass

    seen = []

    def fake_render(**kw):
        seen.append(dict(render=kw))
        return None, None, None, None

    def fake_traj(n_frames, fps):
        seen.append(dict(traj=(n_frames, fps)))
        return "traj"

    class FakeSystem:
        def __init__(self, voc, path, sensor, device=None):
            seen[-1].update(settings=load_settings(str(path)), sensor=sensor)
            raise Stop

    monkeypatch.setattr(synthetic, "render_room_sequence", fake_render)
    monkeypatch.setattr(synthetic, "_loop_trajectory", fake_traj)
    monkeypatch.setattr(bench_eval, "_loop_trajectory", fake_traj)
    monkeypatch.setattr(sysm, "System", FakeSystem)
    case = next(c for c in eval_ate.synthetic_suite(False)
                if c["name"] == "synth_loopy")
    with pytest.raises(Stop):
        bench_eval.run_loop_closure_case(dict(case, device="cpu"))
    suite_traj, suite = seen[-2:]
    frames = sr.render_loopy()
    loopy_traj, loopy = seen[-2:]
    assert suite_traj == loopy_traj == dict(traj=(case["n_frames"], 10.0))
    assert suite["render"] == loopy["render"]
    for on in (True, False):
        with pytest.raises(Stop):
            sr.run_loopy("cpu", frames, on)
        # the suite's System takes the template's settings and then its
        # loop-closing switch (`sys_.settings.loop_closing = loop_on`);
        # the sensor is the System's argument (the file's inferred
        # `sensor_type` is overridden by it)
        assert seen[-1]["sensor"] == suite["sensor"] == sysm.Sensor.MONOCULAR
        want = dataclasses.replace(suite["settings"], loop_closing=on,
                                   sensor_type=None, raw=None)
        assert dataclasses.replace(seen[-1]["settings"], sensor_type=None,
                                   raw=None) == want


def test_main_takes_given_rows(monkeypatch, tmp_path):
    """A row given to `main` stands in for its case, which then does not
    run; the other cases run. An empty `--data` directory runs the
    synthetic suite (how `chip_smoke.py` phase 15 calls it)."""
    cases = [dict(name=r["sequence"], mode=r["mode"]) for r in ROWS]
    rows = {r["sequence"]: r for r in ROWS}
    ran = []

    def run(case):
        ran.append(case["name"])
        return dict(rows[case["name"]])

    monkeypatch.setattr(eval_ate, "synthetic_suite", lambda quick: cases)
    monkeypatch.setattr(eval_ate, "eval_synthetic", run)
    (tmp_path / "data").mkdir()
    given = dict(rows[ROWS[-1]["sequence"]], ate_rmse_m=0.5)
    blob = eval_ate.main(["--data", str(tmp_path / "data"), "--device",
                          "cpu", "--out", str(tmp_path / "t.json"),
                          "--out-md", str(tmp_path / "T.md")],
                         given={ROWS[-1]["sequence"]: given})
    assert blob["source"] == "synthetic"
    assert ran == [r["sequence"] for r in ROWS[:-1]]
    assert blob["results"] == ROWS[:-1] + [given]
