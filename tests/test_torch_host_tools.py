"""The port's host-side tools against their scripts, on the CPU.

- `tools/localize_map.py` against `scripts/localize_map.py` on two PCDs
  the test writes (a room cloud and a moved, partial copy; one as a PCD
  path, one as a session directory): the same JSON keys and point counts,
  `T_dst_src` and the statistics within tests/test_torch_icp_align.py's
  1e-3 (measured 1.6e-4 on `T_dst_src`: the trimmed ICP thresholds each
  match at a distance quantile, and a point at the threshold falls on
  either side when the f32 sums run in another order), and the known
  motion recovered within tests/test_icp_align.py's bars.
- `tools/make_configs.py` into a temporary directory: the same files as
  the JAX `known_configs.write_all`, byte for byte.
- `tools/visualize.py`: the PNG is written where the script writes it, and
  the command exits with code 1 when the session has no artifacts.
- `tools/calibrate_camera.py` against `scripts/calibrate_camera.py` on
  rendered aprilgrid views written as PNGs: the same PinHole keys, each
  within 1e-6 relative (`cv2.calibrateCamera` is not bit-reproducible
  from call to call; tests/test_torch_calibrate.py holds the solve to
  1e-7); KannalaBrandt8 raises the same error in both (OpenCV 5,
  ROADMAP.md §3).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from orb_slam3_ros2_tpu.io import known_configs as jknown
from orb_slam3_ros2_tpu_torch.runtime import outputs
from orb_slam3_ros2_tpu_torch.tools import (calibrate_camera, localize_map,
                                            make_configs, visualize)
from tests.test_icp_align import _room_cloud
from tests.test_torch_ba_benches import (  # noqa: F401
    _script, _script_run, two_blas_threads)
from tests.test_torch_e2e_stereo import two_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_threads", "two_blas_threads")

ROOT = Path(__file__).resolve().parents[1]




def test_localize_map_matches_script(tmp_path):
    rng = np.random.default_rng(3)
    dst = _room_cloud(rng)
    R_gt = Rotation.from_euler("zyx", [12.0, -6.0, 4.0],
                               degrees=True).as_matrix()
    t_gt = np.array([0.4, -0.3, 0.2])
    src = ((dst - t_gt) @ R_gt)[rng.random(len(dst)) < 0.7]
    src = src + rng.normal(0, 0.005, src.shape)
    src_pcd = tmp_path / "src.pcd"
    outputs.save_pcd(str(src_pcd), src)
    session = tmp_path / "run1"
    outputs.save_pcd(str(session / "cloud" / "run1.pcd"), dst)
    argv = ["--src", str(src_pcd), "--dst", str(session)]
    with _script_run(["localize_map.py", *argv]) as buf:
        assert _script("localize_map").main() == 0
    ref = json.loads(buf.getvalue())
    got = localize_map.main([*argv, "--device", "cpu"])
    assert list(got) == list(ref)
    assert (got["src_points"], got["dst_points"]) == (
        ref["src_points"], ref["dst_points"])
    np.testing.assert_allclose(got["T_dst_src"], ref["T_dst_src"], atol=1e-3)
    for k in ref:
        if k not in ("T_dst_src", "src_points", "dst_points"):
            assert abs(got[k] - ref[k]) <= 1e-3, k
    T = np.asarray(got["T_dst_src"])
    assert Rotation.from_matrix(T[:3, :3] @ R_gt.T).magnitude() < 0.01
    assert np.linalg.norm(T[:3, 3] - t_gt) < 0.02
    assert got["rms"] < 0.02 and got["inlier_frac"] > 0.9


def test_make_configs_equal_known_configs(tmp_path, capsys):
    paths = make_configs.main([str(tmp_path / "port")])
    ref = jknown.write_all(str(tmp_path / "jax"))
    assert capsys.readouterr().out.split() == paths
    rel = sorted(os.path.relpath(p, tmp_path / "port") for p in paths)
    assert rel == sorted(os.path.relpath(p, tmp_path / "jax") for p in ref)
    assert len(rel) > 10
    for r in rel:
        assert ((tmp_path / "port" / r).read_bytes()
                == (tmp_path / "jax" / r).read_bytes()), r


def test_visualize_writes_png(tmp_path):
    pytest.importorskip("matplotlib")
    root = tmp_path / "output"
    rng = np.random.default_rng(0)
    outputs.save_pcd(str(root / "run" / "cloud" / "run.pcd"),
                     rng.normal(0, 1, (200, 3)))
    traj = np.cumsum(rng.normal(0, 0.1, (20, 3)), 0)
    with open(root / "run" / "run_traj.txt", "w") as f:
        for i, p in enumerate(traj):
            f.write(f"{i * 0.1:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    "0 0 0 1\n")
    argv = ["--name", "run", "--output-root", str(root)]
    png = visualize.main(argv)
    assert png == str(root / "run" / "run_map.png")
    assert os.path.getsize(png) > 10_000
    pts, tr = visualize.load_artifacts(str(root / "run"), "run")
    assert pts.shape == (200, 3) and tr.shape == (20, 3)
    with _script_run(["visualize.py", *argv, "--out",
                      str(tmp_path / "ref.png")]):
        assert _script("visualize").main() == 0
    assert os.path.getsize(tmp_path / "ref.png") > 10_000
    assert visualize.main(["--name", "none", "--output-root",
                           str(root)]) is None
    run = subprocess.run(
        [sys.executable, "-m", "orb_slam3_ros2_tpu_torch.tools.visualize",
         "--name", "none", "--output-root", str(root)], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 1 and "no artifacts" in run.stderr


def _grid_captures(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from orb_slam3_ros2_tpu_torch.io import calibrate as cal
    from tests.test_torch_calibrate import _views

    spec = cal.AprilGridSpec(cols=4, rows=3, tag_size=0.08, tag_spacing=0.3)
    cap = tmp_path / "captures"
    cap.mkdir()
    for i, v in enumerate(_views(spec)):
        cv2.imwrite(str(cap / f"{i:02d}.png"), v)
    target = tmp_path / "aprilgrid.yaml"
    target.write_text("target_type: 'aprilgrid'\ntagCols: 4\ntagRows: 3\n"
                      "tagSize: 0.08\ntagSpacing: 0.3\n")
    return str(cap / "*.png"), str(target)


def _keys(text):
    out = {}
    for ln in text.strip().splitlines():
        if ln.startswith("Camera"):
            k, v = ln.split(":", 1)
            out[k] = v.strip()
    return out


def test_calibrate_camera_matches_script(tmp_path):
    images, target = _grid_captures(tmp_path)
    argv = ["--images", images, "--target", target]
    with _script_run(["calibrate_camera.py", *argv]) as buf:
        assert _script("calibrate_camera").main() == 0
    ref_text = buf.getvalue()
    with _script_run(["x"]) as got_buf:
        keys = calibrate_camera.main(argv)
    got_text = got_buf.getvalue()
    assert got_text.splitlines()[0].split(",")[0] == \
        ref_text.splitlines()[0].split(",")[0]  # "# 8 views"
    assert got_text.splitlines()[1:] == keys.splitlines()
    got, ref = _keys(got_text), _keys(ref_text)
    assert list(got) == list(ref) and len(ref) == 10
    assert got.pop("Camera.type") == ref.pop("Camera.type") == '"PinHole"'
    for k in ref:
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-6,
                                              abs=1e-7), k
    with _script_run(["x"]):
        assert calibrate_camera.main(["--images", str(tmp_path / "no*.png"),
                                      "--target", target]) is None


def test_calibrate_kannala_brandt_fails_as_script(tmp_path):
    images, target = _grid_captures(tmp_path)
    argv = ["--images", images, "--target", target, "--model",
            "KannalaBrandt8"]
    errors = []
    for run in (lambda: _script("calibrate_camera").main(),
                lambda: calibrate_camera.main(argv)):
        with _script_run(["calibrate_camera.py", *argv]):
            try:
                run()
                errors.append(None)
            except Exception as e:  # the error is the reference's
                errors.append(type(e))
    assert errors[0] == errors[1]


def test_localize_map_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        localize_map.main(["--src", "a.pcd", "--dst", "b.pcd"])


@pytest.mark.cuda
def test_localize_map_on_gpu(tmp_path):
    """The same clouds aligned on the card: the known motion within
    tests/test_icp_align.py's bars."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    dst = _room_cloud(rng)
    R_gt = Rotation.from_euler("zyx", [12.0, -6.0, 4.0],
                               degrees=True).as_matrix()
    t_gt = np.array([0.4, -0.3, 0.2])
    outputs.save_pcd(str(tmp_path / "src.pcd"), (dst - t_gt) @ R_gt)
    outputs.save_pcd(str(tmp_path / "dst.pcd"), dst)
    got = localize_map.main(["--src", str(tmp_path / "src.pcd"),
                             "--dst", str(tmp_path / "dst.pcd")])
    T = np.asarray(got["T_dst_src"])
    assert Rotation.from_matrix(T[:3, :3] @ R_gt.T).magnitude() < 0.01
    assert np.linalg.norm(T[:3, 3] - t_gt) < 0.02
    assert got["rms"] < 0.02 and got["inlier_frac"] > 0.9
