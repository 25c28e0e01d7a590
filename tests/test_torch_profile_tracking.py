"""The port's speed-of-light audit (`tools/profile_tracking.py`) against
`scripts/profile_tracking.py`, on the CPU at a small size.

- The stage programs, the derived rows and the JSON keys are the JAX
  script's (read from its source), the peaks are the card's.
- The pyramid stage's bytes and operations are worked by hand: each
  level is two matrix products (rows, then columns) of the previous
  level with its resize weights, each product reading its two operands
  and writing its result once, 2mnk operations.
- A kernel's count is `tools/roofline.py`'s on that call's inputs (the
  match: the window pairs counted by hand), and the torch ops of its
  plain version on the CPU are not counted again.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused
from orb_slam3_ros2_tpu_torch.ops import fused_match
from orb_slam3_ros2_tpu_torch.ops import pyramid as pyr_ops
from orb_slam3_ros2_tpu_torch.tools import profile_tracking as pt
from orb_slam3_ros2_tpu_torch.tools import roofline
from tests.test_torch_e2e_stereo import two_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_threads")

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "profile_tracking.py"


def _script():
    return ast.parse(SCRIPT.read_text())


def _list_names(var: str) -> list:
    """The first string of each tuple in the list assigned to `var`."""
    node = next(n for n in ast.walk(_script()) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == var)
    return [elt.elts[0].value for elt in node.value.elts]


def _function(name: str) -> ast.FunctionDef:
    return next(n for n in _script().body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _keywords(call: ast.Call) -> set:
    return {k.arg for k in call.keywords}


def _row_keys():
    """The JAX stage row's keys: the `row = dict(...)` of `main`, and the
    keys each branch adds with `row.update(...)` (the noise-floor branch
    is the one with a `note`)."""
    base = added = None
    updates = []
    for n in ast.walk(_function("main")):
        if (isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None)
                == "row"):
            base = _keywords(n.value)
        if (isinstance(n, ast.Call) and getattr(n.func, "attr", None)
                == "update" and getattr(n.func.value, "id", None) == "row"):
            updates.append(_keywords(n))
    noisy = next(k for k in updates if "note" in k)
    added = next(k for k in updates if "note" not in k)
    return base, noisy, added


def _out_keys():
    """The keys of the JSON `main` writes with `--out`, and of its
    `config`."""
    call = next(n for n in ast.walk(_function("main"))
                if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dump")
    out = call.args[0]
    config = next(k.value for k in out.keywords if k.arg == "config")
    return _keywords(out), _keywords(config)


def _ba_row_keys():
    ret = next(n for n in ast.walk(_function("_ba_roofline"))
               if isinstance(n, ast.Return))
    return _keywords(ret.value)


@pytest.fixture(scope="module")
def small_profile():
    return pt.profile(torch.device("cpu"), height=120, width=160,
                      n_features=150, n_landmarks=256, batches=(1, 2),
                      reps=1, ba_size=(8, 1024))


def test_stages_rows_and_keys_equal_the_jax_script(small_profile):
    out = small_profile
    assert list(pt.STAGES) == _list_names("stages")
    rows = out["stages"]
    assert [r["stage"] for r in rows[:-1]] == _list_names("derived")
    base, noisy, measured = _row_keys()
    for r in rows[:-1]:
        assert set(r) in (base | noisy, base | measured), r
    # both branches of a row, from made-up times
    assert set(pt.stage_row("x", 1e-6, 1e6, 1e6)) == base | noisy
    assert set(pt.stage_row("x", 1e-3, 1e6, 1e6)) == base | measured
    assert set(rows[-1]) == _ba_row_keys()
    out_keys, config_keys = _out_keys()
    assert out_keys <= set(out) and set(out["config"]) == config_keys
    assert out["peaks"] == {"hbm_GBs": 3350.0, "f32_TFLOPs": 67.0}
    assert out["card"] == {"name": None, "power.limit": None}
    assert set(out["counts"]) == set(pt.STAGES)
    # the kernels of each stage: none, the frontend, + the match, + the
    # pose LM, one launch each a frame
    assert [out["counts"][s]["kernel_launches"] for s in pt.STAGES] == [
        0, 1, 2, 3]


def test_pyramid_stage_counts_by_hand():
    H, W = 120, 160
    img = torch.rand(H, W)
    got = pt.count_work(lambda: pyr_ops.build_pyramid(img, 8, 1.2))
    shapes = pyr_ops.level_shapes(H, W, 8, 1.2)
    n_bytes = n_ops = 0
    for (h1, w1), (h2, w2) in zip(shapes, shapes[1:]):
        # rows: (h2, h1) @ (h1, w1) -> (h2, w1); columns: (h2, w1) @ (w1, w2)
        n_bytes += 4 * (h2 * h1 + h1 * w1 + h2 * w1)
        n_ops += 2 * h2 * h1 * w1
        n_bytes += 4 * (h2 * w1 + w1 * w2 + h2 * w2)
        n_ops += 2 * h2 * w1 * w2
    assert got["torch_bytes"] == n_bytes and got["torch_ops"] == n_ops
    assert got["torch_calls"] == 14 + 7  # 14 products + 7 transposes
    assert got["kernel_launches"] == got["kernel_bytes"] == 0


def test_kernel_counts_are_the_roofline_counts():
    """The match of 3 features against 4 landmarks at 10 px: the pairs
    inside the window counted by hand (2), the plain version's torch ops
    hidden; the pose LM on 5 points."""
    bits = torch.zeros(3, 8, dtype=torch.int32)
    uva = torch.tensor([[10.0, 10.0], [50.0, 50.0], [90.0, 10.0]])
    uvb = torch.tensor([[12.0, 15.0], [55.0, 41.0], [10.0, 80.0],
                        [85.0, 12.0]])
    ma = torch.tensor([True, True, False])
    mb = torch.ones(4, dtype=torch.bool)
    # in-window pairs (|du| <= 10 and |dv| <= 10, both masks): (0, 0) and
    # (1, 1); (2, 3) is in the window but feature 2 is masked
    bits_b = torch.zeros(4, 8, dtype=torch.int32)
    got = pt.count_work(lambda: fused_match.match_window(
        bits, ma, uva, bits_b, mb, uvb, radius=10.0, max_dist=50.0,
        ratio=0.9, mutual=True))
    assert got["kernel_launches"] == 1 and got["torch_calls"] == 0
    assert got["kernel_bytes"] == 41 * (3 + 4) + 9 * 3
    assert got["kernel_ops"] == 7 * 3 * 4 + 28 * 2
    N = 5
    args = (torch.eye(3), torch.zeros(3), torch.rand(N, 3) + 4.0,
            torch.rand(N, 2) * 100, torch.ones(N),
            torch.ones(N, dtype=torch.bool), 100.0, 100.0, 50.0, 50.0)
    got = pt.count_work(lambda: pose_opt_fused.optimize_pose_fused(*args))
    assert (got["kernel_bytes"], got["kernel_ops"]) == (26 * N + 116,
                                                       18 * 235 * N)
    assert got["torch_calls"] == 0


def test_op_cost_rules():
    a, b = torch.rand(4, 6), torch.rand(6, 5)
    assert pt.op_cost(torch.ops.aten.mm.default, (a, b), {}, a @ b) == (
        4 * (24 + 30 + 20), 2 * 4 * 6 * 5)
    src, idx = torch.rand(1000), torch.tensor([3, 7])
    # a gather reads what it writes (2 floats) and its indices
    assert pt.op_cost(torch.ops.aten.index.Tensor, (src, [idx]), {},
                      src[idx]) == (8 + 16 + 8, 2)
    assert pt.op_cost(torch.ops.aten.view.default, (src, [10, 100]), {},
                      src.view(10, 100)) == (0, 0)
    x = torch.rand(10)
    assert pt.op_cost(torch.ops.aten.add.Tensor, (x, x), {}, x + x) == (
        120, 10)


def test_derived_rows_are_stage_differences():
    t = {"pyramid": 1e-3, "extract": 3e-3, "extract+match": 3.00001e-3,
         "full": 4e-3}
    c = {s: {"bytes": 1e6 * (i + 1), "ops": 1e9 * (i + 1)}
         for i, s in enumerate(pt.STAGES)}
    rows = pt.derived_rows(t, c)
    assert [r["ms_per_frame"] for r in rows] == pytest.approx(
        [1.0, 2.0, 0.00001, 1.0 - 0.00001, 4.0], abs=1e-9)
    assert [r["est_MB"] for r in rows] == pytest.approx([1, 1, 1, 1, 4])
    assert rows[2]["note"] == "below measurement noise floor"
    assert rows[1]["pct_speed_of_light"] == pytest.approx(
        roofline.bound(1e6, 1e9)["bound_ms"] / 2.0 * 100)
    assert np.isfinite(rows[4]["achieved_TFLOPs"])
