#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU: every kernel against its
plain version, the per-frame tracking slice, the System in its
monocular, stereo, RGB-D and fisheye-stereo configurations, relocalization
and the Atlas on the stock EuRoC settings, loop closing, and the inertial
sensors on the published EuRoC mono-inertial settings, the sharded
solvers, map-to-map ICP, the multi-process sessions, the pipelined
mode, the benchmark (`tools/bench.py`), the evaluation suite
(`tools/eval_ate.py`) and the remaining entry points (`tools/graft_entry.py`,
the BA and place-recognition benches, vocabulary training, localization).

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. Device: requires CUDA; prints the card's name and power limit, and builds
   the kernels from `orb_slam3_ros2_tpu_torch/csrc/` (one nvcc per source,
   all started together).
2. Kernels: the three tracking-path kernels against their plain PyTorch
   versions on the card, at the shapes the tracking path gives them
   (752x480 over 8 levels; 1000 features x 4096 visible landmarks for
   tracking and x 8192 landmark slots for SearchAndFuse; 1000 pose
   observations); then again at the stereo and RGB-D paths' shapes: the
   8-level pyramids of a 1241x376 (KITTI) and a 512x512 (TUM-VI) frame,
   2000 features x 4096 visible landmarks at 15 px and x 8192 slots at 4 px
   (max_dist 45, no ratio, not mutual), and 2000 and 4096 pose
   observations; and at the benchmark's and the evaluation's shape
   (phases 14-15): the 8-level pyramid of a 640x480 frame with 1250
   features, the match kernel at 1250 features (the extractor's total
   capacity) x 4096 visible landmarks and x 8192 slots, and 1250 pose
   observations. The match kernel must give idx, valid and dist exactly
   as its plain version (also over back-to-back calls on two inputs),
   dispatch only three `torch.empty` and views, and enqueue itself alone; its
   latency floor (the same launch without the sweeps) is printed at each
   shape. The pose kernel must agree with its plain version (R
   within 5e-5, t within 5e-4, identical inliers and count), give the
   same bits twice, dispatch only three `torch.empty` and views, and
   enqueue itself alone; its latency floor (the same launch doing only
   the 18 reductions) is printed. The packed frontend must give score exactly on the whole canvas, keep
   exactly 4 px inside each level, raw exactly on each level, 0 / false
   outside the levels, one kernel and no other device op per call, and
   the extractor's features bit for bit as through the plain version
   (752x480, 1241x376 and 640x480). Relocalization's shapes: the match kernel at
   1000 features x 4096 visible landmarks at 80 px and 60 px (max_dist 45,
   ratio 0.9, mutual), exact against its plain version, with its device
   time, bound and wrapper time.
2b. Per-level kernels: `fast_nms`, `blur7`, `frontend_pass` and
   `frontend_pass_lite` on each of the 8 levels of the 752x480, 1241x376
   and 512x512 frames' pyramids (the first frames of phases 3, 5 and 7),
   against the zero-padding mirror (`ops/frontend_level.py` `*_zero`, the
   Pallas kernels' function) on the whole image and against their plain
   versions on the interior, at the JAX oracle tests' tolerances (`blur7`
   equal to the mirror bit for bit); two
   launches on one input must give the same bits, a call must dispatch
   only `torch.empty` and enqueue its one kernel alone; one call of each
   timed on level 0 of 752x480; `blur7` beside `conv2d` with the same 7x7
   taps (its library yardstick) and beside the copy floor, the device time
   of one elementwise kernel (`torch.add(level, 0.0, out=out)`) that reads
   and writes the same bytes.
   For every kernel phases 2 and 2b print its device time per launch
   (torch.profiler, the kernel's own device events), its bound (the larger
   of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s, H100
   SXM data sheet) and the share of the bound, the wrapper's time (CUDA
   events around back-to-back calls, what the path pays) and the plain
   version's.
3. Slice: renders a 752x480 sequence (EuRoC intrinsics, seed 1), seeds a
   full-size map (256 keyframes, 8192 landmarks, 1000 features) from frame
   0's features and ground-truth depth, and tracks the following frames with
   `runtime.system.frame_step` under constant-velocity prediction. Checks
   inliers and pose error against ground truth on every frame, that the same
   frames through the plain versions on the card give the same poses, and
   that the kernels' launch counters show the path went through them.
4. System: `System.track_monocular` from a blank map over 40 rendered
   752x480 frames (EuRoC cam0 intrinsics; the configuration of
   `orb_slam3_ros2_tpu_torch/tools/system_run.py`), through the two-view
   initializer, tracking and keyframe mapping, held to the bounds of
   `tests/test_e2e_mono.py`; SearchAndFuse must launch the match kernel
   once per inserted keyframe.
5. Stereo: `System.track_stereo` from a blank map over 30 rendered
   1241x376 pairs of the textured room at KITTI00-02's calibration and
   2000 features
   (`kitti_stereo` of `tools/system_run.py`), held to the bounds of
   `tests/test_e2e_stereo.py`: state OK, more than 15 tracked frames,
   Sim3-aligned ATE under 0.08 m, unaligned length within 12%.
6. RGB-D: `System.track_rgbd` over 30 rendered 640x480 image + depth frames
   at TUM1's intrinsics (`tum1_rgbd`), held to `tests/test_e2e_rgbd.py`'s
   bounds (the length within 10%).
7. Fisheye stereo: `System.track_stereo` over 22 rendered 512x512 KB8 pairs
   of TUM-VI's two cameras through the general two-view rig
   (`tumvi_stereo`), held to `tests/test_e2e_fisheye.py`'s stereo bounds:
   at least n - 8 tracked, ATE under 0.10 m, length within 10%.
   Phases 5-7 also require each kernel on the path: the frontend kernel
   once per image, the pose kernel twice per tracked frame after the
   initializing one, the match kernel once per SearchAndFuse.
8. Relocalization (`euroc_reloc` of `tools/system_run.py`): the phase 4
   clip rendered through EuRoC cam0's distortion, 40 frames through
   `System.track_monocular` on `config/Monocular/EuRoC.yaml` as published
   (loop closing on), then the four scenarios of the JAX Atlas tests: a
   blackout and frame 10 re-shown (recovers into map 0, drops the junk
   map, centre within 0.1 m of its tracked centre), a blank frame (stays
   LOST), the Atlas saved and loaded by a new System through
   `System.LoadAtlasFromFile` (starts LOST, relocalizes within 10 frames
   with no new initialization), and LOST_FRAMES_NEW_MAP + 8 noise frames
   after the blackout's recovery (the resumed map is protected: a second
   map spawns and map 0 keeps its keyframes); the same noise on a fresh
   copy restarts the map in place when it has fewer than
   MIN_KFS_KEEP_MAP keyframes (the stock fps of 20 gives the 40-frame map
   about 6), and spawns a map otherwise. Prints ms per lost
   frame with and without a recovery and the kernels' launches in the
   lost frames; the match and pose calls of the first relocalization tries
   are recorded and each is held against its plain version on the same
   inputs (match: exact; pose: R within 5e-5, t within 5e-4, the inlier
   sets differing in at most one point).
9. Loop closing (`synth_loopy`, the JAX evaluation's row): 280 frames of
   the leave-and-return room clip at 640x480, fx 450, fps 10, seed 3, once
   with loop closing on and once off: at least one loop closed or map
   merged, and Sim3-aligned ATE with it on below ATE with it off. Prints
   both ATEs, tracked frames, ms per frame and the ms of the frames that
   close a loop. On this clip tracking is lost during the excursion (in
   the JAX System too), so the event is a map merge: its PnP refinement's
   match and pose calls are recorded and held against their plain
   versions as in phase 8. Global BA's memory on the final map follows the
   live window, not the map's capacity.
9b. In-map loop closure: `System._try_close_loop` on the corridor of the
   JAX loop-closing tests (`system_run.run_corridor_loop`), on the card:
   the loop closes on the second detection (Sim3 check, essential graph,
   seam SearchAndFuse with the match kernel, global BA), and the
   corrected keyframe centres agree with the same run on the CPU within
   1e-3 m.
10. Mono-inertial (`euroc_vi` of `tools/system_run.py`):
   `config/Monocular-Inertial/EuRoC.yaml` as published (600x350 after its
   resize, 1000 features, 8 levels, fps 20, `IMU.T_b_c1`, 200 Hz, loop
   closing on) in IMU_MONOCULAR mode over 120 frames of the hard room
   rendered through that radtan camera, with the 200 Hz IMU of the body
   under `IMU.T_b_c1` (EuRoC-grade noise and bias walk, a gyro bias). Bars
   (`system_run.vi_failures`, tests/test_e2e_vi.py's): the IMU initializes
   (`is_imu_initialized`, `get_inertial_ba1`), state OK at the end, the
   gyro bias within 2e-2, and after the VI init more than 20 frames, the
   Umeyama scale within 10% and the unaligned length within 35% on
   `get_frame_trajectory()`; the JAX System's numbers on the same clip on a
   CPU are printed beside. Prints the ms of frames with and without an
   insertion, of every VI-init, VI local BA, full inertial BA and scale
   refinement call, one interval's preintegration (wall, device time and
   launches from torch.profiler), and the dropped IMU samples; the match
   and pose calls of the first tracked frames after the VI init are held
   against their plain versions as in phase 8.
10b. Stereo- and RGB-D-inertial: IMU_STEREO and IMU_RGBD on the clips of
   tests/test_e2e_stereo_inertial.py and test_e2e_rgbd_inertial.py (320x240,
   60 frames), held to those tests' bounds (`system_run.vi_rig_metrics`),
   but for the stereo clip's length ratio: the JAX System fed the feature
   sets that the card extracts misses the test's 12% there, so the bar is
   its number (`STEREO_VI_LENGTH_JAX_CARD`), and the run's feature sets
   must equal those it was read on (`tests/data/`; ROADMAP §3).
11. Replay (`tools/run_slam.py`, the port's replay entry point, called as
   a user calls it: `main(argv)` on the card). 11a: phase 4's clip as
   uint8 frames, written by the port's `SequenceRecorder` as a EuRoC
   directory (cam0 PNGs, `data.csv`, ground truth) and by its
   `McapWriter` as an mcap rosbag2 of the same frames and timestamps under
   `build/replay/`, replayed with `--dataset DIR` and with
   `--playback-bag BAG` (`--checkpoint-every 10 --profile`). Bars: both
   runs meet phase 4's bounds (ATE < 0.05 m, raw ATE < 0.12 m, >= 4
   keyframes, > 100 landmarks, > 20 tracked); their trajectories are equal
   to the last digit (the TUM files byte for byte, the poses exactly); the
   PCD has points and `outputs.load_pcd` reads it back; the PGM and YAML
   exist; the TUM file has one row per frame the System took (the JAX
   session's format: frames before the initialization too); the last
   checkpoint (frame 40) loads into a fresh `System(load_atlas=...)` with
   the keyframes it was saved with. Prints the median `track_monocular`
   ms (the System's own tracking log) against phase 4's in the same run,
   the frame load's (PNG read and decode, or bag message decode) and the
   Atlas checkpoint's medians, the loop's mean ms a frame, the stage
   report, the three kernels' launches a frame, and whether the native
   point-cloud filter loaded.
   11b: phase 6's TUM1 clip written in the TUM RGB-D layout (`rgb/`,
   16-bit `depth/` at 5000 units a metre, `rgb.txt`, `depth.txt`,
   `groundtruth.txt`; `io/tum_rgbd.write_sequence`) and replayed with
   `--mode rgbd`, held to phase 6's bars.
   11c: the EuRoC directory's first 10 frames replayed again with
   `--torch-profile`: from the trace, each stage's calls, the kernel
   launches issued inside it, their device time, and the traced window's
   device busy share. Bar: the trace shows `extract` once a frame with
   launches and device time inside it.
12. Mesh (`parallel/`, `atlas/icp_align.py`). 12a: each sharded solver at
   full width three ways: over a mesh of 1 shard on an NCCL group of world
   size 1 (each psum runs the collective), over 8 shards on the one card,
   and its one-device counterpart; ms per iteration of each. The
   landmark-sharded BA on MULTISESSION.json's 48-pose x 16,384-landmark
   window (`tools/multisession.py`): R within 1e-4, the camera centres
   within 3e-3 m after the one free scale of the window (only keyframe 0
   is fixed) and the cost within 2% of `bundle_adjust` with the same chi2
   refresh period, and the cost within 2% of the JAX CPU mesh's
   491,553.28. The edge-sharded pose graph on the 12-session, 384-keyframe
   city graph: R, t, s within 5e-4 / 5e-3 / 5e-4 of `optimize_pose_graph`,
   rmse after within 10% of the JAX CPU mesh's 0.0198 m. The sharded VI BA
   on tests/test_sharded_vi_ba.py's clip under that test's bars, with the
   gravity direction fixed and optimized (the solved tangent nonzero and
   within 1e-3 of `vi_bundle_adjust`'s). The block BA on
   tests/test_block_ba.py's four blocks over a (kf, lm) = (2, 4) mesh:
   each block within 1e-4 of the 1-D solver on it alone. 12b: phase 9b's
   corridor with `System(mesh=make_mesh(1))` on the NCCL group: the loop
   closes, the global BA ran over the mesh, the corrected centres equal
   phase 9b's within 1e-3 m, and the loop closure's match calls equal
   their plain versions. 12c: phase 4's map cloud aligned with
   `align_maps` to a copy moved by 5 degrees and 0.2 m
   (tests/test_icp_align.py's bars). 12d: `parallel.distributed_session`
   in 2 processes x 4 shards and `parallel.live_session` in 4 processes x
   2 shards, every rank on the one card, gloo between them, held to
   tests/test_distributed_session.py's and test_live_session.py's bars;
   each rank's tracking ms per frame and kernel launches are printed.
13. Pipelined mode (`System(pipelined=True)`): 13a on phase 4's clip and
   settings (752x480, 1000 features, a 256 x 8192 map, 40 frames), held
   to phase 4's bars; 13b IMU_MONOCULAR on phase 10's clip and settings
   (120 frames, the 200 Hz IMU), held to `system_run.vi_failures`' bars,
   and the frames that took the pipelined path (in flight after their
   call) at least 90% of the JAX System's on the same clip on a CPU
   (`VI_PIPELINED_JAX_CPU`). Each run has its own loop (`pipe_loop`): a
   host clock around each call and no synchronize, one synchronize and
   the flush at the end. On every frame whose device pose chain is up,
   the dispatch half runs under `torch.cuda.set_sync_debug_mode("error")`
   (any host sync fails the phase); every summary read from its pinned
   buffer must equal a blocking read of the same device tensor bit for
   bit; the frontend kernel launches once a frame, the match kernel 3
   times a tracked frame plus once a SearchAndFuse, the pose kernel
   twice a tracked frame. Prints the per-call ms over the second half
   (p50 / p95 / max, calls over 33 ms) beside the synchronous System on
   the same clip in turns (host times drift between the phases of one
   process) and beside phases 4 and 10, the `summary_fetch` and
   `mapping_fused` stage medians, the host syncs (reported by sync debug
   mode "warn") and summary waits a frame, and the dropped IMU samples.
14. Benchmark: `tools/bench.py`'s `main` at its published sizes (the
   tracking loop's batch-size slope at 752x480, the 64 x 8192 BA's
   iteration slope, the pipelined System's steady frames/s, monocular and
   mono-inertial), each part's kernel launches counted from 0 around it:
   `bench.py`'s keys, the four numbers finite and positive, >= 4
   keyframes, the IMU initialized, the card's name and power limit in
   `extra`, one launch of each main-path kernel a frame of the tracking
   loop (`match_to_map`, not `track_frame`), and every main-path kernel
   launched. Prints the JSON line.
15. Evaluation: `tools/eval_ate.py`'s synthetic suite in full (the
   configuration of EVAL.md's rows; its outputs under build/eval/, an
   empty data directory so that no real sequence replaces the suite),
   each row held to its bar against EVAL.md's JAX row: ATE at most
   max(1.5 x, + 0.01 m), the tracked share at least 95%, every
   mono-inertial seed's IMU initialized, a loop closed or a map merged on
   `synth_loopy`. The `synth_loopy` row is phase 9's two runs (the same
   clip and settings), not run again. The rows of `EVAL_ATE_CEILING_M`
   are held to that ATE ceiling in place of their bar's (PERF.md §6).
16. Entry points: the port's remaining tools on the card, each called as
   a user calls it (`main(argv)`, or `entry()` / `dryrun_multichip`), its
   kernel launches counted from 0 around it; outputs under build/chip/.
   16a `tools/graft_entry.py`: one step of `entry()` launches each
   main-path kernel once, with > 100 inliers, R and t within 1e-3 of the
   identity, and equals the step through the plain versions (R within
   5e-5, t within 5e-4, the same inliers); its ms a step; then
   `dryrun_multichip(8)`, 8 shards on the one card, every check of it
   (the 2-D block BA's cut fraction under 0.6x the contiguous one). 16b
   `tools/bench_block_ba.py` at its defaults: the global row within 2% of
   BLOCKBA.json's cost and 1e-3 m of its pose RMSE, the record's shape
   (one block sweep above the global cost, the fourth below the first),
   each row beside the record's. 16c `tools/bench_scaling.py` at 64 x
   32,768, 20 iterations, 1 / 2 / 4 / 8 shards on the card (one rep): the
   final cost equal within 1e-3 relative across shard counts; ms an
   iteration each. 16d `tools/bench_place_recognition.py` at its defaults:
   563 queries over 1,800 entries, each codebook's recall@1 and group
   recall@1 within 0.03 of PR_RECALL.json's. 16e `tools/bench_pr_mapscale.py`
   at the published width with 3,000 entries: 563 queries, recall@1 >=
   0.96; its median query ms. 16f `tools/train_vocab.py --synthetic`: the
   codebook loads in `System(vocab_path=...)` on the card and in
   `loop/vocab.load_vocabulary`. 16g `tools/localize_map.py`: phase 11a's
   session directory against a copy of its cloud moved by 5 degrees and
   0.2 m, the motion recovered within phase 12c's bars. The host-only tools
   (`visualize`, `make_configs`, `calibrate_camera`) are held on the CPU
   only.

The last line is {"ok": true, "device": {...}}; the line before it holds the
per-kernel JSON record (`launches`: the sum over the runs of phases 3-10b,
13, 14, 15 and 16, each counted from 0 around its run, of phase 11's four
replays and of phase 12b; the per-level kernels: phase 2b; `ms`:
device time per launch at the main-path shape, `wrapper_ms` the wrapper's
time there), the line before that the card, and the one before that the
phases' results. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import statistics
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PKG = "orb_slam3_ros2_tpu_torch"

N_TRACK = 20  # frames tracked after the seeding frame
WIDTH, HEIGHT = 752, 480
FX, FY = 458.654, 457.296  # EuRoC cam0
# Pose bounds against ground truth (camera centre, rotation angle), about
# three times what the port's plain path gives on the same 20 frames on a
# CPU (median 0.0021 m, max 0.0066 m).
MEDIAN_POS_M, MAX_POS_M, MAX_ROT_DEG = 0.01, 0.025, 0.25
# kernel path vs plain path on the same frames
AGREE_POS_M, AGREE_ROT_RAD = 1e-3, 1e-3

KERNELS = {
    # name: (source, replaced TPU kernel)
    "frontend_packed": (f"{PKG}/csrc/frontend_packed.cu",
                        "orb_slam3_ros2_tpu/ops/pallas_kernels.py:534"),
    "fused_match": (f"{PKG}/csrc/fused_match.cu",
                    "orb_slam3_ros2_tpu/ops/fused_match.py:113"),
    "pose_opt_fused": (f"{PKG}/csrc/pose_opt_fused.cu",
                       "orb_slam3_ros2_tpu/backend/pose_opt_fused.py:255"),
    "fast_nms": (f"{PKG}/csrc/frontend_level.cu",
                 "orb_slam3_ros2_tpu/ops/pallas_kernels.py:161"),
    "blur7": (f"{PKG}/csrc/frontend_level.cu",
              "orb_slam3_ros2_tpu/ops/pallas_kernels.py:182"),
    "frontend_pass": (f"{PKG}/csrc/frontend_level.cu",
                      "orb_slam3_ros2_tpu/ops/pallas_kernels.py:340"),
}
SOURCES = ("frontend_packed", "fused_match", "pose_opt_fused",
           "frontend_level")

# phase 2b: the JAX oracle tests' tolerances (tests/test_pallas_kernels.py),
# against the zero-padding mirror on the whole image and against the plain
# versions on each level's interior (4 px; 16 px for the moment maps)
LEVEL_SCORE_ATOL = 1e-4
LEVEL_BLUR_RTOL, LEVEL_BLUR_ATOL = 1e-5, 1e-3
LEVEL_MOM_RTOL, LEVEL_MOM_ATOL = 2e-4, 2.0

# phase 4: tests/test_e2e_mono.py's bounds; the JAX System on the clip of
# tools/system_run.py on a CPU: OK, 9 keyframes, 1660 landmarks, 38
# tracked, ATE 0.0078 / 0.0084 m
ATE_MAX_M, ATE_RAW_MAX_M = 0.05, 0.12
MIN_KF, MIN_LM, MIN_TRACKED = 4, 100, 20

# phases 5-7: the rig configurations of tools/system_run.py; their bounds
# are those of the JAX e2e tests (`system_run.RIGS`). The JAX System on the
# same clips on a CPU: OK, 30/30/22 tracked, ATE 0.0125 / 0.0053 / 0.0158 m,
# length ratio 1.0054 / 0.9966 / 0.9274 (PERF.md §4)
RIG_PHASES = ("kitti_stereo", "tum1_rgbd", "tumvi_stereo")

# phases 8 and 9: the pose kernel against its plain version on the
# recorded relocalization and merge-PnP inputs (real matches: a point at
# the chi2 threshold may classify either way)
RECORDED_POSE_DR, RECORDED_POSE_DT, RECORDED_POSE_INLIER_FLIPS = (
    5e-5, 5e-4, 1)
FX_LOOPY = 450.0  # the synth_loopy camera (640x480, centred)
# phase 9: the JAX System on the same clip on a CPU: ATE 0.337 m with loop
# closing on (its event a map merge, as the port's; 164 of 280 frames
# tracked), 0.3929 m off (PERF.md §4)
# phase 9: an accept/reject decision of the pose LM (candidate cost
# against the accepted cost) closer than this, relative, is inside the f32
# rounding of the cost (its residuals are differences of ~300 px
# coordinates, ulp 3e-5 px, so a 1 px residual's chi2 carries ~6e-5), and
# the kernel, summing in another order, may take it the other way
POSE_DECISION_NOISE = 1e-5
# phase 10: the JAX System on the same clip on a CPU
# (`scripts/jax_reference_runs.py --config euroc_vi`)
VI_JAX_CPU = dict(vi_init_frame=41, n_kf=21, n_tracked=118,
                  bg_err=0.000622, ate_m=0.025305, scale_err_end=0.056465,
                  umeyama_scale=1.019000, length_ratio=1.132791)
# phase 13b: the frames of that clip that took the pipelined path in the
# JAX System(pipelined=True) on a CPU (`scripts/jax_reference_runs.py
# --config euroc_vi_pipelined`: a frame in flight after its call, as
# `bench.py` counts them)
VI_PIPELINED_JAX_CPU = 78
# phase 10b: the JAX System fed the feature sets that the card extracts
# from the stereo-inertial clip (`tests/data/stereo_vi_card_features.npz`,
# written by `tools/vi_rig_diff.py --save-features` on an H100; read by
# `scripts/jax_reference_runs.py --config vi_rigs --features`, the same
# number on two CPUs) reads a length ratio past the e2e test's 12%: on the
# card's inputs the reference misses that bound, so it is the clip's bar
# here, while the card's feature sets are those (ROADMAP §3;
# tests/test_torch_vi_rig_replay.py holds the port to JAX on them)
STEREO_VI_CARD_FEATURES = "tests/data/stereo_vi_card_features.npz"
STEREO_VI_LENGTH_JAX_CARD = 1.154663
# phase 10b: the JAX System on the same clips on a CPU (`--config vi_rigs`)
VI_RIGS_JAX_CPU = dict(
    synth_stereo_inertial=dict(bg_err=0.004206, ate_m=0.027805,
                               length_ratio=1.071635),
    synth_rgbd_inertial=dict(bg_err=0.003607, ate_m=0.016817,
                             length_ratio=1.018267))
# phase 13: the frame budget of a 30 frames/s camera (PERF.md §2)
FRAME_BUDGET_MS = 33.0
# phase 9b: the corridor's corrected keyframe centres on the card against
# the same run on the CPU (m)
CORRIDOR_CENTRE_M = 1e-3
# phase 11: where the replays' inputs and artifacts go (gitignored), and
# the checkpoint period (phase 4's 40 frames: the last one checkpoints)
REPLAY_DIR = ROOT / "build" / "replay"
REPLAY_CKPT_EVERY = 10
# phase 11c: the frames replayed under torch.profiler (phase 4's clip
# initializes at frame 2, so the rest track)
REPLAY_PROFILE_FRAMES = 10

# The card's peaks, the kernels' operation counts and the bound live in
# `orb_slam3_ros2_tpu_torch/tools/roofline.py`, which
# `tools/profile_tracking.py` reads too.


class PhaseError(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_times(fn, names, n_bytes, n_ops, plain=None) -> dict:
    """Device time per launch (profiler), bound and share, the wrapper's
    time and the plain version's, for the kernel behind fn()."""
    from orb_slam3_ros2_tpu_torch.tools.kernel_timing import (device_events,
                                                              time_ms)
    from orb_slam3_ros2_tpu_torch.tools.roofline import bound

    dev_ms, ops = device_events(fn, names)
    out = dict(device_ms=dev_ms, device_ops=ops, wrapper_ms=time_ms(fn),
               **bound(n_bytes, n_ops))
    out["ms"] = dev_ms if dev_ms is not None else out["wrapper_ms"]
    out["share"] = out["bound_ms"] / out["ms"]
    if plain is not None:
        out["plain_ms"] = time_ms(plain)
    return out


def aten_ops(fn) -> list:
    """The aten operators (OpOverloads) one call of fn() dispatches, in
    order."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    with Log() as log:
        fn()
    return log.ops


def print_times(label: str, r: dict) -> None:
    dev = ("not measured" if r["device_ms"] is None
           else f"{r['device_ms']:.5f} ms")
    extra = "".join(f", {k} {r[k]:.5f} ms" for k in
                    ("plain_ms", "library_ms", "floor_ms", "copy_floor_ms")
                    if r.get(k) is not None)
    print(f"{label}: device {dev} per launch, bound {r['bound_ms']:.5f} ms "
          f"({r['bound_by']}: {r['bytes']:.0f} B, {r['ops']:.0f} ops), "
          f"share {r['share']:.1%}, wrapper {r['wrapper_ms']:.5f} ms{extra}")


# ---------------------------------------------------------------- phase 2

def check_frontend(img, dev, n_features=None):
    """The packed frontend on img's 8-level pyramid against its plain
    version: score exact on the whole canvas, keep exact 4 px inside each
    level, raw exact on each level, blur within the oracle's bounds 4 px
    inside each level, 0 / false outside the levels; one kernel and no
    other device op per call. With `n_features`, the extractor's features
    through the kernel and through the plain version must be identical.
    Returns max_abs_err and the times of `kernel_times`."""
    import torch
    from orb_slam3_ros2_tpu_torch.ops import frontend_packed as fp
    from orb_slam3_ros2_tpu_torch.ops import pyramid as pyr
    from orb_slam3_ros2_tpu_torch.tools.roofline import frontend_packed_cost

    levels = pyr.build_pyramid(torch.from_numpy(img).to(dev), 8, 1.2)
    score, keep, blur, raw, layout = fp.frontend_pass_packed(levels)
    s_r, k_r, b_r, r_r, lay_r = fp.frontend_pass_packed_ref(levels)
    torch.cuda.synchronize()
    tag = f"frontend {img.shape[1]}x{img.shape[0]}"
    _, total = fp.pack_layout([tuple(l.shape) for l in levels])
    require(layout == lay_r and tuple(score.shape) == (total, img.shape[1]),
            f"{tag}: layout {layout}, canvas {tuple(score.shape)}")
    require(bool((score == s_r).all()), f"{tag}: score not exact, max "
            f"{(score - s_r).abs().max().item()}")
    require(bool((raw == r_r).all()), f"{tag}: raw differs")
    outside = torch.ones_like(keep)
    B = 4
    err = 0.0
    for (r0, h, w) in layout:
        outside[r0:r0 + h, :w] = False
        sl = (slice(r0 + B, r0 + h - B), slice(B, w - B))
        require(bool((keep[sl] == k_r[sl]).all()),
                f"{tag}: keep differs at level row {r0}")
        db = (blur[sl] - b_r[sl]).abs()
        require(bool((db <= 1e-3 + 1e-5 * b_r[sl].abs()).all()),
                f"{tag}: blur differs by {db.max().item()} at row {r0}")
        err = max(err, db.max().item())
    require(not bool(keep[outside].any())
            and all(bool((x[outside] == 0).all()) for x in (score, blur, raw)),
            f"{tag}: a cell outside the levels is not 0 / false")
    ops = [str(op) for op in aten_ops(lambda: fp.frontend_pass_packed(levels))]
    require(ops == ["aten.empty.memory_format"] * 4,
            f"{tag}: the wrapper dispatches {ops}")
    if n_features is not None:
        check_extract(img, dev, n_features)

    n_px = sum(h * w for _, h, w in layout)
    plan = fp.plan_of(levels)
    r = kernel_times(
        lambda: fp.frontend_pass_packed(levels), ("frontend_packed_kernel",),
        *frontend_packed_cost(n_px, score.numel()),
        plain=lambda: fp.frontend_pass_packed_ref(levels))
    if r["device_ms"] is not None:  # the profiler window: this kernel alone
        require(len(r["device_ops"]) == 1
                and "frontend_packed_kernel" in next(iter(r["device_ops"])),
                f"{tag}: one call enqueues {r['device_ops']}")
    print(f"{tag}: device ops of 20 calls {r['device_ops']}, aten ops of "
          f"one call {ops}")
    r.update(max_abs_err=err, levels=len(layout), level_px=n_px,
             canvas=[total, img.shape[1]],
             tiles=plan.n_tiles, zero_fill_blocks=plan.n_zero)
    return r


def bench_shape():
    """The shape of phases 14 and 15: the first frame of `tools/bench.py`'s
    System clips (its `_bench_system_fps_steady` defaults: 640x480, fx 520,
    seed 1; the evaluation's rows are 640x480 too), their features a
    frame and the extractor's total capacity there. Returns (frame,
    n_features, capacity)."""
    import inspect

    from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
    from orb_slam3_ros2_tpu_torch.io.synthetic import render_sequence
    from orb_slam3_ros2_tpu_torch.tools import bench

    d = {k: p.default for k, p in inspect.signature(
        bench._bench_system_fps_steady).parameters.items()}
    img = render_sequence(n_frames=1, width=d["width"], height=d["height"],
                          fx=d["fx"], fy=d["fx"], fps=30.0, seed=1,
                          traj_scale=1.0)[0][0]
    cfg = ex.ExtractorConfig(n_features=d["n_features"], n_levels=8,
                             scale_factor=1.2, height=d["height"],
                             width=d["width"])
    return img, d["n_features"], ex.total_capacity(cfg)


def check_extract(img, dev, n_features):
    """`extract()` on the card through the kernel and through the plain
    frontend: identical uv, level, score, mask and bits."""
    import torch
    from orb_slam3_ros2_tpu_torch.frontend import extractor as ex

    cfg = ex.ExtractorConfig(n_features=n_features, n_levels=8,
                             scale_factor=1.2, height=img.shape[0],
                             width=img.shape[1])
    extract = ex.make_extractor(cfg)
    image = torch.from_numpy(img).to(dev)
    got = extract(image)
    with plain_versions():
        ref = extract(image)
    torch.cuda.synchronize()
    for name in ("uv", "level", "score", "mask", "bits"):
        require(torch.equal(getattr(got, name), getattr(ref, name)),
                f"extract {img.shape[1]}x{img.shape[0]}: {name} differs "
                f"between the kernel and the plain frontend")
    print(f"extract {img.shape[1]}x{img.shape[0]}, {n_features} features: "
          f"identical through the kernel and the plain frontend "
          f"({int(got.mask.sum())} valid)")


def check_match(dev, N=1000):
    """Tracking's shape (N x 4096 visible landmarks, 15 px) under every
    ratio/mutual setting (N = 1000; at N = 2000 the default ratio 0.9,
    mutual), and SearchAndFuse's (N x all 8192 landmark slots, 4 px,
    max_dist 45, no ratio test, not mutual): idx, valid and dist exact
    against the plain version, also over three back-to-back calls on two
    inputs (state left by a launch would show); one call dispatches only
    three `torch.empty` and views and enqueues the kernel alone. Returns
    max_abs_err, the times of the tracking call and of the SearchAndFuse
    call, and each one's latency floor (the same launch without the
    sweeps)."""
    import torch
    from orb_slam3_ros2_tpu_torch.ops import fused_match as fm
    from orb_slam3_ros2_tpu_torch.tools.kernel_timing import (device_events,
                                                              match_tensors)

    args, kw = match_tensors(N, 4096, "track", 0 if N == 1000 else 4, dev)
    settings = [(args, dict(kw, ratio=ratio, mutual=mutual))
                for ratio in (0.9, None) for mutual in (True, False)
                if N == 1000 or (ratio, mutual) == (0.9, True)]
    fuse_args, fuse_kw = match_tensors(N, 8192, "fuse",
                                       2 if N == 1000 else 5, dev)
    settings.append((fuse_args, fuse_kw))
    other, _ = match_tensors(N, 4096, "track", 7, dev)
    # back to back, no synchronize between: the first input again after
    # another, so that state left by a launch would change a result
    settings += [(args, kw), (other, kw), (args, kw)]
    gots = [fm.match_window(*a, **k) for a, k in settings]
    err = 0.0
    for (a, k), got in zip(settings, gots):
        ref = fm.match_window_ref(*a, **k)
        torch.cuda.synchronize()
        what = f"{N}x{a[3].shape[0]}, {k}"
        n_ok = int(ref.valid.sum())
        require(n_ok > 300, f"match case {what} has only {n_ok} matches")
        require(torch.equal(got.valid, ref.valid)
                and torch.equal(got.idx, ref.idx),
                f"match idx/valid differ ({what})")
        v = ref.valid
        err = max(err, (got.dist[v] - ref.dist[v]).abs().max().item())
    require(err == 0.0, f"match distances differ by {err}")

    def cost(a, k):
        return match_cost(a, k["radius"])

    names = ("match_window_kernel",)
    out = {}
    for key, a, k in (("track", args, kw), ("fuse", fuse_args, fuse_kw)):
        tag = f"match {N}x{a[3].shape[0]} at {k['radius']:g} px"
        ops = aten_ops(lambda: fm.match_window(*a, **k))
        empty = [str(op) == "aten.empty.memory_format" for op in ops]
        require(sum(empty) == 3
                and all(e or op.is_view for e, op in zip(empty, ops)),
                f"{tag}: the wrapper dispatches {ops}")
        ops = [str(op) for op in ops]
        r = kernel_times(lambda: fm.match_window(*a, **k), names, *cost(a, k),
                         plain=lambda: fm.match_window_ref(*a, **k))
        if r["device_ms"] is not None:  # the profiler window: the kernel alone
            require(len(r["device_ops"]) == 1
                    and names[0] in next(iter(r["device_ops"])),
                    f"{tag}: one call enqueues {r['device_ops']}")
        r["floor_ms"], _ = device_events(
            lambda: fm.latency_floor(*a, **k), names)
        print(f"{tag}: plan {fm.plan_for(N, a[3].shape[0])}, "
              f"{fm.blocks_for(N, a[3].shape[0])} blocks, device ops of 20 "
              f"calls {r['device_ops']}, aten ops of one call {ops}")
        print_times(tag, r)
        out[key] = r
    track = out["track"]
    track.update(max_abs_err=err, fuse={k: v for k, v in out["fuse"].items()
                                        if k != "device_ops"})
    return track


def match_cost(a, radius: float):
    """Bytes and operations of one match call on a's inputs
    (`tools/roofline.match_cost`)."""
    from orb_slam3_ros2_tpu_torch.tools import roofline

    _, ma, uva, _, mb, uvb = a
    return roofline.match_cost(uva, ma, uvb, mb, radius)


def check_match_reloc(dev, N=1000, M=4096):
    """Relocalization's two match shapes (N x M visible landmarks at 80 px
    from the last pose and at 60 px from a BoW keyframe, max_dist 45,
    ratio 0.9, mutual): idx, valid and dist exact against the plain
    version; the device time, bound and wrapper time of each. Returns the
    80 px times with the 60 px ones under "reloc60"."""
    import torch
    from orb_slam3_ros2_tpu_torch.ops import fused_match as fm
    from orb_slam3_ros2_tpu_torch.tools.kernel_timing import match_tensors

    out, err = {}, 0.0
    for key, seed in (("reloc80", 11), ("reloc60", 12)):
        a, k = match_tensors(N, M, key, seed, dev)
        got = fm.match_window(*a, **k)
        ref = fm.match_window_ref(*a, **k)
        torch.cuda.synchronize()
        tag = f"match {N}x{M} at {k['radius']:g} px (relocalization)"
        n_ok = int(ref.valid.sum())
        require(n_ok > 300, f"{tag}: only {n_ok} matches")
        require(torch.equal(got.valid, ref.valid)
                and torch.equal(got.idx, ref.idx), f"{tag}: idx/valid differ")
        v = ref.valid
        err = max(err, (got.dist[v] - ref.dist[v]).abs().max().item())
        r = kernel_times(lambda: fm.match_window(*a, **k),
                         ("match_window_kernel",), *match_cost(a, k["radius"]),
                         plain=lambda: fm.match_window_ref(*a, **k))
        r.pop("device_ops")
        print_times(tag, r)
        out[key] = r
    require(err == 0.0, f"relocalization match distances differ by {err}")
    r = out.pop("reloc80")
    r.update(max_abs_err=err, reloc60=out["reloc60"])
    return r


def check_pose(dev, N=1000):
    """The pose kernel on N observations (30% outliers) against its plain
    version (R within 5e-5, t within 5e-4, identical inliers and count)
    and the true pose; two launches bit-identical; one call dispatches
    only `torch.empty` and views and enqueues the kernel alone. Returns
    max_abs_err, both times, the plan and the latency floor: the same
    launch shape doing only the 18 reduce-and-broadcasts."""
    import torch
    from orb_slam3_ros2_tpu_torch.backend import pose_opt, pose_opt_fused
    from orb_slam3_ros2_tpu_torch.tools.kernel_timing import (device_events,
                                                              pose_case)
    from orb_slam3_ros2_tpu_torch.tools.roofline import POSE_EVALS, pose_cost

    X, uv, invs2, mask, K, R_true, t_true = pose_case(
        N, 1 if N == 1000 else N)
    args = (torch.eye(3, device=dev), torch.zeros(3, device=dev),
            *(torch.from_numpy(a).to(dev) for a in (X, uv, invs2, mask)), *K)
    got = pose_opt_fused.optimize_pose_fused(*args)
    again = pose_opt_fused.optimize_pose_fused(*args)
    ref = pose_opt.optimize_pose(*args)
    torch.cuda.synchronize()
    tag = f"pose N={N}"
    dR = (got.R - ref.R).abs().max().item()
    dt = (got.t - ref.t).abs().max().item()
    require(dR <= 5e-5 and dt <= 5e-4, f"{tag}: dR {dR}, dt {dt}")
    require(bool((got.inliers == ref.inliers).all())
            and got.n_inliers.dtype == torch.int32
            and int(got.n_inliers) == int(ref.n_inliers),
            f"{tag}: inlier sets differ")
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"{tag}: two launches differ")
    require(np.abs(got.R.cpu().numpy() - R_true).max() < 2e-3
            and np.abs(got.t.cpu().numpy() - t_true).max() < 1e-2,
            f"{tag}: the kernel did not converge to the true pose")
    ops = aten_ops(lambda: pose_opt_fused.optimize_pose_fused(*args))
    n_empty = sum(str(op) == "aten.empty.memory_format" for op in ops)
    require(n_empty == 3 and all(str(op) == "aten.empty.memory_format"
                                 or op.is_view for op in ops),
            f"{tag}: the wrapper dispatches {ops}")
    out = kernel_times(
        lambda: pose_opt_fused.optimize_pose_fused(*args),
        ("pose_opt_kernel",), *pose_cost(N),
        plain=lambda: pose_opt.optimize_pose(*args))
    if out["device_ms"] is not None:  # the profiler window: this kernel alone
        require(len(out["device_ops"]) == 1
                and "pose_opt_kernel" in next(iter(out["device_ops"])),
                f"{tag}: one call enqueues {out['device_ops']}")
    floor_ms, _ = device_events(
        lambda: pose_opt_fused.latency_floor(POSE_EVALS, N, dev),
        ("pose_floor_kernel",))
    print(f"{tag}: plan (threads, points a thread, cluster) "
          f"{pose_opt_fused.plan_for(N)}, device ops of 20 calls "
          f"{out['device_ops']}, aten ops of one call "
          f"{[str(op) for op in ops]}, latency floor {floor_ms} ms")
    out.update(max_abs_err=max(dR, dt), floor_ms=floor_ms,
               plan=list(pose_opt_fused.plan_for(N)))
    return out


# --------------------------------------------------------------- phase 2b

def _max_err(got, ref, rtol, atol, what):
    """Max |got - ref|; fails past atol + rtol |ref|."""
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    worst = d.max().item() if d.numel() else 0.0
    require(bool((d <= atol + rtol * r.abs()).all()),
            f"{what} differs by {worst}")
    return worst


def _interior_err(got, ref, b, rtol, atol, what):
    """Max |got - ref| on the b-px interior; fails past atol + rtol |ref|."""
    return _max_err(got[b:-b, b:-b], ref[b:-b, b:-b], rtol, atol,
                    f"{what} on the interior")


def level_cases():
    """The per-level wrappers, their kernels' names and outputs (score,
    keep, blur, moments), bytes a pixel (in f32 + out) and operations a
    pixel."""
    from orb_slam3_ros2_tpu_torch.tools.roofline import (OPS_BLUR, OPS_FAST,
                                                         OPS_MOMENTS, OPS_NMS)

    return (
        ("fast_nms", "level_kernel<false, false>", "sk", 4 + 5,
         OPS_FAST + OPS_NMS),
        ("blur7", "blur7_kernel", "b", 4 + 4, OPS_BLUR),
        ("frontend_pass", "level_kernel<true, true>", "skmmb", 4 + 17,
         OPS_FAST + OPS_NMS + OPS_BLUR + OPS_MOMENTS),
        ("frontend_pass_lite", "level_kernel<true, false>", "skb", 4 + 9,
         OPS_FAST + OPS_NMS + OPS_BLUR),
    )


def _check_level(name, kinds, got, zero, ref, tag, err):
    """One wrapper's outputs on one level against the mirror (whole image;
    `blur7` bit for bit) and the plain version (interior)."""
    tol = dict(s=(0.0, LEVEL_SCORE_ATOL), b=(LEVEL_BLUR_RTOL, LEVEL_BLUR_ATOL),
               m=(LEVEL_MOM_RTOL, LEVEL_MOM_ATOL))
    for kind, g, z, r in zip(kinds, got, zero, ref):
        what = f"{name} {kind} {tag}"
        if name == "blur7":
            require(g.equal(z), f"{what}: differs from the mirror at "
                    f"{int((g != z).sum())} cells")
        if kind == "k":
            require(bool((g == z).all()), f"{what}: keep differs from the "
                    f"mirror at {int((g != z).sum())} cells")
            require(bool((g[4:-4, 4:-4] == r[4:-4, 4:-4]).all()),
                    f"{what}: keep differs on the interior")
            continue
        err[name] = max(err[name], _max_err(g, z, *tol[kind], what))
        _interior_err(g, r, 16 if kind == "m" else 4, *tol[kind], what)


def check_frontend_level(images, dev, record):
    """The per-level ops API on every level of each image's pyramid: the
    path run (counters from 0), each output against the zero-padding mirror
    on the whole image and the plain version on the interior, two launches
    bit for bit; then one call of each on level 0 of the first image, its
    dispatched ops, its device ops and its times."""
    import torch
    from orb_slam3_ros2_tpu_torch.ops import frontend_level as fl
    from orb_slam3_ros2_tpu_torch.ops import pyramid as pyr
    from orb_slam3_ros2_tpu_torch.tools.kernel_timing import (copy_floor_ms,
                                                              device_events,
                                                              time_ms)

    pyramids = [pyr.build_pyramid(torch.from_numpy(img).to(dev), 8, 1.2)
                for img in images]
    cases = level_cases()
    fns = [getattr(fl, name) for name, *_ in cases]

    def as_tuple(out):
        return out if isinstance(out, tuple) else (out,)

    for fn in fns:
        fn.launches = 0
    outs = [[tuple(as_tuple(fn(level)) for fn in fns) for level in levels]
            for levels in pyramids]
    torch.cuda.synchronize()
    launches = [fn.launches for fn in fns]
    n_levels = sum(map(len, pyramids))
    print(f"per-level launches over {n_levels} levels of "
          f"{len(pyramids)} pyramids: {launches}")
    require(launches == [n_levels] * 4, "a per-level kernel did not run")
    err = {name: 0.0 for name, *_ in cases}
    for levels, level_outs in zip(pyramids, outs):
        for level, got in zip(levels, level_outs):
            tag = f"level {tuple(level.shape)}"
            for (name, _, kinds, _, _), fn, g in zip(cases, fns, got):
                again = as_tuple(fn(level))
                require(all(torch.equal(a, b) for a, b in zip(g, again)),
                        f"{name} {tag}: two launches differ")
                zero = as_tuple(getattr(fl, f"{name}_zero")(level))
                ref = as_tuple(getattr(fl, f"{name}_ref")(level))
                _check_level(name, kinds, g, zero, ref, tag, err)
    level0 = pyramids[0][0]
    n_px = level0.numel()
    for (key, kname, _, b_px, o_px), fn, n_l in zip(cases, fns,
                                                   launches):
        ops = [str(op) for op in aten_ops(lambda: fn(level0))]
        require(set(ops) == {"aten.empty.memory_format"},
                f"{key}: the wrapper dispatches {ops}")
        r = kernel_times(lambda: fn(level0), (kname,), b_px * n_px,
                         o_px * n_px,
                         plain=lambda: getattr(fl, f"{key}_ref")(level0))
        if r["device_ms"] is not None:  # the profiler window: this kernel
            require(len(r["device_ops"]) == 1
                    and kname in next(iter(r["device_ops"])),
                    f"{key}: one call enqueues {r['device_ops']}")
        print(f"{key}: device ops of 20 calls {r['device_ops']}, aten ops "
              f"of one call {ops}")
        r.update(launches=n_l, max_abs_err=err[key])
        record[key] = r
    # blur7's library yardstick: one conv2d with the 7x7 outer product of
    # the same taps and the same zero padding (TF32 off, as the package
    # sets it), timed here and called nowhere in the port
    torch.backends.cudnn.allow_tf32 = False
    g = torch.from_numpy(pyr._gauss_kernel1d(7, 2.0)).to(dev)
    k2 = torch.outer(g, g)[None, None]

    def conv():
        return torch.nn.functional.conv2d(level0[None, None], k2,
                                          padding=3)[0, 0]

    record["blur7"]["library_ms"] = time_ms(conv)
    record["blur7"]["library_device_ms"] = device_events(conv, ("",))[0]
    record["blur7"]["library_max_abs_diff"] = (
        conv() - fl.blur7(level0)).abs().max().item()
    # and its copy floor: one elementwise pass over the level's bytes
    record["blur7"]["copy_floor_ms"] = copy_floor_ms(level0, calls=20)
    lite = record.pop("frontend_pass_lite")
    record["frontend_pass"]["launches"] += lite["launches"]
    record["frontend_pass"]["max_abs_err"] = max(
        record["frontend_pass"]["max_abs_err"], lite["max_abs_err"])
    record["frontend_pass"]["lite"] = {k: v for k, v in lite.items()
                                       if k != "device_ops"}


# ---------------------------------------------------------------- phase 3

@contextlib.contextmanager
def plain_versions():
    """Route the tracking path through the kernels' plain PyTorch versions
    (for the comparison run only)."""
    from orb_slam3_ros2_tpu_torch.backend import pose_opt, pose_opt_fused
    from orb_slam3_ros2_tpu_torch.ops import frontend_packed as fp
    from orb_slam3_ros2_tpu_torch.ops import fused_match as fm

    saved = [(fp, "frontend_pass_packed", fp.frontend_pass_packed),
             (fm, "match_window", fm.match_window),
             (pose_opt_fused, "optimize_pose_fused",
              pose_opt_fused.optimize_pose_fused)]
    fp.frontend_pass_packed = fp.frontend_pass_packed_ref
    fm.match_window = fm.match_window_ref
    pose_opt_fused.optimize_pose_fused = pose_opt.optimize_pose
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def seed_map(img, depth, R, t, cam, ex_cfg, dev):
    """Frame-0 keyframe: port features back-projected with ground-truth
    depth and pose, inserted into a full-size map."""
    import torch
    from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
    from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
    from orb_slam3_ros2_tpu_torch.runtime import system

    f = ex.make_extractor(ex_cfg)(torch.from_numpy(img).to(dev))
    uv = system.undistort(cam, f.uv)
    uvn = uv.cpu().numpy()
    xi = np.clip(np.round(uvn[:, 0]).astype(int), 0, img.shape[1] - 1)
    yi = np.clip(np.round(uvn[:, 1]).astype(int), 0, img.shape[0] - 1)
    z = depth[yi, xi]
    ok = f.mask.cpu().numpy() & (z > 0.1)
    Xc = np.stack([(uvn[:, 0] - cam.cx) / cam.fx * z,
                   (uvn[:, 1] - cam.cy) / cam.fy * z, z], -1)
    Xw = ((Xc - t) @ R).astype(np.float32)  # R^T (x_c - t)
    cfg = ms.MapConfig(max_kf=256, max_lm=8192, n_feat=ex.total_capacity(ex_cfg))
    m = ms.empty_map(cfg, dev)
    N = cfg.n_feat
    Rd, td = torch.from_numpy(R).to(dev), torch.from_numpy(t).to(dev)
    m = ms.insert_keyframe(m, Rd, td, 0.0, uv, f.level, f.bits, f.mask,
                           torch.full((N,), -1, dtype=torch.int32, device=dev))
    feat = torch.arange(N, dtype=torch.int32, device=dev)
    m = ms.add_landmarks(m, torch.from_numpy(Xw).to(dev), f.bits,
                         torch.from_numpy(ok).to(dev), 0, 0, feat, 0, feat)
    return m, int(ok.sum())


def track(m, imgs, R0, t0, cam, ex_cfg, dev):
    """Track imgs[1:] from the ground-truth frame-0 pose. Returns per-frame
    (R, t, summary, ms) lists."""
    import torch
    from orb_slam3_ros2_tpu_torch.runtime import system

    poses = [(torch.from_numpy(R0).to(dev), torch.from_numpy(t0).to(dev))] * 2
    out = []
    for k in range(1, imgs.shape[0]):
        img = torch.from_numpy(imgs[k]).to(dev)
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        m, f_u, _, R, t, summary = system.frame_step(
            m, *poses[-1], *poses[-2], img, cam, ex_cfg)
        summary = summary.cpu().numpy()
        ms_frame = (time.perf_counter() - t_start) * 1e3
        require(f_u.uv.shape == (1000, 2) and bool(torch.isfinite(f_u.uv).all())
                and np.isfinite(summary).all() and summary.shape == (16,),
                f"frame {k}: non-finite or misshapen output")
        poses.append((R, t))
        out.append((R.cpu().numpy(), t.cpu().numpy(), summary, ms_frame))
    return out


def rot_angle(Ra, Rb) -> float:
    """Angle of Ra Rb^T in radians, from ||Ra - Rb||_F = 2 sqrt(2) sin(θ/2)
    (the arccos of the trace cannot resolve small angles from f32 input)."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0)))


def pose_errors(R, t, R_gt, t_gt):
    """(camera-centre error in m, rotation error in degrees)."""
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    R_gt, t_gt = np.asarray(R_gt, np.float64), np.asarray(t_gt, np.float64)
    c = -R.T @ t
    c_gt = -R_gt.T @ t_gt
    return (float(np.linalg.norm(c - c_gt)),
            float(np.degrees(rot_angle(R, R_gt))))


def run_slice(dev, record):
    import torch
    from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused
    from orb_slam3_ros2_tpu_torch.frontend import extractor as ex
    from orb_slam3_ros2_tpu_torch.io.synthetic import render_sequence
    from orb_slam3_ros2_tpu_torch.models import cameras
    from orb_slam3_ros2_tpu_torch.ops import frontend_packed as fp
    from orb_slam3_ros2_tpu_torch.ops import fused_match as fm

    imgs, depths, R_gt, t_gt, _ = render_sequence(
        n_frames=N_TRACK + 1, width=WIDTH, height=HEIGHT, fx=FX, fy=FY,
        return_depth=True, seed=1)
    cam = cameras.make_camera("PinHole", FX, FY, WIDTH / 2.0, HEIGHT / 2.0,
                              (0.0, 0.0, 0.0, 0.0), WIDTH, HEIGHT, 20.0)
    ex_cfg = ex.ExtractorConfig(n_features=1000, n_levels=8,
                                scale_factor=1.2, height=HEIGHT, width=WIDTH)
    require(ex.total_capacity(ex_cfg) == 1000, "extractor capacity")
    m, n_lm = seed_map(imgs[0], depths[0], R_gt[0], t_gt[0], cam, ex_cfg, dev)
    require(n_lm >= 300, f"seed map has only {n_lm} landmarks")
    print(f"seed map: {n_lm} landmarks from frame 0")

    # warm-up on the seeding frame (allocator, first launches)
    track(m, imgs[:2], R_gt[0], t_gt[0], cam, ex_cfg, dev)
    counters = (fp.frontend_pass_packed, fm.match_window,
                pose_opt_fused.optimize_pose_fused)
    for fn in counters:
        fn.launches = 0
    run = track(m, imgs, R_gt[0], t_gt[0], cam, ex_cfg, dev)
    launches = dict(zip(("frontend_packed", "fused_match", "pose_opt_fused"),
                        (fn.launches for fn in counters)))
    with plain_versions():
        plain = track(m, imgs, R_gt[0], t_gt[0], cam, ex_cfg, dev)

    pos_err, rot_err = [], []
    for k, ((R, t, s, _), (Rp, tp, sp, _)) in enumerate(zip(run, plain), 1):
        pe, re = pose_errors(R, t, R_gt[k], t_gt[k])
        pos_err.append(pe)
        rot_err.append(re)
        print(f"frame {k:2d}: matches {int(s[12]):4d} inliers {int(s[13]):4d}"
              f" pos_err {pe:.5f} m rot_err {re:.4f} deg"
              f" | plain inliers {int(sp[13]):4d}")
        require(s[13] >= 15, f"frame {k}: {int(s[13])} inliers < 15")
        dpos = float(np.abs((-R.T @ t) - (-Rp.T @ tp)).max())
        drot = rot_angle(R, Rp)
        require(dpos <= AGREE_POS_M and drot <= AGREE_ROT_RAD,
                f"frame {k}: kernel and plain paths disagree "
                f"({dpos} m, {drot} rad)")
    med = statistics.median(pos_err)
    print(f"pose error vs ground truth: median {med:.5f} m, max "
          f"{max(pos_err):.5f} m, max {max(rot_err):.4f} deg")
    require(med <= MEDIAN_POS_M and max(pos_err) <= MAX_POS_M
            and max(rot_err) <= MAX_ROT_DEG, "pose error out of bounds")
    n = len(run)
    print(f"launches over {n} frames: {launches}")
    require(launches["frontend_packed"] >= n, "frontend kernel not on path")
    require(launches["fused_match"] >= 2 * n, "match kernel not on path")
    require(launches["pose_opt_fused"] == 2 * n, "pose kernel not on path")
    ms_k = statistics.median(r[3] for r in run)
    ms_p = statistics.median(r[3] for r in plain)
    print(f"frame_step median: {ms_k:.3f} ms (kernels), "
          f"{ms_p:.3f} ms (plain versions)")
    add_launches(record, launches)
    return ms_k, ms_p


def add_launches(record, launches):
    """Add one main-path run's launch counts to the kernels' records."""
    for name, n_l in launches.items():
        record[name]["launches"] = record[name].get("launches", 0) + n_l


# ------------------------------------------------------------ phases 4-7

def drive(slam, step, n_frames: int, label: str,
          insert_name: str = "_insert_keyframe_fused") -> dict:
    """Feed frames 0..n_frames-1 to `step(k)` (one entry-point call) from a
    blank map, with every kernel's launch counter from 0, a host clock
    around each frame and each keyframe insertion (`slam.<insert_name>`,
    ending in a device synchronize), and SearchAndFuse's match-kernel
    launches and `compact_landmarks`' calls recorded. Prints and returns
    the run's counts and times; raises PhaseError unless the System ends
    tracking and the match and pose kernels ran on every tracked frame and
    SearchAndFuse once per inserted keyframe."""
    import torch
    from orb_slam3_ros2_tpu_torch.atlas import map_state as ms
    from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused
    from orb_slam3_ros2_tpu_torch.frontend import tracking as trk
    from orb_slam3_ros2_tpu_torch.ops import frontend_packed as fp
    from orb_slam3_ros2_tpu_torch.ops import fused_match as fm
    from orb_slam3_ros2_tpu_torch.runtime import system as sysm
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    fuse_deltas, compactions, insert_ms = [], [], []
    fuse, compact = trk.fuse_map_points, ms.compact_landmarks

    def counted_fuse(*args, **kwargs):
        before = fm.match_window.launches
        out = fuse(*args, **kwargs)
        fuse_deltas.append(fm.match_window.launches - before)
        return out

    def counted_compact(m):
        compactions.append(int(m.n_lm))
        return compact(m)

    insert = getattr(slam, insert_name)

    def timed_insert(*args, **kwargs):
        torch.cuda.synchronize()
        t_ins = time.perf_counter()
        insert(*args, **kwargs)
        torch.cuda.synchronize()
        insert_ms.append((time.perf_counter() - t_ins) * 1e3)

    setattr(slam, insert_name, timed_insert)
    counters = (fp.frontend_pass_packed, fm.match_window,
                pose_opt_fused.optimize_pose_fused)
    for fn in counters:
        fn.launches = 0
    frame_ms, inserted = [], []
    trk.fuse_map_points, ms.compact_landmarks = counted_fuse, counted_compact
    try:
        for k in range(n_frames):
            n_kf = int(slam.map.n_kf)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            T = step(k)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            require(T.shape == (4, 4) and np.isfinite(T).all(),
                    f"{label} frame {k}: non-finite pose")
            inserted.append(n_kf > 0 and int(slam.map.n_kf) > n_kf)
    finally:
        trk.fuse_map_points, ms.compact_landmarks = fuse, compact
    launches = dict(zip(("frontend_packed", "fused_match", "pose_opt_fused"),
                        (fn.launches for fn in counters)))
    tracked = sr.tracked_frames(slam)
    init_at = tracked[0] if tracked else None
    plain_ms = [t for k, t in enumerate(frame_ms)
                if k in tracked and k != init_at and not inserted[k]]
    kf_ms = [t for k, t in enumerate(frame_ms) if inserted[k]]
    n_ins = sum(inserted)
    out = dict(
        init_frame=init_at, n_kf=int(slam.map.n_kf),
        n_lm=int(slam.map.lm_valid.sum()), lm_slots_used=int(slam.map.n_lm),
        n_tracked=len(tracked), keyframes_inserted=n_ins,
        compactions=compactions, fuse_launches=fuse_deltas,
        launches=launches,
        frame_ms=statistics.median(plain_ms) if plain_ms else None,
        keyframe_frame_ms=statistics.median(kf_ms) if kf_ms else None,
        insert_ms=statistics.median(insert_ms) if insert_ms else None,
        init_frame_ms=frame_ms[init_at] if tracked else None,
        frame_ms_tail=tail_stats(frame_ms))
    print(f"{label}: init at frame {init_at}, {out['n_kf']} keyframes "
          f"({n_ins} inserted after init), {out['n_lm']} landmarks "
          f"({out['lm_slots_used']} slots used, compact_landmarks ran "
          f"{len(compactions)} times), {len(tracked)} tracked")
    print(f"{label}: median frame {out['frame_ms']} ms without keyframe, "
          f"{out['keyframe_frame_ms']} ms with a keyframe insertion "
          f"(insertion alone {out['insert_ms']} ms), initializing frame "
          f"{out['init_frame_ms']} ms; launches {launches}, fuse launches "
          f"{fuse_deltas}")
    require(slam.get_tracking_state() == sysm.TrackingState.OK,
            f"{label}: System ends in state {slam.get_tracking_state().name}")
    require(n_ins >= 1 and len(fuse_deltas) == n_ins
            and all(d == 1 for d in fuse_deltas),
            f"{label}: SearchAndFuse match kernel launches {fuse_deltas} for "
            f"{n_ins} keyframe insertions")
    # tracking's own calls: 2 or 3 per tracked frame after the first
    n_track_calls = launches["fused_match"] - sum(fuse_deltas)
    require(n_track_calls >= 2 * (len(tracked) - 1),
            f"{label}: {n_track_calls} tracking match launches")
    require(launches["pose_opt_fused"] == 2 * (len(tracked) - 1),
            f"{label}: pose kernel launched {launches['pose_opt_fused']} "
            f"times for {len(tracked)} tracked frames")
    return out


def run_system(dev, record):
    """System.track_monocular from a blank map over the clip of
    `tools/system_run.py`; `record` receives the run's launch counts.
    Returns a dict of the results. Every check raises PhaseError."""
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    imgs, R_gt, t_gt, ts = sr.render()
    slam = sr.make_system(dev)
    out = drive(slam, lambda k: slam.track_monocular(imgs[k], float(ts[k])),
                sr.N_FRAMES, "system")
    ate = sr.ate(slam, slam.get_frame_trajectory(), R_gt, t_gt)
    ate_raw = sr.ate(slam, slam.get_trajectory(), R_gt, t_gt)
    # the System's own clock around each track_monocular call (phase 11
    # reads the same one in its replays)
    out.update(ate_m=ate, ate_raw_m=ate_raw, track_ms_median=statistics.median(
        r["ms"] for r in slam.tracking_log), map_cloud=slam.get_map_pcl())
    print(f"system: ATE {ate:.4f} m (raw {ate_raw:.4f} m), median "
          f"track_monocular {out['track_ms_median']:.3f} ms (tracking log)")
    require(out["n_tracked"] > MIN_TRACKED,
            f"only {out['n_tracked']} tracked frames")
    require(out["n_kf"] >= MIN_KF, f"only {out['n_kf']} keyframes")
    require(out["n_lm"] > MIN_LM, f"only {out['n_lm']} landmarks")
    require(ate < ATE_MAX_M, f"ATE {ate:.4f} m >= {ATE_MAX_M}")
    require(ate_raw < ATE_RAW_MAX_M, f"raw ATE {ate_raw:.4f} m")
    require(out["launches"]["frontend_packed"] == sr.N_FRAMES,
            "frontend kernel not on the System path")
    add_launches(record, out["launches"])
    return out


def run_rig(dev, name, frames, record):
    """`track_stereo` / `track_rgbd` from a blank map over `frames`, the
    clip of the `tools/system_run.py` rig `name`, held to the bounds of the
    JAX e2e test it mirrors; `record` receives the run's launch counts.
    Returns a dict of the results. Every check raises PhaseError."""
    from orb_slam3_ros2_tpu_torch.runtime import system as sysm
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    rig = sr.RIGS[name]
    slam = sr.make_rig_system(rig, dev)
    out = dict(config=name, source=rig.source, frames=rig.n_frames,
               width=slam.cam.width, height=slam.cam.height,
               n_features=slam.ex_cfg.n_features)
    out.update(drive(slam, lambda k: sr.track_rig(slam, rig, frames, k),
                     rig.n_frames, name))
    metrics = sr.rig_metrics(slam, frames[2], frames[3])
    out.update(metrics)
    print(f"{name}: ATE {metrics['ate_m']} m, length ratio "
          f"{metrics['length_ratio']}")
    require(metrics["n_tracked"] > rig.min_tracked,
            f"{name}: only {metrics['n_tracked']} tracked frames")
    require(metrics["ate_m"] < rig.ate_max_m,
            f"{name}: ATE {metrics['ate_m']} m >= {rig.ate_max_m}")
    require(abs(metrics["length_ratio"] - 1.0) < rig.length_tol,
            f"{name}: length ratio {metrics['length_ratio']}")
    per_frame = 1 if rig.sensor == sysm.Sensor.RGBD else 2
    launches = out["launches"]
    require(launches["frontend_packed"] == per_frame * rig.n_frames,
            f"{name}: frontend kernel launched {launches['frontend_packed']}"
            f" times for {rig.n_frames} frames")
    add_launches(record, launches)
    return out


# ------------------------------------------------------------ phases 8-9

COUNTED = ("frontend_packed", "fused_match", "pose_opt_fused")


def _counters():
    from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused
    from orb_slam3_ros2_tpu_torch.ops import fused_match as fm
    from orb_slam3_ros2_tpu_torch.ops import frontend_packed as fp

    return (fp.frontend_pass_packed, fm.match_window,
            pose_opt_fused.optimize_pose_fused)


@contextlib.contextmanager
def recording(owner, name: str, limit: int = 4, when=None):
    """For the block, the match and pose wrappers are replaced by
    recorders that call them (so they launch and count as before) and keep
    the (args, kwargs) of their first `limit` calls made inside
    `owner.name` (a System method or a module function, wrapped for the
    block) while `when()` holds (always without it). Yields
    {"match": [...], "pose": [...]}."""
    from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused
    from orb_slam3_ros2_tpu_torch.ops import fused_match as fm

    match, pose = fm.match_window, pose_opt_fused.optimize_pose_fused
    scoped = getattr(owner, name)
    inside, calls = [False], {"match": [], "pose": []}

    def in_scope(*args, **kwargs):
        inside[0] = when is None or when()
        try:
            return scoped(*args, **kwargs)
        finally:
            inside[0] = False

    class Recorder:
        def __init__(self, kind, fn):
            self.kind, self.fn = kind, fn

        def __call__(self, *args, **kwargs):
            if inside[0] and len(calls[self.kind]) < limit:
                calls[self.kind].append((args, kwargs))
            return self.fn(*args, **kwargs)

        # the wrapper counts through its module-level name, this object
        @property
        def launches(self):
            return self.fn.launches

        @launches.setter
        def launches(self, n):
            self.fn.launches = n

    fm.match_window = Recorder("match", match)
    pose_opt_fused.optimize_pose_fused = Recorder("pose", pose)
    setattr(owner, name, in_scope)
    try:
        yield calls
    finally:
        fm.match_window, pose_opt_fused.optimize_pose_fused = match, pose
        setattr(owner, name, scoped)


def plain_pose_paths(args, kw, noise: float):
    """`pose_opt.optimize_pose`'s loop on the inputs of one call: first as
    it runs (its result, bit for bit), then once for each accept/reject
    decision whose margin |cost_c - cost| / cost is under `noise`, with
    that one decision taken the other way. Yields (label, R, t, inliers)."""
    import torch
    from orb_slam3_ros2_tpu_torch.backend import pose_opt, residuals
    from orb_slam3_ros2_tpu_torch.geom import lie
    from orb_slam3_ros2_tpu_torch.ops.chol_small import cholesky_solve_small

    R0, t0, X, uv, inv_sigma2, mask, fx, fy, cx, cy = args
    n_rounds = kw.get("n_rounds", 3)
    iters = kw.get("iters_per_round", 5)
    chi2_th = kw.get("chi2_th", residuals.CHI2_MONO)

    def run(flip):
        eye6 = torch.eye(6, dtype=torch.float32, device=X.device)
        lam = torch.tensor(1e-3, dtype=torch.float32, device=X.device)
        w_base = inv_sigma2 * mask.to(torch.float32)
        R, t, close, step = R0, t0, [], 0
        chi2v = torch.zeros_like(inv_sigma2)
        posv = torch.ones_like(inv_sigma2, dtype=torch.bool)
        for rnd in range(n_rounds):
            w_active = w_base if rnd == 0 else w_base * (
                (chi2v <= chi2_th) & posv & mask)
            H, b, cost, chi2v, posv = pose_opt._eval_system(
                R, t, X, uv, inv_sigma2, w_active, fx, fy, cx, cy)
            for _ in range(iters):
                Hd = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye6
                R_c, t_c = lie.se3_retract(R, t,
                                           -cholesky_solve_small(Hd, b))
                R_c = lie.se3_normalize(R_c)
                H_c, b_c, cost_c, chi2_c, pos_c = pose_opt._eval_system(
                    R_c, t_c, X, uv, inv_sigma2, w_active, fx, fy, cx, cy)
                margin = abs(float(cost_c - cost)) / float(cost)
                if margin < noise:
                    close.append((step, margin))
                better = (cost_c < cost) ^ (step == flip)
                step += 1
                R, t = torch.where(better, R_c, R), torch.where(better, t_c, t)
                H, b = torch.where(better, H_c, H), torch.where(better, b_c, b)
                cost = torch.where(better, cost_c, cost)
                chi2v = torch.where(better, chi2_c, chi2v)
                posv = torch.where(better, pos_c, posv)
                lam = torch.where(better, lam * 0.5, lam * 4.0).clamp(
                    1e-7, 1e2)
        return R, t, (chi2v <= chi2_th) & posv & mask, close

    R, t, inl, close = run(-1)
    ref = pose_opt.optimize_pose(*args, **kw)
    require(torch.equal(R, ref.R) and torch.equal(t, ref.t),
            "plain_pose_paths: the copied loop differs from optimize_pose")
    yield "plain", R, t, inl
    for step, margin in close:
        R, t, inl, _ = run(step)
        yield (f"plain with decision {step} flipped (margin {margin:.2e})",
               R, t, inl)


def check_recorded(calls, label: str, decision_noise=None) -> list:
    """Each recorded match call against `match_window_ref` (exact) and each
    recorded pose call against `pose_opt.optimize_pose` (RECORDED_POSE_*),
    on the same inputs; these launches come after the counts are read.
    With `decision_noise`, a pose call may instead agree (to the same
    tolerances) with the plain path that takes one decision inside that
    noise the other way (`plain_pose_paths`). Returns one line per call."""
    import torch
    from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused
    from orb_slam3_ros2_tpu_torch.ops import fused_match as fm

    checked = []
    for args, kw in calls["match"]:
        got = fm.match_window(*args, **kw)
        ref = fm.match_window_ref(*args, **kw)
        v = ref.valid
        require(torch.equal(got.idx, ref.idx) and torch.equal(got.valid, v)
                and torch.equal(got.dist[v], ref.dist[v]),
                f"{label}: match at {kw['radius']} px differs from its "
                f"plain version")
        checked.append(f"match {args[0].shape[0]}x{args[3].shape[0]} at "
                       f"{kw['radius']:g} px: {int(v.sum())} matches")
    for args, kw in calls["pose"]:
        got = pose_opt_fused.optimize_pose_fused(*args, **kw)
        paths = plain_pose_paths(args, kw, decision_noise or 0.0)
        seen = []
        for name, R, t, inl in paths:
            dR = (got.R - R).abs().max().item()
            dt = (got.t - t).abs().max().item()
            flips = int((got.inliers != inl).sum())
            seen.append(f"{name}: dR {dR:.2e}, dt {dt:.2e}, {flips} flips")
            if (dR <= RECORDED_POSE_DR and dt <= RECORDED_POSE_DT
                    and flips <= RECORDED_POSE_INLIER_FLIPS):
                break
        else:
            require(False, f"{label}: pose kernel vs plain ({kw}): {seen}")
        checked.append(f"pose N={args[2].shape[0]} ({int(args[5].sum())} "
                       f"matched, {kw or 'defaults'}): {'; '.join(seen)}")
    return checked


def run_reloc(dev, record):
    """Phase 8 through `system_run.run_reloc`, with every kernel counter
    from 0 around it; the match and pose calls made inside `_relocalize`
    (the first four of each) are recorded and, after the counts are read,
    held against their plain versions. Every bar raises PhaseError."""
    from orb_slam3_ros2_tpu_torch.runtime import system as sysm
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    t_render = time.perf_counter()
    frames = sr.render_euroc_distorted()
    print(f"euroc_reloc: rendered the distorted clip in "
          f"{time.perf_counter() - t_render:.2f} s")
    for fn in _counters():
        fn.launches = 0
    with recording(sysm.System, "_relocalize") as calls:
        r = sr.run_reloc(dev, frames)
    launches = dict(zip(COUNTED, (fn.launches for fn in _counters())))
    r["launches"] = launches
    a, c, d = r["blackout"], r["reload"], r["new_map"]
    print(f"euroc_reloc: init at frame {r['init_frame']}, {r['n_kf']} "
          f"keyframes, {r['n_tracked']} tracked, ATE {r['ate_m']:.4f} m, "
          f"median frame {r['median_frame_ms']:.2f} ms; launches {launches}")
    print(f"euroc_reloc: blackout -> {a['state']} in map {a['active']} of "
          f"{a['n_maps']}, centre {a['centre_err_m']:.4f} m off, "
          f"{a['frame']['ms']:.2f} ms; blank -> {r['blank']['state']} "
          f"({r['blank']['frame']['ms']:.2f} ms); reload -> {c['state']} "
          f"after {c['frames_to_recover']} frames; new map after "
          f"{d['lost_frames']} lost frames -> {d['n_maps']} maps (map 0 "
          f"{d['map0_n_kf']} keyframes); fresh copy after "
          f"{r['restart']['lost_frames']} lost frames -> "
          f"{r['restart']['n_maps']} maps, {r['restart']['state']}")
    print(f"euroc_reloc: ms per lost frame {r['lost_frame_ms']}, launches "
          f"in the lost frames {r['lost_launches']}")
    failed = sr.reloc_failures(r)
    require(not failed, f"euroc_reloc: {failed}")
    require(r["lost_launches"]["match"] >= 1
            and r["lost_launches"]["pose"] >= 1,
            f"euroc_reloc: lost frames launched {r['lost_launches']}")
    require(calls["match"] and calls["pose"],
            "euroc_reloc: no relocalization match or pose call recorded")
    checked = check_recorded(calls, "euroc_reloc")
    print(f"euroc_reloc: kernels against their plain versions on the "
          f"recorded relocalization inputs: {checked}")
    r["checked"] = checked
    add_launches(record, launches)
    return r


def run_loopy(dev, record):
    """Phase 9: the synth_loopy clip with loop closing on, then off, each
    run with every kernel counter from 0 around it; in the run with loop
    closing on, the match and pose calls of a merge's PnP refinement
    (`merging.refine_weld_pnp`) are recorded and held against their plain
    versions after the counts are read. Every bar raises PhaseError."""
    from orb_slam3_ros2_tpu_torch.atlas import merging
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    t_render = time.perf_counter()
    frames = sr.render_loopy()
    print(f"synth_loopy: rendered {len(frames[0])} frames in "
          f"{time.perf_counter() - t_render:.2f} s")
    out = {}
    for on in (True, False):
        for fn in _counters():
            fn.launches = 0
        with (recording(merging, "refine_weld_pnp") if on
              else contextlib.nullcontext()) as calls:
            r, slam = sr.run_loopy(dev, frames, on)
        r["launches"] = dict(zip(COUNTED,
                                 (fn.launches for fn in _counters())))
        add_launches(record, r["launches"])
        tag = "on" if on else "off"
        print(f"synth_loopy (loop closing {tag}): ATE {r['ate_m']:.4f} m, "
              f"{r['n_tracked']}/{r['frames']} tracked, {r['loops_closed']} "
              f"loops closed, {r['maps_merged']} maps merged, {r['n_maps']} "
              f"maps, {r['n_kf']} keyframes; median frame "
              f"{r['median_frame_ms']:.2f} ms, mean {r['mean_frame_ms']:.2f}"
              f" ms; loop/merge frames {r['events']}; launches "
              f"{r['launches']}")
        require(r["launches"]["frontend_packed"] == r["frames"],
                f"synth_loopy ({tag}): frontend kernel launched "
                f"{r['launches']['frontend_packed']} times")
        out[tag] = r
        if on:
            loop_map, merge_calls = slam.map, calls
    on, off = out["on"], out["off"]
    require(on["loops_closed"] + on["maps_merged"] >= 1,
            "synth_loopy: no loop closed and no map merged")
    require(off["loops_closed"] + off["maps_merged"] == 0,
            "synth_loopy: loop closing off still closed a loop")
    require(on["ate_m"] < off["ate_m"],
            f"synth_loopy: ATE with loop closing {on['ate_m']:.4f} m is not "
            f"below ATE without {off['ate_m']:.4f} m")
    if on["maps_merged"]:
        require(len(merge_calls["pose"]) >= 2,
                f"synth_loopy: the merge ran {len(merge_calls['pose'])} "
                f"PnP pose calls (2 expected)")
        on["checked"] = check_recorded(merge_calls, "synth_loopy merge",
                                       decision_noise=POSE_DECISION_NOISE)
        print(f"synth_loopy: kernels against their plain versions on the "
              f"recorded merge PnP inputs: {on['checked']}")
    out["global_ba"] = check_global_ba(dev, loop_map)
    return out


def run_corridor(dev, record):
    """Phase 9b: an in-map loop closure on the card, through
    `System._try_close_loop` on the corridor of the JAX loop-closing tests
    (`system_run.run_corridor_loop`: keyframe 17 starts the temporal
    consistency, keyframe 18 closes), with every kernel counter from 0
    around it; then the same run on the CPU (plain versions). Requires the
    loop closed on the second call, the seam fusion's match launches, a
    finite map and the corrected centres of keyframes 2, 17 and 18 within
    CORRIDOR_CENTRE_M of the CPU's. Every bar raises PhaseError."""
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    for fn in _counters():
        fn.launches = 0
    r, _ = sr.run_corridor_loop(dev)
    r["launches"] = dict(zip(COUNTED, (fn.launches for fn in _counters())))
    ref, _ = sr.run_corridor_loop("cpu")
    d = max(float(np.abs(np.subtract(r["centres"][k], ref["centres"][k])
                         ).max()) for k in r["centres"])
    r["centre_diff_cpu_m"] = d
    print(f"corridor loop: loops closed after keyframes 17, 18: "
          f"{r['loops_closed_after']} (CPU {ref['loops_closed_after']}); "
          f"ms of the calls {[round(x, 2) for x in r['call_ms']]}; "
          f"centres of keyframes 2/17/18 {r['centres']}, max diff from the "
          f"CPU {d:.3g} m; launches {r['launches']}")
    require(r["loops_closed_after"] == [0, 1] and r["last_loop_kf"] == 18,
            f"corridor loop: loops closed {r['loops_closed_after']}, last "
            f"loop keyframe {r['last_loop_kf']}")
    require(r["finite"], "corridor loop: non-finite map after the closure")
    require(r["launches"]["fused_match"] >= 2,
            f"corridor loop: the seam fusion launched the match kernel "
            f"{r['launches']['fused_match']} times")
    require(d <= CORRIDOR_CENTRE_M,
            f"corridor loop: centres {d} m from the CPU run's")
    add_launches(record, r["launches"])
    return r


# ----------------------------------------------------------- phase 10

def _timed(slam, name: str, out: list, profile_call: int = -1,
           traces: list = None):
    """Wrap `slam.<name>` with a host clock ending in a synchronize (its
    ms go to `out`); call number `profile_call` (from 0) is also traced
    with torch.profiler, and its summary appended to `traces`."""
    import torch
    from torch.profiler import ProfilerActivity, profile as trace
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    fn = getattr(slam, name)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if len(out) == profile_call:
            with trace(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as p:
                r = fn(*args, **kwargs)
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            traces.append(sr.profile_summary(p, wall, name, 5))
        else:
            r = fn(*args, **kwargs)
            torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        return r

    setattr(slam, name, timed)


def run_euroc_vi(dev, record):
    """Phase 10 through `drive`: `config/Monocular-Inertial/EuRoC.yaml` as
    published in IMU_MONOCULAR mode, the 120-frame clip of
    `system_run.render_euroc_vi` with its 200 Hz IMU, every kernel counter
    from 0 around the run. Times every call of the VI initialization, the
    VI local BA, the full inertial BA and the scale refinement, and traces
    the third interval's preintegration (its launches); the match and pose
    calls of the first tracked frames after the VI initialization are
    recorded and held against their plain versions. The bars of
    `system_run.vi_failures` raise PhaseError."""
    from orb_slam3_ros2_tpu_torch.runtime import system as sysm
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    t_render = time.perf_counter()
    images, R_gt, t_gt, ts, imu = frames = sr.render_euroc_vi()
    print(f"euroc_vi: rendered {len(images)} frames and "
          f"{len(imu[0])} IMU samples in "
          f"{time.perf_counter() - t_render:.2f} s")
    slam = sr.make_vi_system(dev)
    calls_ms = {k: [] for k in ("_run_vi_init", "_vi_local_ba_step",
                                "_run_inertial_gba", "_refine_scale",
                                "_finish_kf_preint")}
    traces = []
    for name, out in calls_ms.items():
        _timed(slam, name, out, 2 if name == "_finish_kf_preint" else -1,
               traces)
    init_frame = []

    def step(k):
        t_prev = float(ts[k - 1]) if k else -1.0
        T = slam.track_monocular(images[k], float(ts[k]),
                                 sr.imu_points(imu, t_prev, float(ts[k])))
        if slam.is_imu_initialized() and not init_frame:
            init_frame.append(k)
        return T

    with recording(sysm.System, "_track", limit=4,
                   when=lambda: slam.imu_initialized) as calls:
        out = drive(slam, step, len(images), "euroc_vi",
                    insert_name="_insert_keyframe_inertial")
    r = dict(config="euroc_vi", source=sr.EUROC_VI, width=slam.cam.width,
             height=slam.cam.height, n_features=slam.ex_cfg.n_features,
             frames=len(images), state=slam.get_tracking_state().name,
             vi_init_frame=init_frame[0] if init_frame else None,
             dropped_imu_samples=slam.dropped_imu_samples,
             **sr.vi_metrics(slam, R_gt, t_gt, sr.VI_TRUE_BG))
    r.update(out)
    r["call_ms"] = calls_ms
    r["preint_trace"] = traces
    r["failed_bars"] = sr.vi_failures(r)
    r["jax_cpu"] = VI_JAX_CPU
    print(f"euroc_vi: VI init at frame {r['vi_init_frame']} (JAX "
          f"{VI_JAX_CPU['vi_init_frame']}), {r['n_kf']} keyframes (JAX "
          f"{VI_JAX_CPU['n_kf']}), {r['n_tracked']} tracked, IMU initialized "
          f"{r['imu_initialized']}, BA1 {r['inertial_ba1']}, BA2 "
          f"{r['inertial_ba2']}; gyro bias error {r['bg_err']:.3g}; "
          f"after the init {r['n_post_init']} frames, Umeyama scale "
          f"{r.get('umeyama_scale')} (JAX {VI_JAX_CPU['umeyama_scale']}), "
          f"length ratio {r.get('length_ratio')} (JAX "
          f"{VI_JAX_CPU['length_ratio']}); ATE {r.get('ate_m')} m (JAX "
          f"{VI_JAX_CPU['ate_m']}), end scale error "
          f"{r.get('scale_err_end')} (JAX {VI_JAX_CPU['scale_err_end']}); "
          f"dropped IMU samples {r['dropped_imu_samples']}")
    print(f"euroc_vi: ms of the calls: " + "; ".join(
        f"{k.strip('_')} {[round(x, 2) for x in v]}"
        for k, v in calls_ms.items()))
    for t in traces:
        print(f"euroc_vi: one interval's preintegration: {t['wall_ms']:.2f}"
              f" ms wall, {t['device_ms']:.3f} ms device, "
              f"{t['kernel_launches']} kernel launches")
    require(not r["failed_bars"], f"euroc_vi: {r['failed_bars']}")
    require(r["launches"]["frontend_packed"] == len(images),
            "euroc_vi: frontend kernel not once per frame")
    require(calls["match"] and calls["pose"],
            "euroc_vi: no match or pose call recorded after the VI init")
    r["checked"] = check_recorded(calls, "euroc_vi")
    print(f"euroc_vi: kernels against their plain versions on the recorded "
          f"tracking inputs after the VI init: {r['checked']}")
    add_launches(record, r["launches"])
    return r


def run_vi_rigs(dev, record):
    """Phase 10b: IMU_STEREO and IMU_RGBD on the clips of the JAX e2e
    tests through `drive`, each with every kernel counter from 0, held to
    the tests' bounds (`system_run.vi_rig_metrics`); the stereo clip's
    length ratio to the JAX System's on the card's feature sets
    (`STEREO_VI_LENGTH_JAX_CARD`), which the run's feature sets must be."""
    import dataclasses

    from orb_slam3_ros2_tpu_torch.runtime import system as sysm
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr
    from orb_slam3_ros2_tpu_torch.tools import vi_rig_diff

    out = {}
    for name, rig in sr.VI_RIGS.items():
        frames = sr.render_vi_rig(rig)
        slam = sr.make_vi_rig_system(rig, dev)
        stereo = rig.sensor == sysm.Sensor.IMU_STEREO
        calls = []
        if stereo:
            vi_rig_diff.record_features(slam, calls)
        r = drive(slam, lambda k: sr.track_vi_rig(slam, rig, frames, k),
                  rig.n_frames, name,
                  insert_name="_insert_keyframe_inertial")
        if stereo:
            ref = np.load(ROOT / STEREO_VI_CARD_FEATURES)
            same = sum(all(np.array_equal(c[k], ref[k][i])
                           for k in vi_rig_diff.FEATURE_FIELDS)
                       for i, c in enumerate(calls))
            print(f"{name}: {same} of {len(calls)} feature sets equal "
                  f"those of {STEREO_VI_CARD_FEATURES}")
            require(same == len(calls) == len(ref["mask"]),
                    f"{name}: the card's feature sets are not those the "
                    f"JAX System's length ratio {STEREO_VI_LENGTH_JAX_CARD} "
                    f"was read on")
            rig = dataclasses.replace(
                rig, length_tol=STEREO_VI_LENGTH_JAX_CARD - 1.0)
        r.update(sr.vi_rig_metrics(slam, rig, frames[2], frames[3]))
        r["jax_cpu"] = jax = VI_RIGS_JAX_CPU[name]
        print(f"{name}: IMU initialized {r['imu_initialized']}, gyro bias "
              f"error {r['bg_err']:.3g} (JAX {jax['bg_err']}, bar "
              f"{rig.bg_tol}), ATE {r.get('ate_m')} m (JAX {jax['ate_m']}), "
              f"length ratio {r.get('length_ratio')} (JAX "
              f"{jax['length_ratio']}"
              + (f"; on the card's feature sets {STEREO_VI_LENGTH_JAX_CARD}"
                 if stereo else "")
              + f", bar 1 +- {rig.length_tol:.6g}), {r['n_kf']} keyframes")
        require(not r["failed_bars"], f"{name}: {r['failed_bars']}")
        per_frame = 2 if stereo else 1
        require(r["launches"]["frontend_packed"] == per_frame * rig.n_frames,
                f"{name}: frontend kernel launched "
                f"{r['launches']['frontend_packed']} times")
        add_launches(record, r["launches"])
        out[name] = r
    return out


# ----------------------------------------------------------- phase 11

def replay(argv, label: str):
    """`tools/run_slam.main(argv)` on the card with the three kernels'
    launch counters from 0; the runner's printed report is kept out of
    this script's output. Returns (report, session, launches, summary)."""
    import torch
    from orb_slam3_ros2_tpu_torch.runtime import outputs
    from orb_slam3_ros2_tpu_torch.tools import run_slam

    counters = _counters()
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        report, sess = run_slam.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(COUNTED, (fn.launches for fn in counters)))
    slam = sess.system
    n = report["frames"]
    stages = report["stages"]
    summary = dict(
        frames=n, wall_s=wall, loop_ms_per_frame=1e3 / report["fps"],
        track_ms_median=statistics.median(r["ms"] for r in slam.tracking_log),
        load_ms_median=stages["load_frame"]["p50_ms"],
        checkpoint_ms_median=stages.get("checkpoint", {}).get("p50_ms"),
        launches=launches,
        launches_per_frame={k: v / n for k, v in launches.items()},
        native_filter=outputs._native_filter() is not None,
        n_kf=int(slam.map.n_kf), n_lm=int(slam.map.lm_valid.sum()),
        stages=stages)
    print(f"{label}: {n} frames, median track {summary['track_ms_median']:.3f}"
          f" ms, median frame load {summary['load_ms_median']:.3f} ms, "
          f"median checkpoint {summary['checkpoint_ms_median']} ms, loop "
          f"{summary['loop_ms_per_frame']:.3f} ms a frame ({wall:.2f} s with "
          f"shutdown); launches a frame "
          + ", ".join(f"{k} {v:.3f}" for k, v in
                      summary["launches_per_frame"].items())
          + f"; native point-cloud filter loaded: {summary['native_filter']}")
    print(f"{label} stages: " + json.dumps(
        {k: {f: v[f] for f in ("n", "p50_ms", "total_ms")}
         for k, v in stages.items()}))
    require(launches["frontend_packed"] >= n and all(launches.values()),
            f"{label}: kernel launches {launches} for {n} frames")
    return report, sess, launches, summary


def run_replay(dev, record, system, tum1_frames):
    """Phase 11: the replay entry point over a EuRoC directory and an mcap
    bag of phase 4's clip (11a) and a TUM RGB-D directory of phase 6's
    (11b); `record` receives each run's launch counts."""
    from orb_slam3_ros2_tpu_torch.io import recording, rosbag, tum_rgbd
    from orb_slam3_ros2_tpu_torch.runtime import outputs
    from orb_slam3_ros2_tpu_torch.runtime import system as sysm
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    shutil.rmtree(REPLAY_DIR, ignore_errors=True)
    REPLAY_DIR.mkdir(parents=True)
    imgs, R_gt, t_gt, ts = sr.render()
    u8 = np.clip(imgs, 0, 255).astype(np.uint8)
    t_io = time.perf_counter()
    rec = recording.SequenceRecorder(str(REPLAY_DIR / "euroc"))
    bag = rosbag.McapWriter(str(REPLAY_DIR / "bag"))
    bag.add_topic("/cam0/image_raw", "sensor_msgs/msg/Image")
    for k in range(len(u8)):
        rec.add_frame(u8[k], float(ts[k]))
        rec.add_groundtruth(float(ts[k]), -R_gt[k].T @ t_gt[k])
        bag.write("/cam0/image_raw", float(ts[k]),
                  rosbag.encode_image(u8[k], float(ts[k])))
    rec.close()
    bag.close()
    print(f"replay: wrote {len(u8)} frames as a EuRoC directory and an mcap "
          f"bag ({Path(bag.path).stat().st_size / 1e6:.1f} MB) in "
          f"{time.perf_counter() - t_io:.2f} s")
    settings = sr.write_settings(REPLAY_DIR / "euroc.yaml")
    common = ["--settings", settings, "--output-root",
              str(REPLAY_DIR / "out"), "--checkpoint-every",
              str(REPLAY_CKPT_EVERY), "--profile"]
    require(len(u8) % REPLAY_CKPT_EVERY == 0,
            "the clip's last frame must checkpoint")
    out, traj = {}, {}
    for label, args in (("replay_dir", ["--dataset",
                                        str(REPLAY_DIR / "euroc")]),
                        ("replay_bag", ["--playback-bag",
                                        str(REPLAY_DIR / "bag")])):
        report, sess, launches, r = replay(
            common + args + ["--output-name", label], label)
        slam = sess.system
        tracked = sr.tracked_frames(slam)
        r.update(n_tracked=len(tracked),
                 ate_m=sr.ate(slam, slam.get_frame_trajectory(), R_gt, t_gt),
                 ate_raw_m=sr.ate(slam, slam.get_trajectory(), R_gt, t_gt),
                 report_ate_m=report.get("ate_rmse_m"),
                 report_kf_ate_m=report.get("kf_ate_rmse_m"))
        print(f"{label}: ATE {r['ate_m']:.4f} m (raw {r['ate_raw_m']:.4f} "
              f"m; the report's {r['report_ate_m']}), {r['n_kf']} keyframes, "
              f"{r['n_lm']} landmarks, {len(tracked)} tracked")
        require(slam.get_tracking_state() == sysm.TrackingState.OK,
                f"{label}: ends in state {slam.get_tracking_state().name}")
        require(r["n_tracked"] > MIN_TRACKED,
                f"{label}: only {r['n_tracked']} tracked frames")
        require(r["n_kf"] >= MIN_KF, f"{label}: only {r['n_kf']} keyframes")
        require(r["n_lm"] > MIN_LM, f"{label}: only {r['n_lm']} landmarks")
        require(r["ate_m"] < ATE_MAX_M, f"{label}: ATE {r['ate_m']:.4f} m")
        require(r["ate_raw_m"] < ATE_RAW_MAX_M,
                f"{label}: raw ATE {r['ate_raw_m']:.4f} m")
        art = report["artifacts"]
        cloud = outputs.load_pcd(art["pcd"])
        r["pcd_points"] = len(cloud)
        require(cloud.ndim == 2 and cloud.shape[1] == 3 and len(cloud) > 0,
                f"{label}: PCD {art['pcd']} holds {cloud.shape}")
        require(Path(art["grid"]).is_file()
                and Path(art["grid"][:-4] + ".yaml").is_file(),
                f"{label}: no PGM + YAML at {art['grid']}")
        rows = Path(art["trajectory"]).read_text().splitlines()
        require(len(rows) == len(slam.get_frame_trajectory()) == len(u8),
                f"{label}: {len(rows)} TUM rows for {len(u8)} frames")
        ckpt = Path(sess.out_dir) / "checkpoint_atlas.npz"
        loaded = sysm.System(None, settings, sysm.Sensor.MONOCULAR,
                             device=dev, load_atlas=str(ckpt))
        r["checkpoint_n_kf"] = int(loaded.map.n_kf)
        require(r["checkpoint_n_kf"] == r["n_kf"],
                f"{label}: the checkpoint loads {r['checkpoint_n_kf']} "
                f"keyframes, saved with {r['n_kf']}")
        traj[label] = (Path(art["trajectory"]).read_bytes(),
                       slam.get_frame_trajectory())
        r["phase4_track_ms_median"] = system["track_ms_median"]
        print(f"{label}: median track {r['track_ms_median']:.3f} ms against "
              f"phase 4's {system['track_ms_median']:.3f} ms in this run; "
              f"{r['pcd_points']} cloud points, {len(rows)} TUM rows, the "
              f"checkpoint loads {r['checkpoint_n_kf']} keyframes")
        add_launches(record, launches)
        out[label] = r
    (a, fa), (b, fb) = traj["replay_dir"], traj["replay_bag"]
    same = a == b and all(np.array_equal(x, y)
                          for (_, x), (_, y) in zip(fa, fb))
    print(f"replay: directory and bag trajectories equal: {same}")
    require(same, "replay: the directory and bag trajectories differ")

    # 11c: the directory's first frames again under --torch-profile: each
    # stage's kernel launches and their device time, from the trace
    # (`utils/tracing.stage_summary`)
    prof = REPLAY_DIR / "prof"
    report, sess, launches, r = replay(
        common + ["--dataset", str(REPLAY_DIR / "euroc"), "--max-frames",
                  str(REPLAY_PROFILE_FRAMES), "--torch-profile", str(prof),
                  "--output-name", "replay_profile"], "replay_profile")
    st = json.loads((prof / "stages.json").read_text())
    whole = st.pop("_trace")
    r["torch_profile"] = dict(st, _trace=whole)
    per_call = {k: {"n": v["n"], "launches": v["launches"] / v["n"],
                    "host_ms": v["host_ms"] / v["n"],
                    "device_ms": v["device_ms"] / v["n"]}
                for k, v in st.items()}
    print("replay_profile stages (a call; launches by their host time): "
          + json.dumps(per_call))
    print(f"replay_profile: {whole['launches']} launches in "
          f"{whole['window_ms']:.3f} ms traced, device busy "
          f"{whole['device_busy_ms']:.3f} ms "
          f"({100 * whole['device_busy_ms'] / whole['window_ms']:.2f}%)")
    ex = st.get("extract", {})
    require(ex.get("n") == REPLAY_PROFILE_FRAMES and ex["launches"] > 0
            and ex["device_ms"] > 0 and whole["device_busy_ms"] > 0,
            f"replay_profile: the trace shows no device work in extract "
            f"({ex}, {whole})")
    add_launches(record, launches)
    out["replay_profile"] = r

    # 11b: phase 6's clip in the TUM RGB-D layout
    rig = sr.RIGS["tum1_rgbd"]
    images, depths, R1, t1, ts1 = tum1_frames
    centres = np.stack([-R1[k].T @ t1[k] for k in range(len(ts1))])
    root = tum_rgbd.write_sequence(str(REPLAY_DIR / "tum1"), images, depths,
                                   ts1, centres)
    spath = REPLAY_DIR / "tum1.yaml"
    spath.write_text(rig.settings())
    report, sess, launches, r = replay(
        ["--settings", str(spath), "--mode", "rgbd", "--dataset", root,
         "--output-root", str(REPLAY_DIR / "out"), "--output-name",
         "replay_tum1", "--profile"], "replay_tum1")
    slam = sess.system
    r.update(sr.rig_metrics(slam, R1, t1), report_ate_m=report.get(
        "ate_rmse_m"))
    print(f"replay_tum1: ATE {r['ate_m']} m, length ratio "
          f"{r['length_ratio']}, {r['n_tracked']} tracked, {r['n_kf']} "
          f"keyframes (phase 6: {rig.ate_max_m} m, 1 +- {rig.length_tol})")
    require(r["n_tracked"] > rig.min_tracked,
            f"replay_tum1: only {r['n_tracked']} tracked frames")
    require(r["ate_m"] < rig.ate_max_m, f"replay_tum1: ATE {r['ate_m']} m")
    require(abs(r["length_ratio"] - 1.0) < rig.length_tol,
            f"replay_tum1: length ratio {r['length_ratio']}")
    require(launches["frontend_packed"] == len(ts1),
            f"replay_tum1: frontend kernel launched "
            f"{launches['frontend_packed']} times for {len(ts1)} frames")
    add_launches(record, launches)
    out["replay_tum1"] = r
    return out


def check_global_ba(dev, m):
    """`tracking.global_ba` as `System._run_global_ba` runs it (the live
    keyframes padded to a power of 2, keyframe 0 fixed, 8 iterations) on
    the map `m` that phase 9's loop-closing run ends with: its peak device
    memory with the map at its capacity of keyframes and with the keyframe
    arrays cut to the window (equal: the memory follows the window, not
    `max_kf`), and the time and peak memory of the widest window, 256
    keyframes (the map's keyframes repeated into every slot). The first
    solve of a window's shape captures its stages' CUDA graphs, whose
    memory stays for every later solve of that shape (`backend/
    stage_graphs.py`), so a solve of the cut map runs first and both
    measured solves find the window's graphs captured; a solve whose arrays
    followed `max_kf` would have another shape, and capture anew inside
    its measurement. Returns the measurements."""
    import torch
    from orb_slam3_ros2_tpu_torch.frontend import tracking as trk

    cam = (FX_LOOPY, FX_LOOPY, 320.0, 240.0)
    n_kf = int(m.n_kf)
    K = m.kf_valid.shape[0]
    B = trk.global_ba_window(n_kf, K, dev)[0].shape[0]

    def peak(mm, n_live):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = trk.global_ba(mm, n_live, *cam, n_iters=8)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        require(bool(torch.isfinite(out.kf_t).all()
                     and torch.isfinite(out.lm_X).all()),
                f"global BA over {n_live} keyframes: non-finite map")
        return (torch.cuda.max_memory_allocated() - base) / 2**20, ms

    cut = m._replace(**{f: getattr(m, f)[:B] for f in m._fields
                        if f.startswith("kf_")})
    for _ in range(2):  # the window's graphs: all but the refresh, then it
        trk.global_ba(cut, n_kf, *cam, n_iters=8)
    full_mib, full_ms = peak(m, n_kf)
    cut_mib, cut_ms = peak(cut, n_kf)
    rep = torch.arange(K, device=dev) % n_kf
    wide = m._replace(**{f: getattr(m, f)[rep] for f in m._fields
                         if f.startswith("kf_")})
    wide = wide._replace(n_kf=torch.tensor(K, dtype=torch.int32, device=dev))
    wide_mib, wide_ms = peak(wide, K)
    out = dict(n_kf=n_kf, window=B, max_kf=K, peak_mib=full_mib,
               peak_mib_cut_to_window=cut_mib, ms=full_ms,
               window_256_ms=wide_ms, window_256_peak_mib=wide_mib)
    print(f"global BA: {n_kf} keyframes in a window of {B}: peak "
          f"{full_mib:.1f} MiB with {K} keyframe slots, {cut_mib:.1f} MiB "
          f"with {B}; {full_ms:.1f} ms; a window of {K}: {wide_ms:.1f} ms, "
          f"peak {wide_mib:.1f} MiB")
    require(abs(full_mib - cut_mib) <= 0.05 * cut_mib + 1.0,
            f"global BA memory follows max_kf: {full_mib:.1f} MiB against "
            f"{cut_mib:.1f} MiB")
    return out


# ----------------------------------------------------------- phase 12

# MULTISESSION.json's numbers from the JAX package on its 8-device virtual
# CPU mesh (`scripts/multisession_demo.py`): the 48 x 16,384 BA window's
# final cost (:15) and the city pose graph's rmse after (:9)
MULTISESSION_BA_COST = 491553.28
MULTISESSION_PG_RMSE_M = 0.0198
BA_COST_REL, PG_RMSE_REL = 0.02, 0.10  # the bars against those
MESH_SHARDS = 8  # the local shards of the "8 shards on one card" runs
# the sharded solvers against the one-device ones: tests/test_multiprocess.py
# :107-109 for BA and VI BA, tests/test_sharded_pose_graph.py:103-108 for
# the pose graph, tests/test_block_ba.py:199 for the blocks
BA_R_ATOL, BA_T_ATOL, BA_COST_RTOL = 1e-4, 3e-3, 2e-2
PG_R_ATOL, PG_T_ATOL, PG_S_ATOL = 5e-4, 5e-3, 5e-4
BLOCK_T_ATOL = 1e-4
VI_THG_ATOL = 1e-3  # the solved gravity tangent against the one-device one
# 12c: the known motion of the moved map copy, and tests/test_icp_align.py's
# bars (:52-55)
ICP_ROT_DEG, ICP_T_M = 5.0, 0.2
ICP_ROT_ERR_RAD, ICP_T_ERR_M, ICP_RMS, ICP_INLIER = 0.01, 0.02, 0.02, 0.9
# 12d: the sessions' processes, and their time limit
SESSION_TIMEOUT_S = 300


@contextlib.contextmanager
def nccl_group():
    """A `torch.distributed` NCCL group of world size 1 (this process as
    rank 0), rendezvousing through a file store under build/; one
    all-reduce sets up its communicator before the timed solves."""
    import torch
    import torch.distributed as dist

    store = ROOT / "build" / f"nccl_store_{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        dist.all_reduce(torch.zeros(1, device="cuda"))
        torch.cuda.synchronize()
        yield
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def timed_solve(fn, n_iters: int, warm: bool = False):
    """(result, ms per iteration) of a call of `fn` ending in a device
    synchronize; with `warm`, after a first call as a warm-up (each
    solver's first run: its later runs share the warmed-up libraries)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3 / n_iters


def _max_diff(a, b) -> float:
    return float((a - b).abs().max())


def centre_diff_in_scale(R_a, t_a, R_b, t_b):
    """Camera centres of two BA solutions with keyframe 0 fixed, compared
    after the one scale about keyframe 0's centre that the window leaves
    free (only keyframe 0 is fixed, so the solution is defined up to it).
    Returns (max centre difference in m, that scale)."""
    ca = -(R_a.transpose(1, 2) @ t_a[..., None])[..., 0]
    cb = -(R_b.transpose(1, 2) @ t_b[..., None])[..., 0]
    da, db = ca - ca[0], cb - cb[0]
    s = float((da * db).sum() / (db * db).sum())
    return float((da - s * db).abs().max()), s


def mesh_ba(dev, mm):
    """12a, the landmark-sharded BA on MULTISESSION.json's window."""
    from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod
    from orb_slam3_ros2_tpu_torch.parallel import sharded_ba
    from orb_slam3_ros2_tpu_torch.tools import multisession as msn

    p = ba_mod.BAProblem(*(f.to(dev) for f in msn.ba_window()))
    cam, n_it = msn.BA_CAMERA, 10
    # the one-device solver with the sharded solver's chi2 refresh period
    ref, ref_ms = timed_solve(lambda: ba_mod.bundle_adjust(
        p, *cam, n_iters=n_it, reclassify_every=sharded_ba.REFRESH_EVERY),
        n_it, warm=True)
    runs = {"one-device": (ref, ref_ms)}

    def sharded(mesh):
        return timed_solve(lambda: sharded_ba.make_sharded_ba(
            mesh, *cam, n_iters=n_it)(p), n_it)

    with nccl_group():
        runs["1 shard (NCCL)"] = sharded(mm.make_mesh(1, devices=[dev]))
    runs[f"{MESH_SHARDS} shards"] = sharded(
        mm.make_mesh(devices=[dev] * MESH_SHARDS))
    out = {}
    for name, (r, ms_it) in runs.items():
        d_c, s = centre_diff_in_scale(r.R, r.t, ref.R, ref.t)
        d = out[name] = dict(
            ms_per_iter=ms_it, cost=float(r.cost), dR=_max_diff(r.R, ref.R),
            dt_raw=_max_diff(r.t, ref.t), dcentre_in_scale=d_c, scale=s)
        print(f"sharded BA 48x16384, {name}: {ms_it:.3f} ms/iter, cost "
              f"{float(r.cost):.2f} (JAX CPU mesh {MULTISESSION_BA_COST}); "
              f"vs one-device: dR {d['dR']:.2e}, dt {d['dt_raw']:.2e} raw, "
              f"centres {d_c:.2e} m after scale {s:.6f}")
        require(abs(float(r.cost) - MULTISESSION_BA_COST)
                <= BA_COST_REL * MULTISESSION_BA_COST,
                f"sharded BA ({name}): cost {float(r.cost)} vs the JAX CPU "
                f"mesh's {MULTISESSION_BA_COST}")
        require(d["dR"] <= BA_R_ATOL and d_c <= BA_T_ATOL
                and abs(float(r.cost) - float(ref.cost))
                <= BA_COST_RTOL * abs(float(ref.cost)),
                f"sharded BA ({name}) vs bundle_adjust: {d}")
    return out


def mesh_pose_graph(dev, mm):
    """12a, the edge-sharded pose graph on the city graph."""
    import torch
    from orb_slam3_ros2_tpu_torch.loop import pose_graph as pg
    from orb_slam3_ros2_tpu_torch.parallel import sharded_pose_graph as spg
    from orb_slam3_ros2_tpu_torch.tools import multisession as msn

    (R0, t0, s0, ei, ej, Rm, tm, sm, fixed, Rg, tg,
     n_cross) = msn.build_city_graph()
    K, n_it = len(R0), 15

    def args(n):
        ei2, ej2, Rm2, tm2, sm2, valid = msn.pad_edges(n, ei, ej, Rm, tm, sm)
        return tuple(torch.as_tensor(np.asarray(a), device=dev) for a in (
            R0, t0, s0, ei2.astype(np.int32), ej2.astype(np.int32), Rm2,
            tm2, sm2, valid, fixed))

    a1, a8 = args(1), args(MESH_SHARDS)
    ref, ref_ms = timed_solve(
        lambda: pg.optimize_pose_graph(*a1, n_iters=n_it), n_it, warm=True)
    runs = {"replicated": (ref, ref_ms)}

    def sharded(mesh, a):
        return timed_solve(lambda: spg.make_sharded_pose_graph(
            mesh, K, n_iters=n_it)(*a), n_it)

    with nccl_group():
        runs["1 shard (NCCL)"] = sharded(mm.make_mesh(1, devices=[dev]), a1)
    runs[f"{MESH_SHARDS} shards"] = sharded(
        mm.make_mesh(devices=[dev] * MESH_SHARDS), a8)
    rmse0 = msn.centers_rmse(R0, t0 / s0[:, None], Rg, tg)
    out = dict(keyframes=K, edges=len(ei), cross_session_edges=n_cross,
               rmse_before_m=rmse0)
    for name, (r, ms_it) in runs.items():
        rmse = msn.centers_rmse(r.R.cpu().numpy(),
                                (r.t / r.s[:, None]).cpu().numpy(), Rg, tg)
        d = dict(ms_per_iter=ms_it, rmse_after_m=rmse,
                 dR=_max_diff(r.R, ref.R), dt=_max_diff(r.t, ref.t),
                 ds=_max_diff(r.s, ref.s))
        out[name] = d
        print(f"sharded pose graph {K} kf / {len(ei)} edges, {name}: "
              f"{ms_it:.3f} ms/iter, rmse {rmse0:.4f} -> {rmse:.5f} m (JAX "
              f"CPU mesh {MULTISESSION_PG_RMSE_M}); vs replicated dR "
              f"{d['dR']:.2e} dt {d['dt']:.2e} ds {d['ds']:.2e}")
        require(abs(rmse - MULTISESSION_PG_RMSE_M)
                <= PG_RMSE_REL * MULTISESSION_PG_RMSE_M,
                f"pose graph ({name}): rmse {rmse} against "
                f"{MULTISESSION_PG_RMSE_M}")
        require(d["dR"] <= PG_R_ATOL and d["dt"] <= PG_T_ATOL
                and d["ds"] <= PG_S_ATOL,
                f"sharded pose graph ({name}) vs replicated: {d}")
    return out


def vi_clip(dev, K=6, L=16 * MESH_SHARDS, seed=11):
    """tests/test_sharded_vi_ba.py's clip (`_vi_problem`), built with the
    port's synthetic scene, IMU and preintegration."""
    import torch
    from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod
    from orb_slam3_ros2_tpu_torch.geom import lie
    from orb_slam3_ros2_tpu_torch.imu import preintegration as pre_mod
    from orb_slam3_ros2_tpu_torch.io import synthetic

    sc = synthetic.make_scene(n_frames=K, n_points=L, noise_px=0.3, seed=seed,
                              fps=2.0)
    traj = synthetic.default_trajectory(seed=seed + 1)
    ts = sc.timestamps
    true_bg = np.array([0.015, -0.01, 0.02])
    f32 = torch.float32
    pres = []
    for i in range(K - 1):
        _, gyro, acc = synthetic.make_imu(
            traj, ts[i], ts[i + 1], rate=200.0, gyro_bias=true_bg,
            gyro_noise=1e-4, acc_noise=1e-3, seed=i)
        n = len(gyro)
        pres.append(pre_mod.preintegrate(
            torch.as_tensor(gyro, dtype=f32, device=dev),
            torch.as_tensor(acc, dtype=f32, device=dev),
            torch.full((n,), 1.0 / 200.0, dtype=f32, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev)))
    pres = pre_mod.stack(pres)
    h = 1e-4
    v_gt = np.stack([(traj.position(t + h) - traj.position(t - h)) / (2 * h)
                     for t in ts])
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.015, (K, 6)).astype(np.float32)
    xi[0] = 0.0

    def T(a):
        return torch.as_tensor(np.asarray(a), dtype=f32, device=dev)

    R0, t0 = lie.se3_retract(T(sc.R_cw), T(sc.t_cw), T(xi))
    X0 = T(sc.X + rng.normal(0, 0.04, sc.X.shape))
    v_init = T(v_gt + rng.normal(0, 0.1, v_gt.shape))
    fixed = torch.zeros(K, dtype=torch.bool, device=dev)
    fixed[0] = True
    p = ba_mod.BAProblem(R=R0, t=t0, X=X0, uv=T(sc.uv), w=T(sc.vis),
                         fixed=fixed,
                         point_valid=torch.ones(L, dtype=torch.bool,
                                                device=dev))
    return sc, p, pres, v_init, v_gt, true_bg


def mesh_vi_ba(dev, mm):
    """12a, the sharded VI BA on tests/test_sharded_vi_ba.py's clip, with
    the gravity direction fixed (that test's run) and optimized."""
    import torch
    from orb_slam3_ros2_tpu_torch.backend import vi_ba
    from orb_slam3_ros2_tpu_torch.parallel import sharded_vi_ba as svi

    sc, p, pres, v_init, v_gt, true_bg = vi_clip(dev)
    cam, n_it = (sc.fx, sc.fy, sc.cx, sc.cy), 10
    pri = dict(prior_bg=1e1, prior_ba=1e0)  # test_sharded_vi_ba.py:60
    z = torch.zeros(3, device=dev)
    err0 = float(np.linalg.norm(p.t.cpu().numpy() - sc.t_cw, axis=-1).mean())
    out = {}
    for grav in (False, True):
        ref, ref_ms = timed_solve(lambda: vi_ba.vi_bundle_adjust(
            p, pres, v_init, z, z, *cam, n_iters=n_it, opt_gravity=grav,
            **pri), n_it, warm=not grav)
        runs = {"one-device": (ref, ref_ms)}

        def sharded(mesh):
            return timed_solve(lambda: svi.make_sharded_vi_ba(
                mesh, *cam, n_iters=n_it, opt_gravity=grav, **pri)(
                    p, pres, v_init, z, z), n_it)

        with nccl_group():
            runs["1 shard (NCCL)"] = sharded(mm.make_mesh(1, devices=[dev]))
        runs[f"{MESH_SHARDS} shards"] = sharded(
            mm.make_mesh(devices=[dev] * MESH_SHARDS))
        tag = "gravity optimized" if grav else "gravity fixed"
        for name, (r, ms_it) in runs.items():
            t_err = float(np.linalg.norm(r.t.cpu().numpy() - sc.t_cw,
                                         axis=-1).mean())
            v_err = float(np.linalg.norm(r.v.cpu().numpy() - v_gt,
                                         axis=-1).mean())
            bg_err = float(np.abs(r.bg.cpu().numpy() - true_bg).max())
            d = dict(ms_per_iter=ms_it, t_err=t_err, v_err=v_err,
                     bg_err=bg_err, thg=r.thg.cpu().numpy().tolist(),
                     dthg=_max_diff(r.thg, ref.thg), dR=_max_diff(r.R, ref.R),
                     dt=_max_diff(r.t, ref.t), cost=float(r.cost))
            out[f"{name}, {tag}"] = d
            print(f"sharded VI BA K=6 L={p.X.shape[0]}, {name}, {tag}: "
                  f"{ms_it:.3f} ms/iter, t err {t_err:.4f} (before "
                  f"{err0:.4f}), v err {v_err:.4f}, bg err {bg_err:.2e}, "
                  f"thg {d['thg']} (one-device "
                  f"{ref.thg.cpu().numpy().tolist()}); vs one-device dR "
                  f"{d['dR']:.2e} dt {d['dt']:.2e}")
            # tests/test_sharded_vi_ba.py:66-71
            require(np.isfinite(d["cost"]) and t_err < err0 and t_err < 2e-2
                    and v_err < 5e-2 and bg_err <= 5e-3,
                    f"sharded VI BA ({name}, {tag}): {d}")
            require(d["dR"] <= BA_R_ATOL and d["dt"] <= BA_T_ATOL
                    and abs(d["cost"] - float(ref.cost))
                    <= BA_COST_RTOL * abs(float(ref.cost)),
                    f"sharded VI BA ({name}, {tag}) vs one-device: {d}")
            if grav:
                require(float(r.thg.abs().max()) > 0.0
                        and d["dthg"] <= VI_THG_ATOL,
                        f"sharded VI BA ({name}): thg {d['thg']} vs the "
                        f"one-device {ref.thg.cpu().numpy().tolist()}")
    return out


def block_problems(dev, B=4, K=6, L=64):
    """tests/test_block_ba.py's four map blocks (`_one_problem`)."""
    import torch
    from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod
    from orb_slam3_ros2_tpu_torch.geom import lie
    from orb_slam3_ros2_tpu_torch.io import synthetic

    scenes, probs = [], []
    for seed in range(B):
        sc = synthetic.make_scene(n_frames=K, n_points=L, noise_px=0.3,
                                  seed=seed, fps=2.0)
        rng = np.random.default_rng(seed)
        xi = rng.normal(0, 0.02, (K, 6)).astype(np.float32)
        xi[:2] = 0.0

        def T(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=dev)

        R0, t0 = lie.se3_retract(T(sc.R_cw), T(sc.t_cw), T(xi))
        fixed = torch.zeros(K, dtype=torch.bool, device=dev)
        fixed[:2] = True
        scenes.append(sc)
        probs.append(ba_mod.BAProblem(
            R=R0, t=t0, X=T(sc.X + rng.normal(0, 0.05, sc.X.shape)),
            uv=T(sc.uv), w=T(sc.vis), fixed=fixed,
            point_valid=torch.ones(L, dtype=torch.bool, device=dev)))
    return scenes, probs


def mesh_block_ba(dev, mm):
    """12a, the block x landmark BA on a (kf, lm) = (2, 4) mesh of 8
    shards, each block against the 1-D solver over 4 shards alone."""
    import torch
    from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod
    from orb_slam3_ros2_tpu_torch.parallel import block_ba, sharded_ba

    scenes, probs = block_problems(dev)
    sc0, n_it = scenes[0], 10
    cam = (sc0.fx, sc0.fy, sc0.cx, sc0.cy)
    batched = ba_mod.BAProblem(*(torch.stack(f) for f in zip(*probs)))
    m2d = mm.make_mesh(MESH_SHARDS, axis_names=(mm.KF_AXIS, mm.LM_AXIS),
                       devices=[dev] * MESH_SHARDS)
    out_b, ms_it = timed_solve(lambda: block_ba.make_block_sharded_ba(
        m2d, *cam, n_iters=n_it)(block_ba.shard_block_problem(batched, m2d)),
        n_it, warm=True)
    m4 = mm.make_mesh(devices=[dev] * 4)
    errs, diffs = [], []
    for b, (sc, p) in enumerate(zip(scenes, probs)):
        one = sharded_ba.make_sharded_ba(m4, *cam, n_iters=n_it)(p)
        diffs.append(_max_diff(out_b.t[b], one.t))
        errs.append(float(np.linalg.norm(out_b.t[b].cpu().numpy() - sc.t_cw,
                                         axis=-1).mean()))
    out = dict(mesh=m2d.shape, ms_per_iter=ms_it, t_err=errs,
               dt_vs_per_block=diffs)
    print(f"block BA {len(probs)} blocks on {m2d.shape}: {ms_it:.3f} "
          f"ms/iter, t err {[round(e, 5) for e in errs]}, vs the per-block "
          f"solver dt {[f'{d:.1e}' for d in diffs]}")
    require(bool(torch.isfinite(out_b.cost).all()),
            "block BA: non-finite cost")
    require(max(diffs) <= BLOCK_T_ATOL and max(errs) < 8e-3,
            f"block BA: {out}")
    return out


def mesh_corridor(dev, mm, record, corridor):
    """12b: phase 9b's corridor loop with the System's global BA over a
    mesh of one shard on the NCCL group, every kernel counter from 0
    around it; the match and pose calls of the loop closure are recorded
    and held against their plain versions after the counts are read."""
    from orb_slam3_ros2_tpu_torch.runtime import system as sysm
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    for fn in _counters():
        fn.launches = 0
    with nccl_group(), recording(sysm.System, "_try_close_loop") as calls:
        r, _ = sr.run_corridor_loop(dev, mesh=mm.make_mesh(1, devices=[dev]))
    r["launches"] = dict(zip(COUNTED, (fn.launches for fn in _counters())))
    d = max(float(np.abs(np.subtract(r["centres"][k],
                                     corridor["centres"][k])).max())
            for k in r["centres"])
    r["centre_diff_no_mesh_m"] = d
    print(f"corridor loop over a mesh: loops closed after keyframes 17, 18: "
          f"{r['loops_closed_after']}; mesh solves {r['mesh_solves']}; ms of "
          f"the calls {[round(x, 2) for x in r['call_ms']]}; max centre diff "
          f"from phase 9b's run {d:.3g} m; launches {r['launches']}")
    require(r["loops_closed_after"] == [0, 1] and r["last_loop_kf"] == 18,
            f"corridor over a mesh: loops closed {r['loops_closed_after']}")
    require(r["mesh_solves"] >= 1, "corridor over a mesh: no mesh solve")
    require(r["finite"], "corridor over a mesh: non-finite map")
    require(d <= CORRIDOR_CENTRE_M,
            f"corridor over a mesh: centres {d} m from phase 9b's")
    require(calls["match"], "corridor over a mesh: no match call recorded")
    r["checked"] = check_recorded(calls, "corridor over a mesh")
    print(f"corridor over a mesh: kernels against their plain versions: "
          f"{r['checked']}")
    add_launches(record, r["launches"])
    return r


def mesh_icp(dev, cloud):
    """12c: phase 4's map cloud against a copy moved by a known motion."""
    import torch
    from orb_slam3_ros2_tpu_torch.atlas import icp_align
    from orb_slam3_ros2_tpu_torch.geom import lie

    axis = np.array([0.3, -0.5, 0.8])
    axis /= np.linalg.norm(axis)
    R_gt = lie.so3_exp(torch.as_tensor(
        axis * np.deg2rad(ICP_ROT_DEG))).numpy().astype(np.float64)
    t_dir = np.array([0.6, -0.4, 0.7])
    t_gt = ICP_T_M * t_dir / np.linalg.norm(t_dir)
    src = np.asarray(cloud, np.float64)
    dst = src @ R_gt.T + t_gt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T, stats = icp_align.align_maps(src, dst, device=dev)
    ms = (time.perf_counter() - t0) * 1e3
    dR = T[:3, :3] @ R_gt.T
    rot_err = float(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1.0, 1.0)))
    t_err = float(np.linalg.norm(T[:3, 3] - t_gt))
    out = dict(points=len(src), rot_err_rad=rot_err, t_err_m=t_err,
               ms=ms, **stats)
    print(f"ICP: {len(src)} map points moved by {ICP_ROT_DEG} deg and "
          f"{ICP_T_M} m: rotation error {rot_err:.2e} rad, translation "
          f"error {t_err:.2e} m, rms {stats['rms']:.4f}, inliers "
          f"{stats['inlier_frac']:.3f}; align_maps {ms:.1f} ms")
    require(rot_err < ICP_ROT_ERR_RAD and t_err < ICP_T_ERR_M
            and stats["rms"] < ICP_RMS and stats["inlier_frac"] > ICP_INLIER,
            f"ICP: {out}")
    return out


def run_ranks(module: str, n: int, extra) -> list:
    """Start n processes of `python -m module` on the card, gloo over a
    file store under build/, wait, and return each rank's report (its last
    JSON line). Every process is stopped before this returns."""
    work = ROOT / "build" / f"session_{module.rsplit('.', 1)[-1]}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, "--process-id", str(r),
         "--num-processes", str(n), "--coordinator",
         f"file://{work / 'store'}", "--out", str(work / "report.json"),
         "--device", "cuda", "--backend", "gloo", *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=SESSION_TIMEOUT_S),
                         p.returncode))
    except subprocess.TimeoutExpired:
        raise PhaseError(f"{module}: ranks past {SESSION_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for r, ((out, err), rc) in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        require(rc == 0 and lines, f"{module} rank {r} failed (rc {rc}):\n"
                f"{out[-2000:]}\n{err[-3000:]}")
        reports.append(json.loads(lines[-1]))
    return reports


def mesh_sessions():
    """12d: the two-process session and the four-process live session on
    the one card (gloo, every rank on cuda:0), each rank tracking with the
    kernels; tests/test_distributed_session.py's and test_live_session.py's
    bars."""
    out = {}
    t0 = time.perf_counter()
    reps = run_ranks(f"{PKG}.parallel.distributed_session", 2,
                     ("--local-devices", "4"))
    out["distributed_session"] = dict(wall_s=time.perf_counter() - t0,
                                      ranks=reps)
    for r in reps:
        print(f"distributed session rank {r['process_id']}: backend "
              f"{r['backend']}, {r['global_devices']} shards, tracking "
              f"{r['track_ms_per_frame']} ms/frame, {r['n_kf_local']} local "
              f"keyframes, {r['n_kf_merged']} merged, {r['n_maps_welded']} "
              f"maps welded, keyframe ATE merged {r['kf_ate_merged_m']} m, "
              f"refined {r['kf_ate_refined_m']} m; launches {r['launches']}")
    r0 = reps[0]
    require(r0["n_maps_welded"] == 2, f"session: {r0}")
    require(r0["n_kf_merged"] > r0["n_kf_local"], f"session: {r0}")
    require(r0["kf_ate_refined_m"] < 0.08
            and r0["kf_ate_refined_m"] <= r0["kf_ate_merged_m"] + 0.01,
            f"session: keyframe ATE {r0}")
    require(len({r["kf_ate_refined_m"] for r in reps}) == 1,
            f"session: the ranks' maps differ: {reps}")
    require(all(r["launches"]["frontend_packed"] > 0 for r in reps),
            f"session: a rank did not extract with the kernel: {reps}")
    t0 = time.perf_counter()
    live = run_ranks(f"{PKG}.parallel.live_session", 4,
                     ("--local-devices", "2", "--n-frames", "100"))
    out["live_session"] = dict(wall_s=time.perf_counter() - t0, ranks=live)
    total_lm = sum(r["n_lm_local"] for r in live)
    for r in live:
        print(f"live session rank {r['process_id']}: backend {r['backend']}, "
              f"{r['global_devices']} shards, tracking "
              f"{r['track_ms_per_frame']} ms/frame, first weld at frame "
              f"{min(r['weld_frames'], default=None)} of "
              f"{r['frames_tracked']}, {r['n_edges']} edges, "
              f"{r['n_connected_hosts']} hosts connected, {r['n_lm_local']} "
              f"landmarks, global keyframe ATE {r['global_kf_ate_m']} m; "
              f"launches {r['launches']}")
        require(r["n_edges"] >= 1 and r["weld_frames"]
                and min(r["weld_frames"]) <= r["frames_tracked"] - 5,
                f"live session: no weld mid-run: {r}")
        require(r["n_connected_hosts"] == 4, f"live session: {r}")
        require(r["n_lm_local"] <= 0.5 * total_lm, f"live session: {r}")
        require(r["global_kf_ate_m"] == live[0]["global_kf_ate_m"],
                f"live session: the ranks' results differ: {live}")
    require(live[0]["global_kf_ate_m"] < 0.6, f"live session: {live[0]}")
    return out


def run_mesh(dev, record, cloud, corridor):
    """Phase 12: the sharded solvers at full width (12a), System(mesh=...)
    on phase 9b's corridor (12b), ICP on phase 4's map (12c) and the
    multi-process sessions (12d). Every bar raises PhaseError."""
    from orb_slam3_ros2_tpu_torch.parallel import mesh as mm

    t0 = time.perf_counter()
    out = dict(sharded_ba=mesh_ba(dev, mm),
               sharded_pose_graph=mesh_pose_graph(dev, mm),
               sharded_vi_ba=mesh_vi_ba(dev, mm),
               block_ba=mesh_block_ba(dev, mm),
               corridor=mesh_corridor(dev, mm, record, corridor),
               icp=mesh_icp(dev, cloud))
    out["solvers_s"] = time.perf_counter() - t0
    out.update(mesh_sessions())
    out["phase_s"] = time.perf_counter() - t0
    print(f"mesh: phase 12 took {out['phase_s']:.1f} s ({out['solvers_s']:.1f}"
          f" s before the sessions); card {card_line()}")
    return out


# ----------------------------------------------------------- phase 13

def tail_stats(ms: list) -> dict:
    """p50 / p95 / max of the second half of a run's per-call ms, and the
    calls of that half over the 33 ms frame budget."""
    tail = np.asarray(ms[len(ms) // 2:], np.float64)
    return dict(p50=float(np.percentile(tail, 50)),
                p95=float(np.percentile(tail, 95)), max=float(tail.max()),
                over_33ms=int((tail > FRAME_BUDGET_MS).sum()),
                n=int(tail.size))


def pipe_loop(slam, step, n_frames: int, label: str) -> dict:
    """Phase 13's loop: `step(k)` (one `track_monocular` call) for every
    frame with a host clock around the call and no synchronize, then one
    synchronize and the flush (`get_trajectory`). Every kernel counter
    counts from 0, `track_frame` and SearchAndFuse calls are counted, the
    dispatch half of each frame whose device pose chain is already up runs
    under `torch.cuda.set_sync_debug_mode("error")`, the rest of the call
    under "warn" (each host sync it reports is a blocking turnaround), and
    every summary read from its pinned buffer is kept beside its device
    tensor for a blocking read after the run. Raises PhaseError unless
    each pinned read equals its blocking read bit for bit, the frontend
    launched once a frame, the match kernel 3 times a tracked frame plus
    once a SearchAndFuse, and the pose kernel twice a tracked frame."""
    import warnings

    import torch
    from orb_slam3_ros2_tpu_torch.backend import pose_opt_fused
    from orb_slam3_ros2_tpu_torch.frontend import tracking as trk
    from orb_slam3_ros2_tpu_torch.ops import frontend_packed as fp
    from orb_slam3_ros2_tpu_torch.ops import fused_match as fm

    counters = (fp.frontend_pass_packed, fm.match_window,
                pose_opt_fused.optimize_pose_fused)
    track_calls, fuse_deltas, reads, checked = [], [], [], []
    track_frame, fuse = trk.track_frame, trk.fuse_map_points

    def counted_track(*args, **kwargs):
        track_calls.append(1)
        return track_frame(*args, **kwargs)

    def counted_fuse(*args, **kwargs):
        before = fm.match_window.launches
        out = fuse(*args, **kwargs)
        fuse_deltas.append(fm.match_window.launches - before)
        return out

    dispatch, read = slam._dispatch_pipelined, slam._staging.read

    def checked_dispatch(*args, **kwargs):
        if slam._chain is None:
            return dispatch(*args, **kwargs)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = dispatch(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        checked.append(1)
        return out

    def kept_read(f):
        got = read(f)
        reads.append((got, f.device))
        return got

    slam._dispatch_pipelined, slam._staging.read = checked_dispatch, kept_read
    for fn in counters:
        fn.launches = 0
    call_ms, syncs, in_flight = [], [], []
    trk.track_frame, trk.fuse_map_points = counted_track, counted_fuse
    try:
        torch.cuda.synchronize()
        for k in range(n_frames):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                try:
                    T = step(k)
                finally:
                    call_ms.append((time.perf_counter() - t0) * 1e3)
                    torch.cuda.set_sync_debug_mode(0)
            syncs.append(sum("synchroniz" in str(x.message) for x in w))
            in_flight.append(slam._pend is not None)
            require(T.shape == (4, 4) and np.isfinite(T).all(),
                    f"{label} frame {k}: non-finite pose")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traj = slam.get_trajectory()
        flush_ms = (time.perf_counter() - t0) * 1e3
    finally:
        trk.track_frame, trk.fuse_map_points = track_frame, fuse
        slam._dispatch_pipelined, slam._staging.read = dispatch, read
    launches = dict(zip(COUNTED, (fn.launches for fn in counters)))
    mismatched = [i for i, (got, dev_s) in enumerate(reads)
                  if not np.array_equal(got.view(np.uint32),
                                        dev_s.cpu().numpy().view(np.uint32))]
    n_piped = sum(in_flight)
    rep = slam.tracer.report()
    out = dict(frames=n_frames, pipelined_frames=n_piped,
               first_pipelined=in_flight.index(True) if n_piped else None,
               dispatches_checked=len(checked), summary_reads=len(reads),
               track_frame_calls=len(track_calls),
               fuse_launches=fuse_deltas, launches=launches,
               frame_ms_tail=tail_stats(call_ms),
               call_ms_pipelined_median=statistics.median(
                   [t for t, p in zip(call_ms, in_flight) if p] or [0.0]),
               flush_ms=flush_ms,
               host_syncs_per_frame=sum(syncs) / n_frames,
               summary_waits_per_frame=len(reads) / n_frames,
               host_syncs_max=max(syncs),
               stage_p50_ms={k: rep[k]["p50_ms"] for k in (
                   "frame_step", "summary_fetch", "mapping_fused",
                   "mapping_dispatch", "insert_kf") if k in rep},
               stage_n={k: v["n"] for k, v in rep.items()})
    print(f"{label}: {n_piped} of {n_frames} frames in flight after their "
          f"call (first {out['first_pipelined']}), {len(checked)} dispatch "
          f"halves under sync debug mode \"error\", {len(reads)} pinned "
          f"summary reads; per call (second half) "
          f"{_ms(out['frame_ms_tail'])}; flush {flush_ms:.3f} ms; host "
          f"syncs a frame {out['host_syncs_per_frame']:.3f} (max "
          f"{out['host_syncs_max']}) and summary waits a frame "
          f"{out['summary_waits_per_frame']:.3f}; stage medians "
          f"{out['stage_p50_ms']}; launches {launches}, track_frame calls "
          f"{len(track_calls)}, fuse launches {fuse_deltas}")
    require(len(traj) == n_frames, f"{label}: {len(traj)} records")
    # a frame whose chain was dropped rebuilds it with blocking uploads
    # and is not checked; most pipelined frames have the chain up
    require(checked and len(checked) >= n_piped // 2,
            f"{label}: {len(checked)} dispatch halves checked of {n_piped}")
    require(not mismatched, f"{label}: pinned summary reads {mismatched} "
            f"differ from their blocking reads")
    require(launches["frontend_packed"] == n_frames,
            f"{label}: frontend kernel launched "
            f"{launches['frontend_packed']} times for {n_frames} frames")
    require(fuse_deltas and all(d == 1 for d in fuse_deltas),
            f"{label}: SearchAndFuse match launches {fuse_deltas}")
    require(launches["fused_match"] == 3 * len(track_calls) + len(fuse_deltas),
            f"{label}: match kernel launched {launches['fused_match']} times "
            f"for {len(track_calls)} tracked frames and {len(fuse_deltas)} "
            f"SearchAndFuse")
    require(launches["pose_opt_fused"] == 2 * len(track_calls),
            f"{label}: pose kernel launched {launches['pose_opt_fused']} "
            f"times for {len(track_calls)} tracked frames")
    return out


def plain_loop(slam, step, n_frames: int) -> dict:
    """The per-call ms of `step(k)` over every frame, with a host clock
    around each call and no synchronize and no instrumentation, then one
    synchronize and the flush: phase 13's timing run, for the pipelined
    System and for its synchronous counterpart alike."""
    import torch

    ms = []
    torch.cuda.synchronize()
    for k in range(n_frames):
        t0 = time.perf_counter()
        step(k)
        ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    slam.get_trajectory()
    return tail_stats(ms)


def _ms(r: dict) -> str:
    return (f"p50 {r['p50']:.3f} / p95 {r['p95']:.3f} / max {r['max']:.3f} "
            f"ms, {r['over_33ms']} of {r['n']} over 33 ms")


def run_pipelined(dev, record, system, euroc_vi) -> dict:
    """Phase 13: `System(pipelined=True)` on phase 4's clip (13a, phase
    4's bars) and IMU_MONOCULAR on phase 10's (13b, `vi_failures` and the
    pipelined-frame count against the JAX System's), each through
    `pipe_loop`. Host times drift between the phases of one process, so
    the synchronous System runs the same clip beside it (`plain_loop`:
    13a synchronous, pipelined, pipelined unchecked, synchronous; 13b
    synchronous, pipelined); phases 4 and 10's numbers of this run are
    printed too. Every bar raises PhaseError."""
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    imgs, R_gt, t_gt, ts = sr.render()

    def mono_run(pipelined):
        slam = sr.make_system(dev, pipelined=pipelined)
        return slam, lambda k: slam.track_monocular(imgs[k], float(ts[k]))

    beside = dict(sync_before=plain_loop(*mono_run(False), sr.N_FRAMES))
    slam, step = mono_run(True)
    mono = pipe_loop(slam, step, sr.N_FRAMES, "pipelined mono")
    mono.update(ate_m=sr.ate(slam, slam.get_frame_trajectory(), R_gt, t_gt),
                ate_raw_m=sr.ate(slam, slam.get_trajectory(), R_gt, t_gt),
                n_kf=int(slam.map.n_kf), n_lm=int(slam.map.lm_valid.sum()),
                n_tracked=len(sr.tracked_frames(slam)),
                state=slam.get_tracking_state().name)
    beside["pipelined_unchecked"] = plain_loop(*mono_run(True), sr.N_FRAMES)
    beside["sync_after"] = plain_loop(*mono_run(False), sr.N_FRAMES)
    mono["beside"] = beside
    print(f"pipelined mono: ATE {mono['ate_m']:.4f} m (raw "
          f"{mono['ate_raw_m']:.4f} m; phase 4 {system['ate_m']:.4f} / "
          f"{system['ate_raw_m']:.4f}), {mono['n_kf']} keyframes (phase 4 "
          f"{system['n_kf']}), {mono['n_lm']} landmarks, {mono['n_tracked']}"
          f" tracked")
    print(f"pipelined mono, per call over the second half: checked run "
          f"{_ms(mono['frame_ms_tail'])}; unchecked "
          f"{_ms(beside['pipelined_unchecked'])}; the synchronous System "
          f"before {_ms(beside['sync_before'])}, after "
          f"{_ms(beside['sync_after'])}; phase 4 (a synchronize around each "
          f"call) {_ms(system['frame_ms_tail'])}")
    require(mono["state"] == "OK", f"pipelined mono: state {mono['state']}")
    require(mono["n_tracked"] > MIN_TRACKED,
            f"pipelined mono: only {mono['n_tracked']} tracked frames")
    require(mono["n_kf"] >= MIN_KF, f"pipelined mono: {mono['n_kf']} kf")
    require(mono["n_lm"] > MIN_LM, f"pipelined mono: {mono['n_lm']} lm")
    require(mono["ate_m"] < ATE_MAX_M, f"pipelined mono: ATE {mono['ate_m']}")
    require(mono["ate_raw_m"] < ATE_RAW_MAX_M,
            f"pipelined mono: raw ATE {mono['ate_raw_m']}")
    add_launches(record, mono["launches"])

    images, R_gt, t_gt, ts, imu = sr.render_euroc_vi()

    def vi_run(pipelined):
        slam = sr.make_vi_system(dev, pipelined=pipelined)

        def step(k):
            t_prev = float(ts[k - 1]) if k else -1.0
            return slam.track_monocular(
                images[k], float(ts[k]), sr.imu_points(imu, t_prev,
                                                       float(ts[k])))

        return slam, step

    vi_sync = plain_loop(*vi_run(False), len(images))
    slam, step = vi_run(True)
    vi = pipe_loop(slam, step, len(images), "pipelined euroc_vi")
    vi.update(state=slam.get_tracking_state().name,
              dropped_imu_samples=slam.dropped_imu_samples,
              sync_beside=vi_sync,
              **sr.vi_metrics(slam, R_gt, t_gt, sr.VI_TRUE_BG))
    vi["failed_bars"] = sr.vi_failures(vi)
    vi["pipelined_frames_jax_cpu"] = VI_PIPELINED_JAX_CPU
    print(f"pipelined euroc_vi: {vi['pipelined_frames']} pipelined frames "
          f"(JAX on a CPU {VI_PIPELINED_JAX_CPU}), {vi['n_kf']} keyframes, "
          f"{vi['n_tracked']} tracked, bg error {vi['bg_err']:.3g}, after "
          f"the init {vi['n_post_init']} frames, Umeyama scale "
          f"{vi.get('umeyama_scale')}, length ratio {vi.get('length_ratio')}"
          f", ATE {vi.get('ate_m')} m (phase 10 {euroc_vi.get('ate_m')}); "
          f"dropped IMU samples {vi['dropped_imu_samples']}")
    print(f"pipelined euroc_vi, per call over the second half: "
          f"{_ms(vi['frame_ms_tail'])}; the synchronous System before it "
          f"{_ms(vi_sync)}; phase 10 (a synchronize around each call) "
          f"{_ms(euroc_vi['frame_ms_tail'])}")
    require(not vi["failed_bars"], f"pipelined euroc_vi: {vi['failed_bars']}")
    require(vi["pipelined_frames"] >= 0.9 * VI_PIPELINED_JAX_CPU,
            f"pipelined euroc_vi: {vi['pipelined_frames']} pipelined frames "
            f"against the JAX System's {VI_PIPELINED_JAX_CPU}")
    add_launches(record, vi["launches"])
    print(f"pipelined: card {card_line()}")
    return dict(mono=mono, euroc_vi=vi)


# ------------------------------------------------------- phases 14-15

# phase 14: the parts of tools/bench.py, each counted from 0 around its run
BENCH_PARTS = ("_bench_tracking", "_bench_ba_iters",
               "_bench_system_fps_steady", "_bench_system_fps_steady_vi")
# the keys of bench.py's JSON line and of its `extra`
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "extra")
BENCH_EXTRA_KEYS = ("ba_iters_per_s_per_chip", "ba_problem",
                    "system_fps_steady", "system_fps_detail",
                    "system_fps_steady_vi", "system_fps_vi_detail",
                    "system_fps_note")
EVAL_DIR = ROOT / "build" / "eval"
# phase 15: the suite's rows that miss the ATE check of their bar on the
# card (PERF.md §6, the initializer's draw), each with the ATE ceiling it
# is held to in its place: just above their reading on an H100, 0.0383 and
# 0.0526 m, the same to the last digit in every run; every other check of
# their bar holds
EVAL_ATE_CEILING_M = {"synth_easy": 0.040, "synth_hard_vi_s0": 0.055}


@contextlib.contextmanager
def counted_parts(module, names):
    """For the block, each function `names` of `module` runs with every
    main-path kernel counter set to 0 before it and read after it, so that
    a caller that looks them up on the module runs them counted. Yields
    (launches, results), each keyed by name."""
    import torch

    launches, results = {}, {}

    def counted(name, fn):
        def run(*args, **kw):
            for c in _counters():
                c.launches = 0
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            launches[name] = dict(zip(COUNTED, (c.launches
                                                for c in _counters())))
            results[name] = out
            return out

        return run

    saved = {name: getattr(module, name) for name in names}
    try:
        for name, fn in saved.items():
            setattr(module, name, counted(name, fn))
        yield launches, results
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def run_bench(record) -> dict:
    """Phase 14: `tools/bench.py`'s `main` at its published sizes, each
    part's kernel launches counted from 0 around it. Bars: `bench.py`'s
    keys, the four numbers finite and positive, >= 4 keyframes in the
    mono run and the IMU initialized in the mono-inertial one, the card's
    name and power limit in `extra`, one launch of each main-path kernel
    a frame of the tracking loop (it runs `match_to_map` once, not
    `track_frame`), and each of the three counters moved in the run."""
    from orb_slam3_ros2_tpu_torch.tools import bench

    t0 = time.perf_counter()
    with counted_parts(bench, BENCH_PARTS) as (launches, results):
        blob = bench.main([])
    took = time.perf_counter() - t0
    extra = blob["extra"]
    print(f"bench: {json.dumps(blob)}")
    print(f"bench: took {took:.1f} s; launches {launches}")
    require(tuple(blob) == BENCH_KEYS
            and all(k in extra for k in BENCH_EXTRA_KEYS),
            f"bench: keys {list(blob)} / {list(extra)}")
    values = dict(tracking_fps_per_chip=blob["value"],
                  **{k: extra[k] for k in ("ba_iters_per_s_per_chip",
                                           "system_fps_steady",
                                           "system_fps_steady_vi")})
    for k, v in values.items():
        require(v is not None and np.isfinite(v) and v > 0,
                f"bench: {k} = {v}")
    require(extra["system_fps_detail"]["keyframes"] >= MIN_KF,
            f"bench: {extra['system_fps_detail']['keyframes']} keyframes")
    require(extra["system_fps_vi_detail"]["imu_initialized"],
            "bench: the mono-inertial run did not initialize its IMU")
    require(bool(extra["name"]) and bool(extra["power.limit"]),
            f"bench: card {extra['name']!r}, {extra['power.limit']!r}")
    frames = results["_bench_tracking"][1]["frames"]
    require(launches["_bench_tracking"] == dict.fromkeys(COUNTED, frames),
            f"bench: the tracking loop of {frames} frames launched "
            f"{launches['_bench_tracking']}")
    total = {k: sum(p[k] for p in launches.values()) for k in COUNTED}
    require(all(n > 0 for n in total.values()),
            f"bench: a main-path kernel did not launch: {total}")
    add_launches(record, total)
    return dict(blob=blob, launches=launches, took_s=took)


def loop_row(loopy) -> dict:
    """Phase 9's two runs (loop closing on, then off) as the suite's
    `synth_loopy` row (`runtime/bench_eval.run_loop_closure_case`: the
    same clip and settings)."""
    on, off = loopy["on"], loopy["off"]
    wall = on["mean_frame_ms"] * on["frames"] / 1e3
    return {"sequence": "synth_loopy", "mode": "mono+loop",
            "ate_rmse_m": round(on["ate_m"], 4), "kf_ate_rmse_m": None,
            "tracked_frames": on["n_tracked"], "frames": on["frames"],
            "wall_s": round(wall, 1), "fps": round(on["frames"] / wall, 1),
            "loops_closed": on["loops_closed"] + on["maps_merged"],
            "ate_loop_off_m": round(off["ate_m"], 4), "status": "ok"}


def run_eval(record, loopy) -> dict:
    """Phase 15: `tools/eval_ate.py`'s synthetic suite on the card, in
    full (its outputs under build/eval/, an empty data directory so that
    it runs the synthetic suite), each row held to its bar against
    EVAL.md's JAX row (`eval_ate.row_bar`: ATE, tracked share, the IMU
    initialized, a loop closed). The `synth_loopy` row is phase 9's runs
    (`loop_row`), not run again. A row of `EVAL_ATE_CEILING_M` is held to
    its ceiling in place of its bar's ATE (PERF.md §6); every other check
    of its bar holds. Every main-path kernel launched."""
    from orb_slam3_ros2_tpu_torch.tools import eval_ate

    no_data = EVAL_DIR / "no_data"
    if no_data.exists():
        shutil.rmtree(no_data)
    no_data.mkdir(parents=True)
    for c in _counters():
        c.launches = 0
    t0 = time.perf_counter()
    blob = eval_ate.main(["--data", str(no_data),
                          "--out", str(EVAL_DIR / "eval_results.json"),
                          "--out-md", str(EVAL_DIR / "EVAL_TORCH.md")],
                         given={"synth_loopy": loop_row(loopy)})
    took = time.perf_counter() - t0
    launches = dict(zip(COUNTED, (c.launches for c in _counters())))
    print(f"eval: took {took:.1f} s; launches {launches}")
    for bar in blob["bars"]:
        print(f"eval bar: {json.dumps(bar)}")
    require(blob["source"] == "synthetic" and len(blob["bars"])
            == len(eval_ate.synthetic_suite(False)) and all(blob["bars"]),
            f"eval: {blob['source']} rows {len(blob['results'])}")
    rows = {r["sequence"]: r for r in blob["results"]}

    def met(b):
        ceiling = EVAL_ATE_CEILING_M.get(b["sequence"])
        if ceiling is None:
            return b["met"]
        ate = rows[b["sequence"]]["ate_rmse_m"]
        return (ate is not None and ate <= ceiling
                and all(v for k, v in b["checks"].items() if k != "ate"))

    missed = [b["sequence"] for b in blob["bars"] if not met(b)]
    require(not missed, f"eval: rows missed their bar: {missed}")
    require(all(n > 0 for n in launches.values()),
            f"eval: a main-path kernel did not launch: {launches}")
    add_launches(record, launches)
    return dict(results=blob["results"], bars=blob["bars"],
                launches=launches, took_s=took)


# ----------------------------------------------------------- phase 16

ENTRY_DIR = ROOT / "build" / "chip"
# 16a: tests/test_graft_entry.py's checks, and the step held to the plain
# versions within phase 8's tolerances
ENTRY_MIN_INLIERS, ENTRY_POSE_ATOL = 100, 1e-3
ENTRY_PLAIN_R_ATOL, ENTRY_PLAIN_T_ATOL = 5e-5, 5e-4
ENTRY_TIMED_STEPS = 20
DRYRUN_SHARDS = 8
# 16b: the bars against BLOCKBA.json's global row (the JAX package's record)
BLOCKBA_COST_REL, BLOCKBA_RMSE_M = 0.02, 1e-3
# 16c: the iterations a run, and final_cost across shard counts, relative
SCALING_ITERS, SCALING_COST_REL = 20, 1e-3
# 16d: each codebook row against PR_RECALL.json's; the query count and the
# database size follow from the geometry alone
PR_QUERIES, PR_DB_ENTRIES, PR_RECALL_ATOL = 563, 1800, 0.03
# 16e: the published width with fewer distractor banks (PR_RECALL_10K.json
# reads 0.993 at 10,200 entries)
MAPSCALE_ENTRIES, MAPSCALE_MIN_RECALL = 3000, 0.96
ENTRY_PHASE_BUDGET_S = 300.0


def counted_run(fn):
    """(fn(), the main-path kernels' launches in it): every counter set to
    0 just before and read just after a synchronize."""
    import torch

    for c in _counters():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, dict(zip(COUNTED, (c.launches for c in _counters())))


def entry_graft(dev, record) -> dict:
    """16a: `graft_entry.entry()` on the card: one step launches each
    main-path kernel once and agrees with the same step through the plain
    versions; then `dryrun_multichip(8)`, 8 shards on the one card."""
    import torch
    from orb_slam3_ros2_tpu_torch.tools import graft_entry

    step, args = graft_entry.entry(dev)
    (R, t, n), launches = counted_run(lambda: step(*args))
    add_launches(record, launches)
    R, t, n = R.cpu().numpy(), t.cpu().numpy(), int(n)
    with plain_versions():
        Rp, tp, n_p = (a.cpu() for a in step(*args))
    dR, dt = float(np.abs(R - Rp.numpy()).max()), float(
        np.abs(t - tp.numpy()).max())
    for _ in range(3):
        step(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ENTRY_TIMED_STEPS):
        step(*args)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / ENTRY_TIMED_STEPS
    out = dict(inliers=n, inliers_plain=int(n_p), dR_plain=dR, dt_plain=dt,
               R_err=float(np.abs(R - np.eye(3)).max()),
               t_err=float(np.abs(t).max()), step_ms=step_ms,
               launches=launches)
    print(f"graft_entry.entry: {n} inliers (plain {int(n_p)}), |R - I| "
          f"{out['R_err']:.2e}, |t| {out['t_err']:.2e}; vs plain dR "
          f"{dR:.2e} dt {dt:.2e}; step {step_ms:.3f} ms (mean of "
          f"{ENTRY_TIMED_STEPS}); launches {launches}")
    require(n > ENTRY_MIN_INLIERS and out["R_err"] <= ENTRY_POSE_ATOL
            and out["t_err"] <= ENTRY_POSE_ATOL, f"entry: {out}")
    require(dR <= ENTRY_PLAIN_R_ATOL and dt <= ENTRY_PLAIN_T_ATOL
            and n == int(n_p), f"entry vs the plain versions: {out}")
    require(launches == dict.fromkeys(COUNTED, 1),
            f"entry: one step launched {launches}")
    t0 = time.perf_counter()
    try:
        (dry, dry_launches) = counted_run(
            lambda: graft_entry.dryrun_multichip(DRYRUN_SHARDS))
    except AssertionError as e:
        raise PhaseError(f"dryrun_multichip({DRYRUN_SHARDS}): {e!r}")
    out["dryrun"] = dict(dry, launches=dry_launches,
                         wall_s=time.perf_counter() - t0)
    add_launches(record, dry_launches)
    return out


def entry_block_ba(record) -> dict:
    """16b: `bench_block_ba` at its defaults, held to BLOCKBA.json."""
    from orb_slam3_ros2_tpu_torch.tools import bench_block_ba

    ref = json.loads((ROOT / "BLOCKBA.json").read_text())["results"]
    blob, launches = counted_run(lambda: bench_block_ba.main(
        ["--out", str(ENTRY_DIR / "BLOCKBA_TORCH.json")]))
    add_launches(record, launches)
    res = blob["results"]
    for key, row in res.items():
        if key == "analysis":
            continue
        print(f"block BA {key}: pose rmse {row['pose_rmse_m']} m, cost "
              f"{row['full_cost']}, wall {row.get('wall_s')} s, "
              f"{row.get('ms_per_iter', float('nan')):.3f} ms/iter | "
              f"BLOCKBA.json {ref[key]['pose_rmse_m']} m, "
              f"{ref[key]['full_cost']}")
    g, r = res["global"], ref["global"]
    require(abs(g["full_cost"] - r["full_cost"])
            <= BLOCKBA_COST_REL * r["full_cost"]
            and abs(g["pose_rmse_m"] - r["pose_rmse_m"]) <= BLOCKBA_RMSE_M,
            f"block BA global {g} vs BLOCKBA.json {r}")
    require(res["block_fixed_boundary"]["full_cost"] > g["full_cost"]
            and res["block_round_4"]["full_cost"]
            < res["block_fixed_boundary"]["full_cost"],
            f"block BA: the record's shape does not hold: {res}")
    return dict(results=res, launches=launches)


def entry_scaling(record) -> dict:
    """16c: `bench_scaling` at 64 x 32,768, 20 iterations, 1 / 2 / 4 / 8
    shards on the one card (in series), one rep."""
    from orb_slam3_ros2_tpu_torch.tools import bench_scaling

    lines, launches = counted_run(lambda: bench_scaling.main(
        ["--reps", "1", "--iters", str(SCALING_ITERS)]))
    add_launches(record, launches)
    rows = lines[:-1]
    for r in rows:
        print(f"scaling: {r['devices']} shards, "
              f"{r['best_s'] * 1e3 / SCALING_ITERS:.3f} ms/iter, cost "
              f"{r['final_cost']}")
    require([r["devices"] for r in rows] == [1, 2, 4, 8],
            f"scaling: shard counts {rows}")
    c1 = rows[0]["final_cost"]
    require(all(abs(r["final_cost"] - c1) <= SCALING_COST_REL * c1
                for r in rows), f"scaling: costs differ: {rows}")
    return dict(lines=lines, launches=launches)


def entry_place_recognition(record) -> dict:
    """16d: `bench_place_recognition` at its defaults, each row held to
    PR_RECALL.json's."""
    from orb_slam3_ros2_tpu_torch.tools import bench_place_recognition

    ref = json.loads((ROOT / "PR_RECALL.json").read_text())["results"]
    blob, launches = counted_run(lambda: bench_place_recognition.main(
        ["--vocab-out", str(ENTRY_DIR / "vocab")]))
    add_launches(record, launches)
    for row, r in zip(blob["results"], ref):
        print(f"place recognition {row['codebook']}: recall@1 "
              f"{row['recall@1']} (PR_RECALL.json {r['recall@1']}), group "
              f"{row['group_recall@1']} ({r['group_recall@1']}), queries "
              f"{row['queries']}")
        require(row["codebook"] == r["codebook"]
                and row["queries"] == PR_QUERIES
                and row["db_entries"] == PR_DB_ENTRIES,
                f"place recognition: {row}")
        require(abs(row["recall@1"] - r["recall@1"]) <= PR_RECALL_ATOL
                and abs(row["group_recall@1"] - r["group_recall@1"])
                <= PR_RECALL_ATOL,
                f"place recognition {row} vs PR_RECALL.json {r}")
    return dict(results=blob["results"], launches=launches)


def entry_mapscale(record) -> dict:
    """16e: `bench_pr_mapscale` at the published width with 3,000
    entries."""
    from orb_slam3_ros2_tpu_torch.tools import bench_pr_mapscale

    rep, launches = counted_run(lambda: bench_pr_mapscale.main(
        ["--target-entries", str(MAPSCALE_ENTRIES)]))
    add_launches(record, launches)
    print(f"map-scale recognition: {rep['db_entries']} entries, recall@1 "
          f"{rep['recall@1']}, query {rep['query_ms_median']} ms median; "
          f"card {card_line()}")
    require(rep["queries"] == PR_QUERIES
            and rep["recall@1"] >= MAPSCALE_MIN_RECALL,
            f"map-scale recognition: {rep}")
    return dict(report=rep, launches=launches)


def entry_train_vocab(dev, record) -> dict:
    """16f: `train_vocab --synthetic` (flat) at its defaults; the file
    loads in `System(vocab_path=...)` on the card and in
    `loop/vocab.load_vocabulary`."""
    from orb_slam3_ros2_tpu_torch.loop import vocab as vocab_mod
    from orb_slam3_ros2_tpu_torch.runtime import system as sysm
    from orb_slam3_ros2_tpu_torch.tools import train_vocab

    out = ENTRY_DIR / "vocab" / "train_synthetic.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    path, launches = counted_run(lambda: train_vocab.main(
        ["--synthetic", "--out", str(out)]))
    add_launches(record, launches)
    anchors = vocab_mod.load_vocabulary(path)
    slam = sysm.System(path, str(ROOT / "tests" / "data" / "synth_cam.yaml"),
                       sysm.Sensor.MONOCULAR, device=dev)
    loaded = slam.vocab.anchors.cpu().numpy()
    print(f"train_vocab: {path}, {anchors.shape} codebook; the System's "
          f"vocabulary on {slam.vocab.device}")
    require(anchors.shape == (vocab_mod.N_WORDS, vocab_mod.N_BITS)
            and np.array_equal(loaded, anchors),
            f"train_vocab: {anchors.shape}, the System's {loaded.shape}")
    return dict(path=path, launches=launches)


def entry_localize(dev, session) -> dict:
    """16g: `localize_map` with phase 11a's session directory as the
    source and a copy of its cloud moved by 5 degrees and 0.2 m as the
    target: T_dst_src is that motion within tests/test_icp_align.py's
    bars."""
    import torch
    from orb_slam3_ros2_tpu_torch.geom import lie
    from orb_slam3_ros2_tpu_torch.runtime import outputs
    from orb_slam3_ros2_tpu_torch.tools import localize_map

    axis = np.array([0.3, -0.5, 0.8])
    axis /= np.linalg.norm(axis)
    R_gt = lie.so3_exp(torch.as_tensor(
        axis * np.deg2rad(ICP_ROT_DEG))).numpy().astype(np.float64)
    t_dir = np.array([0.6, -0.4, 0.7])
    t_gt = ICP_T_M * t_dir / np.linalg.norm(t_dir)
    src = localize_map.load_cloud(str(session))
    moved = ENTRY_DIR / "moved.pcd"
    outputs.save_pcd(str(moved), src @ R_gt.T + t_gt)
    t0 = time.perf_counter()
    blob = localize_map.main(["--src", str(session), "--dst", str(moved)])
    ms = (time.perf_counter() - t0) * 1e3
    T = np.asarray(blob["T_dst_src"])
    dR = T[:3, :3] @ R_gt.T
    rot_err = float(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1.0, 1.0)))
    t_err = float(np.linalg.norm(T[:3, 3] - t_gt))
    print(f"localize_map: {blob['src_points']} points, rotation error "
          f"{rot_err:.2e} rad, translation error {t_err:.2e} m, rms "
          f"{blob['rms']}, inliers {blob['inlier_frac']}; {ms:.1f} ms")
    require(rot_err < ICP_ROT_ERR_RAD and t_err < ICP_T_ERR_M
            and blob["rms"] < ICP_RMS and blob["inlier_frac"] > ICP_INLIER,
            f"localize_map: {blob}")
    return dict(blob, rot_err_rad=rot_err, t_err_m=t_err, ms=ms)


def run_entry_points(dev, record, session) -> dict:
    """Phase 16: the port's remaining entry points through `main(argv)` (or
    `entry()` / `dryrun_multichip`) on the card, each held to its bar and
    its main-path kernel launches counted from 0 around it. `session` is
    phase 11a's session directory."""
    ENTRY_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out, took = {}, {}
    steps = (("graft_entry", lambda: entry_graft(dev, record)),
             ("block_ba", lambda: entry_block_ba(record)),
             ("scaling", lambda: entry_scaling(record)),
             ("place_recognition", lambda: entry_place_recognition(record)),
             ("mapscale", lambda: entry_mapscale(record)),
             ("train_vocab", lambda: entry_train_vocab(dev, record)),
             ("localize_map", lambda: entry_localize(dev, session)))
    for name, run in steps:
        t1 = time.perf_counter()
        out[name] = run()
        took[name] = time.perf_counter() - t1
        print(f"entry points: {name} took {took[name]:.1f} s")
    out["took_s"] = took
    out["phase_s"] = time.perf_counter() - t0
    print(f"entry points: phase 16 took {out['phase_s']:.1f} s "
          f"(budget {ENTRY_PHASE_BUDGET_S:.0f} s); card {card_line()}")
    require(out["phase_s"] <= ENTRY_PHASE_BUDGET_S,
            f"entry points: phase 16 took {out['phase_s']:.1f} s, over its "
            f"{ENTRY_PHASE_BUDGET_S:.0f} s budget")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / PKG / "__init__.py").is_file():
        print(f"chip_smoke: {PKG}/ not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from orb_slam3_ros2_tpu_torch.ops import cuda_lib

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(cuda_lib.load, SOURCES))
    print(f"built {len(SOURCES)} kernel sources in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        for line in cuda_lib.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    from orb_slam3_ros2_tpu_torch.io.synthetic import render_sequence
    from orb_slam3_ros2_tpu_torch.tools import system_run as sr

    img0 = render_sequence(n_frames=1, width=WIDTH, height=HEIGHT, fx=FX,
                           fy=FY, seed=1)[0][0]
    record = dict(frontend_packed=check_frontend(img0, dev, n_features=1000),
                  fused_match=check_match(dev), pose_opt_fused=check_pose(dev))
    # the stereo and RGB-D paths' shapes, on the first frames of their clips
    t_render = time.perf_counter()
    clips = {name: sr.RIGS[name].render() for name in RIG_PHASES}
    print(f"rendered the clips of phases 5-7 in "
          f"{time.perf_counter() - t_render:.2f} s")
    check_frontend_level((img0, clips["kitti_stereo"][0][0],
                          clips["tumvi_stereo"][0][0]), dev, record)
    labels = dict(frontend_packed="frontend_packed 752x480",
                  fused_match="fused_match 1000x4096 at 15 px",
                  pose_opt_fused="pose_opt_fused N=1000",
                  fast_nms="fast_nms 752x480 level",
                  blur7="blur7 752x480 level",
                  frontend_pass="frontend_pass 752x480 level")
    for name, r in record.items():
        print_times(f"{labels[name]} (max_abs_err {r['max_abs_err']:.3g})", r)
    print_times("frontend_pass_lite 752x480 level",
                record["frontend_pass"]["lite"])
    print(f"blur7 beside conv2d: conv2d device "
          f"{record['blur7']['library_device_ms']} ms, max |conv2d - blur7| "
          f"{record['blur7']['library_max_abs_diff']:.3g}")
    bench_img, bench_features, cap = bench_shape()
    shapes = {
        "frontend_packed 1241x376": check_frontend(
            clips["kitti_stereo"][0][0], dev, n_features=2000),
        "frontend_packed 512x512": check_frontend(
            clips["tumvi_stereo"][0][0], dev),
        "fused_match 2000x4096 / 2000x8192": check_match(dev, N=2000),
        "pose_opt_fused N=2000": check_pose(dev, N=2000),
        "pose_opt_fused N=4096": check_pose(dev, N=4096),
        # the benchmark's and the evaluation's shape (phases 14-15)
        "frontend_packed 640x480": check_frontend(
            bench_img, dev, n_features=bench_features),
        f"fused_match {cap}x4096 / {cap}x8192": check_match(dev, N=cap),
        f"pose_opt_fused N={cap}": check_pose(dev, N=cap),
        "fused_match 1000x4096 at 80 px / 60 px": check_match_reloc(dev),
    }
    for name, r in shapes.items():
        print_times(f"{name} (max_abs_err {r['max_abs_err']:.3g})", r)
        r.pop("device_ops", None)
    for name in ("frontend_packed", "fused_match", "pose_opt_fused"):
        record[name]["max_abs_err"] = max(
            [record[name]["max_abs_err"]]
            + [r["max_abs_err"] for k, r in shapes.items()
               if k.startswith(name)])
    ms_k, ms_p = run_slice(dev, record)
    slice_launches = {n: record[n]["launches"] for n in
                      ("frontend_packed", "fused_match", "pose_opt_fused")}
    print(f"slice launches: {slice_launches}")
    system = run_system(dev, record)
    rigs = {name: run_rig(dev, name, clips[name], record)
            for name in RIG_PHASES}
    reloc = run_reloc(dev, record)
    loopy = run_loopy(dev, record)
    loopy["corridor"] = run_corridor(dev, record)
    euroc_vi = run_euroc_vi(dev, record)
    vi_rigs = run_vi_rigs(dev, record)
    replays = run_replay(dev, record, system, clips["tum1_rgbd"])
    mesh = run_mesh(dev, record, system.pop("map_cloud"), loopy["corridor"])
    pipelined = run_pipelined(dev, record, system, euroc_vi)
    bench_out = run_bench(record)
    evaluation = run_eval(record, loopy)
    entry_points = run_entry_points(dev, record,
                                    REPLAY_DIR / "out" / "replay_dir")

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "wrapper_ms")
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    library_ms=record[name].get("library_ms"),
                    **{k: record[name][k] for k in keys})
               for name, (src, rep) in KERNELS.items()]
    phase2 = {labels[name]: {k: v for k, v in r.items() if k != "device_ops"}
              for name, r in record.items()}
    print(json.dumps({"frame_step_ms": ms_k, "frame_step_plain_ms": ms_p,
                      "slice_launches": slice_launches,
                      "phase2": phase2,
                      "system": system, "phase2_shapes": shapes,
                      "stereo": rigs["kitti_stereo"],
                      "rgbd": rigs["tum1_rgbd"],
                      "fisheye_stereo": rigs["tumvi_stereo"],
                      "euroc_reloc": reloc, "synth_loopy": loopy,
                      "euroc_vi": euroc_vi, "vi_rigs": vi_rigs,
                      "replay": replays, "mesh": mesh,
                      "pipelined": pipelined, "bench": bench_out,
                      "eval": evaluation, "entry_points": entry_points}))
    print(f"chip_smoke: all phases took {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
