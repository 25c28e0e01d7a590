"""Dataset-replay / live SLAM runner of the port: replays a EuRoC or TUM-VI
directory, a TUM RGB-D directory, a rosbag2 (sqlite `.db3` or mcap), a
camera or a rendered sequence through the engine, and writes the wrapper's
artifact set (trajectory, PCD cloud, PGM occupancy grid, event log,
optional Atlas checkpoint and annotated video) plus an ATE report when
groundtruth is available.

    python -m orb_slam3_ros2_tpu_torch.tools.run_slam --settings S
        (--dataset DIR | --playback-bag BAG | --synthetic | --camera SRC)
        [--mode monocular|imu_monocular|stereo|imu_stereo|rgbd]
        [--max-frames N] [--output-name NAME] [--output-root DIR]
        [--checkpoint-every N] [--load-atlas NPZ] [--vocab PATH]
        [--record DIR] [--video] [--viewer [PORT]] [--profile]
        [--torch-profile LOGDIR] [--device cuda|cpu]

Port of `scripts/run_slam.py` over the port's `SlamSession`: the same
flags, paths and JSON report keys (`frames`, `fps`, `tracked_frames`,
`keyframes`, `landmarks`, `artifacts`, `ate_rmse_m`, `ate_frames`,
`kf_ate_rmse_m`, `stages`). New here: `--output-root` (the artifacts go to
`<output-root>/<output-name>/`, default `output`), `--device` (default:
the card; without one the run stops with an error unless `--device cpu`)
and `--torch-profile LOGDIR` (a torch.profiler Chrome trace of the replay,
in place of `--jax-profile`, and `stages.json`, each stage's kernel
launches and their device time from that trace). `--profile` adds the
System's stage report, with the session's `checkpoint` stage and one of
the runner's own, `load_frame`: reading and decoding one frame (PNGs, or
a bag message).
A EuRoC replay feeds its frames through `SlamSession.feed`, as the
synthetic and bag replays do, so `--video` records it and the VIBA edges
reset the session's pose history; `scripts/run_slam.py` calls
`track_monocular` there and writes an empty video.

`main(argv)` runs the replay, prints the report and returns
`(report, session)`, so that a caller can read the System after the run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from orb_slam3_ros2_tpu_torch.io import synthetic
from orb_slam3_ros2_tpu_torch.runtime.session import SlamSession
from orb_slam3_ros2_tpu_torch.runtime.system import ImuPoint, Sensor, System
from orb_slam3_ros2_tpu_torch.tools.cli import add_device, device_of
from orb_slam3_ros2_tpu_torch.utils import tracing

MODES = {
    "monocular": Sensor.MONOCULAR,
    "imu_monocular": Sensor.IMU_MONOCULAR,
    "stereo": Sensor.STEREO,
    "imu_stereo": Sensor.IMU_STEREO,
    "rgbd": Sensor.RGBD,
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--settings", required=True)
    ap.add_argument("--dataset",
                    help="EuRoC-layout sequence root (TUM RGB-D layout "
                         "with --mode rgbd)")
    ap.add_argument("--synthetic", action="store_true",
                    help="run on a rendered synthetic sequence")
    ap.add_argument("--camera", default=None,
                    help="live source for cv2.VideoCapture: RTSP URL, "
                         "device index, or video file")
    ap.add_argument("--playback-bag", metavar="BAG", default=None,
                    help="replay a rosbag2 (.db3 or .mcap, file or "
                         "directory) through the engine")
    ap.add_argument("--image-topic", default=None,
                    help="image topic in --playback-bag (default: first "
                         "Image/CompressedImage topic)")
    ap.add_argument("--imu-topic", default=None,
                    help="IMU topic in --playback-bag (default: first Imu "
                         "topic; ignored unless --mode imu_monocular)")
    ap.add_argument("--record", metavar="DIR", default=None,
                    help="tee the input stream to an EuRoC-layout recording "
                         "(replay it with --dataset)")
    ap.add_argument("--mode", default="monocular", choices=list(MODES))
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--output-name", default=None)
    ap.add_argument("--output-root", default="output",
                    help="artifacts go to <output-root>/<output-name>/")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    metavar="N", help="checkpoint the atlas every N frames")
    ap.add_argument("--load-atlas", default=None, metavar="NPZ",
                    help="resume from a saved/checkpointed atlas")
    ap.add_argument("--vocab", default=None,
                    help="vocabulary (DBoW2 .txt, codebook or tree .npz); "
                         "default: built-in projection codebook")
    ap.add_argument("--video", action="store_true")
    ap.add_argument("--viewer", type=int, nargs="?", const=8400,
                    default=None, metavar="PORT",
                    help="serve the live web viewer on PORT")
    ap.add_argument("--profile", action="store_true",
                    help="include per-stage wall-clock stats in the report")
    ap.add_argument("--torch-profile", metavar="LOGDIR",
                    help="write a torch.profiler trace of the replay to "
                         "LOGDIR/trace.json and its per-stage launch and "
                         "device counts to LOGDIR/stages.json")
    add_device(ap)
    return ap


def _timed(items: Iterable, tracer, name: str) -> Iterator:
    """Yield the items of `items`, timing each `next()` as stage `name`
    (the decode of a lazily decoded bag message)."""
    it = iter(items)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        tracer.add(name, time.perf_counter() - t0)
        yield item


def main(argv=None) -> Tuple[dict, SlamSession]:
    ap = build_parser()
    args = ap.parse_args(argv)
    device_of(ap, args)
    if args.mode == "rgbd" and (args.synthetic or args.camera
                                or args.video or args.record
                                or args.playback_bag):
        ap.error("--mode rgbd supports --dataset replay only (no "
                 "--synthetic/--camera/--playback-bag/--video/--record)")
    if args.synthetic and "stereo" in args.mode:
        ap.error("--synthetic supports monocular modes only")
    if args.playback_bag is not None and args.mode not in (
            "monocular", "imu_monocular"):
        ap.error("--playback-bag supports monocular modes")
    if not (args.synthetic or args.playback_bag is not None
            or args.camera is not None or args.dataset):
        ap.error("--dataset, --playback-bag, --camera or --synthetic "
                 "required")

    sensor = MODES[args.mode]
    system = None
    if args.vocab or args.load_atlas:
        system = System(args.vocab, args.settings, sensor,
                        load_atlas=args.load_atlas, device=args.device)
    session = SlamSession(args.settings, sensor,
                          output_name=args.output_name,
                          output_root=args.output_root,
                          record_video=args.video, system=system,
                          checkpoint_every=args.checkpoint_every,
                          device=args.device)
    slam = session.system
    tracer = slam.tracer

    viewer = None
    if args.viewer is not None:
        from orb_slam3_ros2_tpu_torch.runtime.viewer import LiveViewer

        viewer = LiveViewer(slam, port=args.viewer)
        print(f"live viewer: http://localhost:{viewer.port}/",
              file=sys.stderr)

    recorder = None
    if args.record:
        from orb_slam3_ros2_tpu_torch.io.recording import SequenceRecorder

        recorder = SequenceRecorder(args.record, stereo="stereo" in args.mode)

    # tracked-frame records keyed by rounded timestamp: (gt camera centre,
    # was the IMU initialized yet?). The estimated poses are read after the
    # run from get_frame_trajectory(), which applies the retroactive BA /
    # loop / scale corrections through each frame's reference keyframe
    # (the SaveTrajectoryTUM evaluation protocol).
    ok_by_t = {}
    gt_by_t = {}
    prof_ctx = contextlib.ExitStack()
    if args.torch_profile:
        prof_ctx.enter_context(tracing.capture(args.torch_profile))
    t_start = time.perf_counter()
    n = 0
    if args.synthetic:
        seed = 1
        traj_scale = 1.6
        cam = slam.cam
        images, R_gt, t_gt, ts = synthetic.render_sequence(
            n_frames=args.max_frames or 60, width=cam.width,
            height=cam.height, fx=cam.fx, fy=cam.fy, fps=cam.fps, seed=seed,
            traj_scale=traj_scale)
        imu_t = gyro = acc = None
        if "imu" in args.mode:
            # a consistent synthetic IMU along the same analytic trajectory
            # (render_sequence derives its poses from seed + 3)
            traj = synthetic.default_trajectory(seed=seed + 3,
                                                scale=traj_scale)
            imu_t, gyro, acc = synthetic.make_imu(
                traj, -0.02, float(ts[-1]) + 0.01, rate=200.0,
                gyro_noise=2e-4, acc_noise=2e-3, seed=7)
        t_prev = -1.0
        for k in range(images.shape[0]):
            g_k = -R_gt[k].T @ t_gt[k]
            gt_by_t[round(float(ts[k]), 6)] = g_k
            imu = []
            if imu_t is not None:
                sel = (imu_t > t_prev) & (imu_t <= ts[k])
                imu = [ImuPoint(acc[i], gyro[i], imu_t[i])
                       for i in np.where(sel)[0]]
            if recorder is not None:
                recorder.add_frame(images[k], float(ts[k]))
                for p in imu:
                    recorder.add_imu(p.t, p.gyro, p.acc)
                recorder.add_groundtruth(float(ts[k]), g_k)
            session.feed(images[k], float(ts[k]), imu)
            t_prev = float(ts[k])
            n += 1
            if slam.get_tracking_state().value == 1:
                ok_by_t[round(float(ts[k]), 6)] = (
                    g_k, slam.is_imu_initialized())
    elif args.playback_bag is not None:
        from orb_slam3_ros2_tpu_torch.io import rosbag as rosbag_mod

        reader = rosbag_mod.Rosbag2Reader(args.playback_bag)
        g_img, g_imu = reader.guess_topics()
        image_topic = args.image_topic or g_img
        imu_topic = (args.imu_topic or g_imu) if "imu" in args.mode else None
        if image_topic is None:
            ap.error(f"bag has no image topic (topics: "
                     f"{reader.topic_names()})")
        topics = [image_topic] + ([imu_topic] if imu_topic else [])
        pending = []
        for name, _bag_t, msg in _timed(reader.messages(topics), tracer,
                                        "load_frame"):
            if name == imu_topic:
                pending.append(ImuPoint(msg.acc, msg.gyro, msg.t))
                continue
            imu, pending = pending, []
            if recorder is not None:
                recorder.add_frame(msg.data, msg.t)
                for p in imu:
                    recorder.add_imu(p.t, p.gyro, p.acc)
            session.feed(msg.data, msg.t, imu)
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
    elif args.camera is not None:
        # live ingest: RTSP / device index / video file
        from orb_slam3_ros2_tpu_torch.runtime import cam_source as cs

        info = cs.camera_info_from_settings(args.settings)
        src = args.camera
        if src.isdigit():
            src = int(src)
        # raw frames in: the engine undistorts the extracted keypoints
        # against the settings' distortion model, so rectifying here would
        # correct twice
        cam_src = cs.OpenCVCameraSource(src, info, rectify=False)
        for img, t in cam_src.frames():
            if args.max_frames and n >= args.max_frames:
                break
            if recorder is not None:
                recorder.add_frame(img, t)
            session.feed(img.astype(np.float32), t)
            n += 1
        cam_src.release()
    elif args.mode == "rgbd":
        from orb_slam3_ros2_tpu_torch.io import tum_rgbd

        seq = tum_rgbd.load_sequence(args.dataset)
        frames = seq.frames[: args.max_frames or len(seq.frames)]
        for fr in frames:
            with tracer.stage("load_frame"):
                img, depth = fr.load()
            # not `session.feed`: that is the monocular call; RGB-D has no
            # VIBA edge to reset and takes no --video
            slam.track_rgbd(img, depth, fr.t)
            session.maybe_checkpoint()
            n += 1
            g = seq.gt_at(fr.t)
            if g is not None:
                gt_by_t[round(fr.t, 6)] = g
                if slam.get_tracking_state().value == 1:
                    ok_by_t[round(fr.t, 6)] = (g, True)
    else:
        from orb_slam3_ros2_tpu_torch.io import euroc

        seq = euroc.load_sequence(args.dataset, stereo="stereo" in args.mode)
        t_prev = None
        frames = seq.frames[: args.max_frames or len(seq.frames)]
        for fr in frames:
            imu = []
            if "imu" in args.mode and t_prev is not None:
                tt, gg, aa = seq.imu_between(t_prev, fr.t)
                imu = [ImuPoint(a, g, t) for t, g, a in zip(tt, gg, aa)]
            with tracer.stage("load_frame"):
                img = fr.load()
            if recorder is not None:
                recorder.add_frame(img, fr.t)
                for p in imu:
                    recorder.add_imu(p.t, p.gyro, p.acc)
            session.feed(img, fr.t, imu)
            t_prev = fr.t
            n += 1
            g = seq.gt_at(fr.t)
            if g is not None:
                gt_by_t[round(fr.t, 6)] = g
                if slam.get_tracking_state().value == 1:
                    ok_by_t[round(fr.t, 6)] = (g, slam.is_imu_initialized())

    prof_ctx.close()
    wall = time.perf_counter() - t_start
    if args.torch_profile:
        with open(os.path.join(args.torch_profile, "stages.json"), "w") as f:
            json.dump(tracing.stage_summary(
                os.path.join(args.torch_profile, "trace.json")), f, indent=1)
    if viewer is not None:
        viewer.close()
    artifacts = session.shutdown()
    if recorder is not None:
        artifacts["recording"] = recorder.close()
    report = _report(slam, args, n, wall, artifacts, ok_by_t, gt_by_t)
    print(json.dumps(report, indent=2))
    return report, session


def _report(slam: System, args, n: int, wall: float, artifacts: dict,
            ok_by_t: dict, gt_by_t: dict) -> dict:
    """The JSON report of `scripts/run_slam.py`, with the same keys."""
    est, gt, post_init = [], [], []
    for t, T in slam.get_frame_trajectory():
        rec = ok_by_t.get(round(t, 6))
        if rec is None:
            continue
        est.append(-T[:3, :3].T @ T[:3, 3])
        gt.append(rec[0])
        post_init.append(rec[1])
    report = {
        "frames": n,
        "fps": round(n / wall, 2),
        "tracked_frames": len(est),
        "keyframes": int(slam.map.n_kf),
        "landmarks": int(slam.map.lm_valid.sum()),
        "artifacts": artifacts,
    }
    if len(est) > 10:
        est_a, gt_a = np.asarray(est), np.asarray(gt)
        if "imu" in args.mode:
            # pre-init poses live at an arbitrary visual scale and are
            # rescaled retroactively at VIBA1; score the metric segment only
            sel = np.asarray(post_init, bool)
            if sel.sum() > 10:
                report["ate_rmse_m"] = round(
                    synthetic.ate_rmse(est_a[sel], gt_a[sel]), 4)
                report["ate_frames"] = int(sel.sum())
        else:
            report["ate_rmse_m"] = round(synthetic.ate_rmse(est_a, gt_a), 4)
    # keyframe-trajectory ATE: poses with every retroactive correction
    # applied (the SaveKeyFrameTrajectoryTUM evaluation)
    kf_est, kf_gt = [], []
    for t, T in slam.get_keyframe_trajectory():
        g = gt_by_t.get(round(t, 6))
        if g is not None:
            kf_est.append(-T[:3, :3].T @ T[:3, 3])
            kf_gt.append(g)
    if len(kf_est) > 5:
        report["kf_ate_rmse_m"] = round(
            synthetic.ate_rmse(np.asarray(kf_est), np.asarray(kf_gt)), 4)
    if args.profile:
        report["stages"] = slam.tracer.report()
    return report


if __name__ == "__main__":
    main()
