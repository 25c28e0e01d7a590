"""Built-in SLAM settings for the standard benchmark datasets.

The reference ships 24 hand-written settings YAMLs covering EuRoC, TUM-VI,
TUM1-3, KITTI, and RealSense rigs across Monocular / Monocular-Inertial /
Stereo modes (`config/{Monocular,Monocular-Inertial,
Stereo}/*.yaml`; key families catalogued in SURVEY.md §2.3). Here the same
parameter surface is *generated* from calibration tables — the tables hold
the datasets' published sensor calibrations (EuRoC/TUM-VI/KITTI release
files), and `write_config` emits them in the OpenCV-FileStorage dialect
that both our `io.settings` parser and the reference engine consume, so
one source of truth serves every mode.

Run `python scripts/make_configs.py` to materialize the `config/` tree.

Copied from `orb_slam3_ros2_tpu/io/known_configs.py` (numpy only). The
generated text still names that file in its header comment, so that both
packages write the same bytes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Calibration tables (public dataset calibration releases)
# ---------------------------------------------------------------------------

# EuRoC MAV (ASL): cam0/cam1 sensor.yaml values, body(=IMU)-from-camera
_EUROC_T_B_C0 = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0],
])
_EUROC_T_B_C1 = np.array([
    [0.0125552670891, -0.999755099723, 0.0182237714554, -0.0198435579556],
    [0.999598781151, 0.0130119051815, 0.0251588363115, 0.0453689425024],
    [-0.0253898008918, 0.0179005838253, 0.999517347078, 0.00786212447038],
    [0.0, 0.0, 0.0, 1.0],
])

DATASETS: Dict[str, Dict] = {
    "EuRoC": {
        "cam_type": "PinHole",
        "width": 752, "height": 480, "fps": 20.0,
        "cam0": {"fx": 458.654, "fy": 457.296, "cx": 367.215, "cy": 248.375,
                 "k1": -0.28340811, "k2": 0.07395907,
                 "p1": 0.00019359, "p2": 1.76187114e-05},
        "cam1": {"fx": 457.587, "fy": 456.134, "cx": 379.999, "cy": 255.238,
                 "k1": -0.28368365, "k2": 0.07451284,
                 "p1": -0.00010473, "p2": -3.55590700e-05},
        "T_b_c1": _EUROC_T_B_C0,
        "T_c1_c2": np.linalg.inv(_EUROC_T_B_C0) @ _EUROC_T_B_C1,
        "imu": {"noise_gyro": 1.7e-4, "noise_acc": 2.0e-3,
                "gyro_walk": 1.9393e-5, "acc_walk": 3.0e-3, "freq": 200.0},
        "orb": {"n_features": 1000},
        "th_depth": 35.0,
        # the reference evaluates EuRoC mono-inertial at a 600x350 rescale
        # (`config/Monocular-Inertial/EuRoC.yaml:24-25`);
        # io/settings.py rescales the intrinsics accordingly
        "mode_overrides": {
            "Monocular-Inertial": {"new_width": 600, "new_height": 350},
        },
    },
    # TUM-VI 512x512 fisheye rig (camchain calibration, KB8 model)
    "TUM-VI": {
        "cam_type": "KannalaBrandt8",
        "width": 512, "height": 512, "fps": 20.0,
        "cam0": {"fx": 190.978477, "fy": 190.973307,
                 "cx": 254.931706, "cy": 256.897443,
                 "k1": 0.00348238940, "k2": 0.000715034845,
                 "k3": -0.00205323614, "k4": 0.000202936736},
        "cam1": {"fx": 190.442370, "fy": 190.434438,
                 "cx": 252.599497, "cy": 254.917231,
                 "k1": 0.00340031708, "k2": 0.00176627815,
                 "k3": -0.00266312570, "k4": 0.000329951742},
        "T_b_c1": np.array([
            [-0.99952504, 0.00750192, -0.02989013, 0.04557484],
            [0.02961534, -0.03439736, -0.99896935, -0.07116180],
            [-0.00852233, -0.99938008, 0.03415885, -0.04468125],
            [0.0, 0.0, 0.0, 1.0],
        ]),
        "T_c1_c2": np.array([
            [0.99999994, 0.00023117, 0.00027472, 0.10106110],
            [-0.00023124, 0.99999996, 0.00024871, -0.00019338],
            [-0.00027466, -0.00024877, 0.99999993, -0.00107999],
            [0.0, 0.0, 0.0, 1.0],
        ]),
        "imu": {"noise_gyro": 1.6e-4, "noise_acc": 2.8e-3,
                "gyro_walk": 2.2e-5, "acc_walk": 8.6e-4, "freq": 200.0},
        "orb": {"n_features": 1000},
        "th_depth": 35.0,
    },
    # KITTI odometry grayscale (already rectified; bf = baseline * fx)
    "KITTI00-02": {
        "cam_type": "Rectified",
        "width": 1241, "height": 376, "fps": 10.0,
        "cam0": {"fx": 718.856, "fy": 718.856,
                 "cx": 607.1928, "cy": 185.2157},
        "stereo_b": 386.1448 / 718.856,
        "orb": {"n_features": 2000},
        "th_depth": 35.0,
    },
    "KITTI03": {
        "cam_type": "Rectified",
        "width": 1242, "height": 375, "fps": 10.0,
        "cam0": {"fx": 721.5377, "fy": 721.5377,
                 "cx": 609.5593, "cy": 172.854},
        "stereo_b": 387.5744 / 721.5377,
        "orb": {"n_features": 2000},
        "th_depth": 35.0,
    },
    "KITTI04-12": {
        "cam_type": "Rectified",
        "width": 1226, "height": 370, "fps": 10.0,
        "cam0": {"fx": 707.0912, "fy": 707.0912,
                 "cx": 601.8873, "cy": 183.1104},
        "stereo_b": 379.8145 / 707.0912,
        "orb": {"n_features": 2000},
        "th_depth": 35.0,
    },
    # TUM RGB-D (freiburg 1/2/3 ROS-default intrinsics)
    "TUM1": {
        "cam_type": "PinHole",
        "width": 640, "height": 480, "fps": 30.0,
        "cam0": {"fx": 517.306408, "fy": 516.469215,
                 "cx": 318.643040, "cy": 255.313989,
                 "k1": 0.262383, "k2": -0.953104,
                 "p1": -0.005358, "p2": 0.002628, "k3": 1.163314},
        "orb": {"n_features": 1000},
    },
    "TUM2": {
        "cam_type": "PinHole",
        "width": 640, "height": 480, "fps": 30.0,
        "cam0": {"fx": 520.908620, "fy": 521.007327,
                 "cx": 325.141442, "cy": 249.701764,
                 "k1": 0.231222, "k2": -0.784899,
                 "p1": -0.003257, "p2": -0.000105, "k3": 0.917205},
        "orb": {"n_features": 1000},
    },
    "TUM3": {
        "cam_type": "PinHole",
        "width": 640, "height": 480, "fps": 30.0,
        "cam0": {"fx": 535.4, "fy": 539.2, "cx": 320.1, "cy": 247.6},
        "orb": {"n_features": 1000},
    },
    # RealSense D435i nominal factory intrinsics (color @ 640x480). Per-unit
    # calibration varies — re-calibrate with the recording tools in
    # io/recording.py + io/imu_sync.py for production use.
    "RealSense_D435i": {
        "cam_type": "Rectified",
        "width": 640, "height": 480, "fps": 30.0,
        "cam0": {"fx": 615.37, "fy": 615.47, "cx": 323.69, "cy": 240.23},
        "T_b_c1": np.array([
            [1.0, 0.0, 0.0, 0.0052],
            [0.0, 1.0, 0.0, 0.0136],
            [0.0, 0.0, 1.0, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ]),
        "imu": {"noise_gyro": 1.0e-3, "noise_acc": 1.0e-2,
                "gyro_walk": 1.0e-5, "acc_walk": 1.0e-4, "freq": 200.0},
        "orb": {"n_features": 1250},
        # stereo uses the rectified IR pair, not the color camera
        # (`config/Stereo/RealSense_D435i.yaml:11-16,28`)
        "mode_overrides": {
            "Stereo": {
                "cam0": {"fx": 382.613, "fy": 382.613,
                         "cx": 320.183, "cy": 236.455},
                "stereo_b": 0.0499585, "th_depth": 40.0,
            },
        },
    },
    # NTU VIRAL aerial dataset (stereo PinHole rig; calibration transcribed
    # from the dataset release, cf. `config/Monocular/
    # NTU_VIRAL.yaml`)
    "NTU_VIRAL": {
        "cam_type": "PinHole",
        "width": 752, "height": 480, "fps": 10.0,
        "cam0": {"fx": 4.250258563372763e+02, "fy": 4.267976260903337e+02,
                 "cx": 3.860151866550880e+02, "cy": 2.419130336743440e+02,
                 "k1": -0.288105327549552, "k2": 0.074578284234601,
                 "p1": 7.784489598138802e-04, "p2": -2.277853975035461e-04},
        "cam1": {"fx": 4.313364265799752e+02, "fy": 4.327527965378035e+02,
                 "cx": 3.548956286992647e+02, "cy": 2.325508916495161e+02,
                 "k1": -0.300267420221178, "k2": 0.090544063693053,
                 "p1": 3.330220891093334e-05, "p2": 8.989607188457415e-05},
        "T_c1_c2": np.array([
            [1.0, 0.0, 0.0, 0.259026647078268],
            [0.0, 1.0, 0.0, 0.000895520353150],
            [0.0, 0.0, 1.0, 0.006003466634407],
            [0.0, 0.0, 0.0, 1.0],
        ]),
        "orb": {"n_features": 2000, "n_levels": 7},
        "th_depth": 100.0,
    },
    # RealSense T265 tracking camera (KB8 fisheye + BMI055 IMU; VINS-mono
    # noise values, cf. `config/Monocular-Inertial/
    # RealSense_T265.yaml:1-69`)
    "RealSense_T265": {
        "cam_type": "KannalaBrandt8",
        "width": 848, "height": 800, "fps": 30.0,
        "cam0": {"fx": 283.794586181641, "fy": 284.952392578125,
                 "cx": 424.865386962891, "cy": 396.590911865234,
                 "k1": -0.0027128029614687, "k2": 0.0366887785494328,
                 "k3": -0.0354852788150311, "k4": 0.00590010220184922},
        "T_b_c1": np.array([
            [-0.99994, -0.00299325, 0.0105676, 0.0107000041753054],
            [0.0029806, -0.999995, -0.00121326, -1.45519152283669e-11],
            [0.0105711, -0.00118169, 0.999943, -1.45519152283669e-11],
            [0.0, 0.0, 0.0, 1.0],
        ]),
        "imu": {"noise_gyro": 5.148030141e-6, "noise_acc": 6.6952452471e-5,
                "gyro_walk": 4.99999999e-7, "acc_walk": 9.9999997474e-5,
                "freq": 200.0},
        "insert_kfs_when_lost": False,
        "orb": {"n_features": 800},
        # the stereo fisheye pair carries its own (per-unit) calibration
        # (`config/Stereo/RealSense_T265.yaml:11-52`)
        "mode_overrides": {
            "Stereo": {
                "cam0": {"fx": 284.9501953125, "fy": 285.115295410156,
                         "cx": 420.500213623047, "cy": 400.738098144531,
                         "k1": -0.00530046410858631, "k2": 0.0423333682119846,
                         "k3": -0.03949885815382, "k4": 0.00682387687265873},
                "cam1": {"fx": 285.001312255859, "fy": 284.914215087891,
                         "cx": 411.864196777344, "cy": 403.41259765625,
                         "k1": -0.00375203299336135, "k2": 0.0379297286272049,
                         "k3": -0.0352463386952877, "k4": 0.00548873096704},
                "T_c1_c2": np.array([
                    [0.999983, 0.00445005, 0.00385861, 0.0636739954352379],
                    [-0.00443664, 0.999984, -0.00347621,
                     -0.000252007856033742],
                    [-0.00387402, 0.00345903, 0.999986,
                     -8.87895439518616e-05],
                    [0.0, 0.0, 0.0, 1.0],
                ]),
                "lapping": (0, 847),
                "th_depth": 40.0,
                "orb": {"n_features": 1000, "ini_th_fast": 15},
            },
        },
    },
    # TUM-VI "far" variant: outdoor/magistrale sequences where distant
    # points must be culled (`config/Monocular-Inertial/
    # TUM-VI_far.yaml:50,57` — System.thFarPoints 20 m, 1250 features)
    "TUM-VI_far": {
        "alias_of": "TUM-VI",
        "modes": ("Monocular-Inertial",),
        "far_points": 20.0,
        "orb": {"n_features": 1250},
    },
    # MilkV Duo board camera, 640x360 downscale of a 1920x1080 sensor (the
    # fork's own rig; `config/Monocular/MilkV.yaml:42,74-75`
    # — it is also the rig whose config enables Atlas persistence)
    "MilkV": {
        "cam_type": "PinHole",
        "width": 640, "height": 360, "fps": 30.0,
        "cam0": {"fx": 342.67, "fy": 342.67, "cx": 203.0, "cy": 132.67,
                 "k1": -0.35952, "k2": 0.080321,
                 "p1": 0.001794, "p2": -0.001439},
        "orb": {"n_features": 1250},
        "atlas_save": "maps/prev_atlas",
    },
}

MODES = ("Monocular", "Monocular-Inertial", "Stereo", "Stereo-Inertial")


def _fmt(v: float) -> str:
    return repr(float(v))


def _mat_block(key: str, M: np.ndarray) -> List[str]:
    rows, cols = M.shape
    data = ", ".join(_fmt(v) for v in M.ravel())
    return [
        f"{key}: !!opencv-matrix",
        f"  rows: {rows}",
        f"  cols: {cols}",
        "  dt: f",
        f"  data: [{data}]",
    ]


def _resolved(name: str, mode: str) -> Dict:
    """Dataset table with `alias_of` base and per-mode overrides applied."""
    d = dict(DATASETS[name])
    if "alias_of" in d:
        base = dict(DATASETS[d.pop("alias_of")])
        base.update(d)
        d = base
    d.update(d.get("mode_overrides", {}).get(mode, {}))
    return d


def supports(name: str, mode: str) -> bool:
    d = _resolved(name, mode)
    if "modes" in d and mode not in d["modes"]:
        return False
    if "Inertial" in mode and "imu" not in d:
        return False
    if "Stereo" in mode and "cam1" not in d and "stereo_b" not in d:
        return False
    return True


def config_text(name: str, mode: str) -> str:
    """Render one settings file (OpenCV FileStorage YAML dialect)."""
    if not supports(name, mode):
        raise ValueError(f"{name} has no calibration for mode {mode}")
    d = _resolved(name, mode)
    L = [
        "%YAML:1.0",
        "",
        f"# {name} — {mode} (generated by scripts/make_configs.py from",
        "# orb_slam3_ros2_tpu/io/known_configs.py calibration tables)",
        'File.version: "1.0"',
        "",
        f'Camera.type: "{d["cam_type"]}"',
        "",
    ]

    def cam_lines(prefix: str, cam: Dict) -> List[str]:
        out = [f"{prefix}.{k}: {_fmt(v)}" for k, v in cam.items()]
        return out + [""]

    L += cam_lines("Camera1", d["cam0"])
    L += [
        f"Camera.width: {d['width']}",
        f"Camera.height: {d['height']}",
    ]
    if "new_width" in d:
        L += [
            f"Camera.newWidth: {d['new_width']}",
            f"Camera.newHeight: {d['new_height']}",
        ]
    L += [
        f"Camera.fps: {_fmt(d['fps'])}",
        "Camera.RGB: 1",
        "",
    ]
    if "Stereo" in mode:
        if "cam1" in d:
            L += cam_lines("Camera2", d["cam1"])
            L += _mat_block("Stereo.T_c1_c2", np.asarray(d["T_c1_c2"]))
            L += [""]
            if "lapping" in d:
                lo, hi = d["lapping"]
                L += [
                    f"Camera1.overlappingBegin: {lo}",
                    f"Camera1.overlappingEnd: {hi}",
                    f"Camera2.lappingBegin: {lo}",
                    f"Camera2.lappingEnd: {hi}",
                    "",
                ]
        else:
            L += [f"Stereo.b: {_fmt(d['stereo_b'])}", ""]
        L += [f"Stereo.ThDepth: {_fmt(d.get('th_depth', 60.0))}", ""]
    if d.get("far_points"):
        L += [f"System.thFarPoints: {_fmt(d['far_points'])}", ""]
    if "Inertial" in mode:
        imu = d["imu"]
        L += _mat_block("IMU.T_b_c1", np.asarray(d["T_b_c1"]))
        L += [
            f"IMU.NoiseGyro: {_fmt(imu['noise_gyro'])}",
            f"IMU.NoiseAcc: {_fmt(imu['noise_acc'])}",
            f"IMU.GyroWalk: {_fmt(imu['gyro_walk'])}",
            f"IMU.AccWalk: {_fmt(imu['acc_walk'])}",
            f"IMU.Frequency: {_fmt(imu['freq'])}",
            "",
        ]
    if "insert_kfs_when_lost" in d and "Inertial" in mode:
        L += [f"IMU.InsertKFsWhenLost: {int(d['insert_kfs_when_lost'])}", ""]
    if d.get("atlas_save"):
        L += [f'System.SaveAtlasToFile: "{d["atlas_save"]}"', ""]
    orb = d.get("orb", {})
    L += [
        f"ORBextractor.nFeatures: {orb.get('n_features', 1000)}",
        f"ORBextractor.scaleFactor: {_fmt(orb.get('scale_factor', 1.2))}",
        f"ORBextractor.nLevels: {orb.get('n_levels', 8)}",
        f"ORBextractor.iniThFAST: {orb.get('ini_th_fast', 20)}",
        f"ORBextractor.minThFAST: {orb.get('min_th_fast', 7)}",
        "",
        "Viewer.KeyFrameSize: 0.05",
        "Viewer.PointSize: 2.0",
        "",
    ]
    return "\n".join(L)


def write_all(root: str = "config") -> List[str]:
    written = []
    for mode in MODES:
        for name in DATASETS:
            if not supports(name, mode):
                continue
            dir_ = os.path.join(root, mode)
            os.makedirs(dir_, exist_ok=True)
            path = os.path.join(dir_, f"{name}.yaml")
            with open(path, "w") as f:
                f.write(config_text(name, mode))
            written.append(path)
    return written
