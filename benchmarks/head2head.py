#!/usr/bin/env python
"""Head-to-head accuracy benchmark: REFERENCE estimator vs uvio_jax on
IDENTICAL simulated measurement streams.

Protocol:
  1. build the reference ROS-free (benchmarks/refbuild/Makefile -> /tmp/refbuild)
  2. for each scenario: derive a config dir from the reference's
     config/rpng_sim (same yaml schema both sides parse), run the reference
     `ref_head2head` driver which dumps imu.csv / cam.csv / init.txt /
     ref_est.txt / gt.txt
  3. replay uvio_jax on the dumped streams (same gt init, same one-frame
     camera buffering as run_simulation.cpp) -> ours_est.txt
  4. ATE (posyaw + se3 alignment, `ov_eval error_singlerun` protocol) for
     both estimators against the simulator groundtruth.

Writes benchmarks/head2head_results.json and prints a markdown table.

Usage: python benchmarks/head2head.py [--seconds 45] [--scenarios mono,...]
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

# accuracy replay on the CPU, like the reference it is compared with;
# leaves the GPU to one benchmark process at a time
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_CFG = "/root/reference/config/rpng_sim"
BUILD = "/tmp/refbuild"
TRAJ = os.path.join(REPO, "data/sim/tum_corridor1_512_16_okvis.txt")

sys.path.insert(0, REPO)

# Scenario -> estimator_config.yaml key overrides. Schema is the reference's
# own (`config/rpng_sim/estimator_config.yaml`); uvio_jax's load_config parses
# the same keys (utils/config.py), so one config drives both estimators.
SCENARIOS = {
    # plain mono MSCKF, no SLAM, no calibration
    "mono": {
        "max_cameras": "1",
        "use_stereo": "false",
        "max_slam": "0",
        "calib_cam_extrinsics": "false",
        "calib_cam_intrinsics": "false",
        "calib_cam_timeoffset": "false",
        "calib_imu_intrinsics": "false",
        "calib_imu_g_sensitivity": "false",
        "feat_rep_msckf": '"GLOBAL_3D"',
        "max_msckf_in_update": "40",
    },
    # mono + SLAM landmarks, anchored inverse-depth representation
    "mono_slam": {
        "max_cameras": "1",
        "use_stereo": "false",
        "max_slam": "25",
        "max_slam_in_update": "25",
        "feat_rep_msckf": '"GLOBAL_3D"',
        "feat_rep_slam": '"ANCHORED_MSCKF_INVERSE_DEPTH"',
        "calib_cam_extrinsics": "false",
        "calib_cam_intrinsics": "false",
        "calib_cam_timeoffset": "false",
        "calib_imu_intrinsics": "false",
        "calib_imu_g_sensitivity": "false",
        "max_msckf_in_update": "40",
    },
    # stereo + SLAM (reference default reps), no calibration
    "stereo_slam": {
        "max_cameras": "2",
        "use_stereo": "true",
        "max_slam": "25",
        "max_slam_in_update": "25",
        "feat_rep_msckf": '"GLOBAL_3D"',
        "feat_rep_slam": '"ANCHORED_MSCKF_INVERSE_DEPTH"',
        "calib_cam_extrinsics": "false",
        "calib_cam_intrinsics": "false",
        "calib_cam_timeoffset": "false",
        "calib_imu_intrinsics": "false",
        "calib_imu_g_sensitivity": "false",
        "max_msckf_in_update": "40",
    },
    # mono MSCKF + the reference's NOVEL LAYER: UWB ranges from biased
    # anchors with imperfect priors + online lever-arm calibration
    # (uvio/src/core/UVioManager.cpp drain + per-range chi2 updates).
    # The uwb yamls + truth sidecar are generated by make_uwb_files().
    "uwb": {
        "max_cameras": "1",
        "use_stereo": "false",
        "max_slam": "0",
        "calib_cam_extrinsics": "false",
        "calib_cam_intrinsics": "false",
        "calib_cam_timeoffset": "false",
        "calib_imu_intrinsics": "false",
        "calib_imu_g_sensitivity": "false",
        "feat_rep_msckf": '"GLOBAL_3D"',
        "max_msckf_in_update": "40",
        "config_uwb": '"uwb_config.yaml"',
        "uwb_anchors": '"uwb_anchors.yaml"',
    },
    # SELF-INIT (a): still start (sim_distance_threshold ~0 keeps the
    # trajectory's initial 5 s stillness) -> static init + ZUPT hold
    # until motion (InertialInitializer static path + UpdaterZeroVelocity)
    "static_init": {
        "max_cameras": "1",
        "use_stereo": "false",
        "max_slam": "0",
        "calib_cam_extrinsics": "false",
        "calib_cam_intrinsics": "false",
        "calib_cam_timeoffset": "false",
        "calib_imu_intrinsics": "false",
        "calib_imu_g_sensitivity": "false",
        "feat_rep_msckf": '"GLOBAL_3D"',
        "max_msckf_in_update": "40",
        # no stock sim trajectory is visually still at its start
        # (tum_corridor creeps at 4-10 px disparity, udel_arl spins in
        # place at ~250 px), so make_config synthesizes one: hold the
        # corridor's first pose for 8 s, then fly (sim_traj_path is
        # filled in by make_still_start_traj). The threshold loop skips
        # until PATH LENGTH exceeds it (Simulator.cpp:80-108), so any
        # non-negative value skips a perfectly still hold entirely; a
        # negative threshold breaks immediately at the spline start.
        "sim_distance_threshold": "-1.0",
        # the simulator's 1-px uv noise alone produces ~1.8 px
        # first-to-last disparity over the window, above the 1.5 px
        # default stillness gate; both estimators get the same 3 px gate
        "init_max_disparity": "3.0",
        "try_zupt": "true",
        "init_dyn_use": "false",
        "_still_start": "8.0",
    },
    # SELF-INIT (b): moving start (default distance threshold) ->
    # dynamic init (CPI + MLE; the reference's ceres MLE runs on the
    # functional mini-ceres shim)
    "dyn_init": {
        "max_cameras": "1",
        "use_stereo": "false",
        "max_slam": "0",
        "calib_cam_extrinsics": "false",
        "calib_cam_intrinsics": "false",
        "calib_cam_timeoffset": "false",
        "calib_imu_intrinsics": "false",
        "calib_imu_g_sensitivity": "false",
        "feat_rep_msckf": '"GLOBAL_3D"',
        "max_msckf_in_update": "40",
        "sim_distance_threshold": "1.2",
        "try_zupt": "false",
        "init_dyn_use": "true",
    },
    # UZH-FPV-45-class aggressive flight: sustained 45 deg bank, fast
    # laps, strong roll/pitch oscillation (the UAV racing regime of the
    # reference's `config/uzhfpv_indoor_45`); stereo + SLAM like that
    # config
    "aggressive": {
        "max_cameras": "2",
        "use_stereo": "true",
        "max_slam": "25",
        "max_slam_in_update": "25",
        "feat_rep_msckf": '"GLOBAL_3D"',
        "feat_rep_slam": '"ANCHORED_MSCKF_INVERSE_DEPTH"',
        "calib_cam_extrinsics": "false",
        "calib_cam_intrinsics": "false",
        "calib_cam_timeoffset": "false",
        "calib_imu_intrinsics": "false",
        "calib_imu_g_sensitivity": "false",
        "max_msckf_in_update": "40",
        "_aggressive": "1",
    },
    # aggressive WITHOUT SLAM: isolates the landmark-init transient in
    # the aggressive scenario's rotation column
    "aggressive_msckf": {
        "max_cameras": "2",
        "use_stereo": "true",
        "max_slam": "0",
        "feat_rep_msckf": '"GLOBAL_3D"',
        "calib_cam_extrinsics": "false",
        "calib_cam_intrinsics": "false",
        "calib_cam_timeoffset": "false",
        "calib_imu_intrinsics": "false",
        "calib_imu_g_sensitivity": "false",
        "max_msckf_in_update": "40",
        "_aggressive": "1",
    },
    # diagnostic: stereo SLAM with GLOBAL_3D landmarks (isolates the
    # anchored-representation machinery from landmark management in the
    # corridor stereo gap)
    "stereo_slam_g3d": {
        "max_cameras": "2",
        "use_stereo": "true",
        "max_slam": "25",
        "max_slam_in_update": "25",
        "feat_rep_msckf": '"GLOBAL_3D"',
        "feat_rep_slam": '"GLOBAL_3D"',
        "calib_cam_extrinsics": "false",
        "calib_cam_intrinsics": "false",
        "calib_cam_timeoffset": "false",
        "calib_imu_intrinsics": "false",
        "calib_imu_g_sensitivity": "false",
        "max_msckf_in_update": "40",
    },
    # stereo MSCKF only (no SLAM): separates the MSCKF update path from
    # SLAM landmark bookkeeping in the corridor yaw-diffusion comparison
    "stereo_msckf": {
        "max_cameras": "2",
        "use_stereo": "true",
        "max_slam": "0",
        "feat_rep_msckf": '"GLOBAL_3D"',
        "calib_cam_extrinsics": "false",
        "calib_cam_intrinsics": "false",
        "calib_cam_timeoffset": "false",
        "calib_imu_intrinsics": "false",
        "calib_imu_g_sensitivity": "false",
        "max_msckf_in_update": "40",
    },
    # stereo on a sustained single-direction circle (tangent-facing yaw,
    # one lap / 20 s): the motion class that maximally amplifies the
    # noise-driven stereo yaw drift seen in own-sim probes — measures
    # whether the REFERENCE also accumulates yaw bias under constant-
    # direction rotation, on the identical stream
    "stereo_circle": {
        "max_cameras": "2",
        "use_stereo": "true",
        "max_slam": "25",
        "max_slam_in_update": "25",
        "feat_rep_msckf": '"GLOBAL_3D"',
        "feat_rep_slam": '"ANCHORED_MSCKF_INVERSE_DEPTH"',
        "calib_cam_extrinsics": "false",
        "calib_cam_intrinsics": "false",
        "calib_cam_timeoffset": "false",
        "calib_imu_intrinsics": "false",
        "calib_imu_g_sensitivity": "false",
        "max_msckf_in_update": "40",
        "_circle": "20.0",
    },
    # TUM-VI-class configuration: stereo EQUIDISTANT (fisheye) cameras
    # with the FULL simultaneous online-calibration set (extrinsics +
    # intrinsics + time offset) and PERTURBED seeds — the reference's
    # tum_vi deployment shape (`config/tum_vi/estimator_config.yaml`,
    # `ov_core/src/cam/CamEqui.h`). The camera chain comes from the
    # reference's own tum_vi kalibr file; sim_do_perturbation makes the
    # Simulator perturb the estimator's starting calib (dt ~10 ms, focal
    # ~1 px, extrinsics ~1 cm/0.06 deg, Simulator.cpp:209-241), and
    # ref_head2head.cc dumps the perturbed seed so the replay starts
    # from the identical wrong calibration.
    "tumvi_calib": {
        "max_cameras": "2",
        "use_stereo": "true",
        "max_slam": "25",
        "max_slam_in_update": "25",
        "feat_rep_msckf": '"GLOBAL_3D"',
        "feat_rep_slam": '"ANCHORED_MSCKF_INVERSE_DEPTH"',
        "calib_cam_extrinsics": "true",
        "calib_cam_intrinsics": "true",
        "calib_cam_timeoffset": "true",
        "calib_imu_intrinsics": "false",
        "calib_imu_g_sensitivity": "false",
        "max_msckf_in_update": "40",
        "sim_do_perturbation": "true",
        "_chain_from": "tum_vi",
    },
    # mono with full online camera calibration (reference defaults keep the
    # seeds at truth; tests the calib state machinery on both sides)
    "mono_calib": {
        "max_cameras": "1",
        "use_stereo": "false",
        "max_slam": "0",
        "calib_cam_extrinsics": "true",
        "calib_cam_intrinsics": "true",
        "calib_cam_timeoffset": "true",
        "calib_imu_intrinsics": "false",
        "calib_imu_g_sensitivity": "false",
        "feat_rep_msckf": '"GLOBAL_3D"',
        "max_msckf_in_update": "40",
    },
}


def build_reference():
    subprocess.run(["make", "-j8"], cwd=os.path.join(REPO, "benchmarks/refbuild"),
                   check=True, capture_output=True)


# UWB scenario ground truth: anchors ring the first-60s extent of the
# tum_corridor trajectory (x [-11,1.5], y [-6,1.4], z [1.1,1.75]) with
# nonzero range biases  y = (1+alpha) d + gamma + n  (uvio_sensor_data.h).
UWB_TRUTH = {
    "rate": 10.0,
    "sigma": 0.1,
    "seed": 941,
    "t_offset": 0.037,
    "p_UinI": [0.01, -0.01, -0.05],
    "anchors": [
        # id, true p_AinG, gamma, alpha
        (101, [2.5, 2.5, 0.5], 0.25, 0.03),
        (102, [-12.5, 2.0, 2.8], -0.15, -0.02),
        (103, [-12.0, -7.5, 0.3], 0.35, 0.015),
        (104, [2.0, -7.0, 2.5], 0.10, 0.025),
    ],
    # estimator's imperfect prior view: position offsets (~0.25 m) and
    # zero bias seeds; prior covariances cover the errors
    "est_offsets": [
        [0.21, -0.15, 0.10],
        [-0.12, 0.24, -0.18],
        [0.16, 0.11, 0.22],
        [-0.20, -0.13, -0.09],
    ],
}


def make_uwb_files(cdir, out):
    """Write uwb_config.yaml + uwb_anchors.yaml (estimator view, same
    files both estimators parse) and the truth sidecar for the driver."""
    tr = UWB_TRUTH
    with open(os.path.join(cdir, "uwb_config.yaml"), "w") as f:
        f.write("%YAML:1.0\n\ninit:\n")
        f.write("  n_fixed_anchors: 0\n")
        f.write(f"  n_known_anchors: {len(tr['anchors'])}\n")
        f.write("  min_dist_to_use_uwb: 0.5\n\n")
        f.write("tag0:\n")
        f.write("  calib_uwb_extrinsics: true\n")
        f.write(f"  p_UinI: [{tr['p_UinI'][0]}, {tr['p_UinI'][1]}, {tr['p_UinI'][2]}]\n")
        f.write("  p_IinG0: [0.0, 0.0, 0.0]\n")
        f.write(f"  uwb_sigma_range: {tr['sigma']}\n")
        f.write("  prior_uwb_imu_cov: 0.001\n")
        f.write("  uwb_chi2_multipler: 1.0\n")
    with open(os.path.join(cdir, "uwb_anchors.yaml"), "w") as f:
        f.write("%YAML:1.0\n")
        for i, (aid, p, _g, _a) in enumerate(tr["anchors"]):
            off = tr["est_offsets"][i]
            pe = [p[j] + off[j] for j in range(3)]
            f.write(f"\nanchor{i}:\n")
            f.write(f"  id: {aid}\n")
            f.write("  fix: false\n")
            f.write(f"  p_AinG: [{pe[0]:.4f},{pe[1]:.4f},{pe[2]:.4f}]\n")
            f.write("  const_bias: 0.0\n")
            f.write("  dist_bias: 0.0\n")
            f.write("  prior_p_AinG_cov: 0.05\n")
            f.write("  prior_const_bias_cov: 0.2\n")
            f.write("  prior_dist_bias_cov: 0.02\n")
    truth_path = os.path.join(out, "uwb_truth.csv")
    with open(truth_path, "w") as f:
        pu = tr["p_UinI"]
        f.write(f"{tr['rate']},{tr['sigma']},{tr['seed']},{tr['t_offset']},"
                f"{pu[0]},{pu[1]},{pu[2]}\n")
        for (aid, p, g, a) in tr["anchors"]:
            f.write(f"{aid},{p[0]},{p[1]},{p[2]},{g},{a}\n")
    return truth_path


def make_aggressive_traj(dst, duration=70.0):
    """UZH-FPV-45-class high-dynamics trajectory: fast laps (4 m/s+)
    with sustained ~45 deg bank, aggressive roll/pitch oscillation and
    strong vertical excursions — the UAV racing regime the reference's
    `config/uzhfpv_indoor_45` targets."""
    from scipy.spatial.transform import Rotation as Rsp

    sys.path.insert(0, REPO)
    import jax.numpy as jnp

    from uvio_jax.math import rot_to_quat

    hz = 40.0
    t = np.arange(0.0, duration, 1.0 / hz)
    lap_s = 6.0  # one 2.5 m-radius lap every 6 s => ~2.6 m/s, ~1 rad/s yaw
    th = 2.0 * np.pi * t / lap_s
    p = np.stack([
        2.5 * np.cos(th), 2.5 * np.sin(th), 1.5 + 0.8 * np.sin(2.0 * th)
    ], 1)
    yaw = th + np.pi / 2.0
    # sustained 45 deg bank into the turn + aggressive oscillation
    roll = np.deg2rad(45.0) + 0.35 * np.sin(3.1 * th)
    pitch = 0.4 * np.sin(2.3 * th)
    R_ItoG = Rsp.from_euler("zyx", np.stack([yaw, pitch, roll], axis=1)).as_matrix()
    import numpy as _np
    q = np.asarray(rot_to_quat(jnp.asarray(_np.transpose(R_ItoG, (0, 2, 1)))))
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "w") as f:
        f.write("# t x y z qx qy qz qw\n")
        for i in range(len(t)):
            f.write(f"{t[i] + 1520531829.0:.9f} "
                    + " ".join(f"{x:.9f}" for x in p[i])
                    + " " + " ".join(f"{x:.9f}" for x in q[i]) + "\n")
    return dst


def make_circle_traj(dst, lap_s=20.0, duration=70.0):
    """Write a constant-direction circular trajectory (tangent-facing
    yaw + gentle roll/pitch bobbing) in the reference's sim format."""
    sys.path.insert(0, REPO)
    from uvio_jax.sim import circle_trajectory

    t, q, p = circle_trajectory(duration=duration, lap_s=lap_s)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "w") as f:
        f.write("# t x y z qx qy qz qw\n")
        for i in range(len(t)):
            f.write(f"{t[i] + 1520531829.0:.9f} "
                    + " ".join(f"{x:.9f}" for x in p[i])
                    + " " + " ".join(f"{x:.9f}" for x in q[i]) + "\n")
    return dst


def make_still_start_traj(dst, hold_s=8.0, src=None):
    """Write a sim trajectory that holds the source's first pose for
    `hold_s` seconds before flying it — the classic grounded-UAV start
    that static init + ZUPT are designed for (no stock ov_data/sim
    trajectory is visually still at its start)."""
    d = np.loadtxt(src or TRAJ)
    t0 = d[0, 0]
    hold_t = np.arange(0.0, hold_s, 0.1)
    hold = np.tile(d[0], (len(hold_t), 1))
    hold[:, 0] = t0 - hold_s + hold_t
    np.savetxt(dst, np.vstack([hold, d]), fmt="%.9f")
    return dst


def make_config(name, overrides):
    cdir = f"/tmp/h2h/{name}/config"
    os.makedirs(cdir, exist_ok=True)
    overrides = dict(overrides)
    lap = overrides.pop("_circle", None)
    if lap is not None:
        traj = make_circle_traj(f"/tmp/h2h/{name}/circle.txt", lap_s=float(lap))
        overrides["sim_traj_path"] = f'"{traj}"'
    if overrides.pop("_aggressive", None) is not None:
        traj = make_aggressive_traj(f"/tmp/h2h/{name}/aggressive.txt")
        overrides["sim_traj_path"] = f'"{traj}"'
    # camera chain source: default rpng_sim; a scenario can pull another
    # reference config's chain (e.g. tum_vi's stereo equidistant)
    chain_from = overrides.pop("_chain_from", None)
    chain_dir = (
        os.path.join(os.path.dirname(REF_CFG), chain_from) if chain_from else REF_CFG
    )
    shutil.copy(os.path.join(REF_CFG, "kalibr_imu_chain.yaml"), cdir)
    shutil.copy(os.path.join(chain_dir, "kalibr_imucam_chain.yaml"), cdir)
    text = open(os.path.join(REF_CFG, "estimator_config.yaml")).read()
    hold = overrides.pop("_still_start", None)
    if hold is not None:
        traj = make_still_start_traj(f"/tmp/h2h/{name}/still_start.txt",
                                     hold_s=float(hold))
        overrides["sim_traj_path"] = f'"{traj}"'
    overrides.setdefault("sim_traj_path", f'"{TRAJ}"')
    overrides["verbosity"] = '"WARNING"'
    for k, v in overrides.items():
        pat = re.compile(rf"^{k}:.*$", re.M)
        if pat.search(text):
            text = pat.sub(f"{k}: {v}", text)
        else:
            text += f"\n{k}: {v}\n"
    with open(os.path.join(cdir, "estimator_config.yaml"), "w") as f:
        f.write(text)
    return cdir


def run_reference(name, cdir, seconds):
    out = f"/tmp/h2h/{name}"
    os.makedirs(out, exist_ok=True)
    if name == "uwb":
        truth = make_uwb_files(cdir, out)
        cmd = [f"{BUILD}/ref_uwb_head2head",
               os.path.join(cdir, "estimator_config.yaml"), out, truth,
               str(seconds)]
    elif name in ("static_init", "dyn_init"):
        cmd = [f"{BUILD}/ref_selfinit_head2head",
               os.path.join(cdir, "estimator_config.yaml"), out, str(seconds)]
    else:
        cmd = [f"{BUILD}/ref_head2head",
               os.path.join(cdir, "estimator_config.yaml"), out, str(seconds)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
    if r.returncode != 0:
        raise RuntimeError(f"reference run failed for {name}:\n{r.stdout}\n{r.stderr}")
    last = r.stdout.strip().splitlines()[-1]
    stats = json.loads(last[last.index("{"):])
    return out, stats


def replay_uvio_jax(name, cdir, out):
    """Feed the dumped imu/cam streams through uvio_jax (gt init, same
    one-frame camera buffering as the reference's run_simulation loop)."""
    import dataclasses

    from uvio_jax.manager import VioManager
    from uvio_jax.utils.config import load_config
    from uvio_jax.uwb_manager import UVioConfig, UVioManager

    cfg, extras = load_config(cdir)
    # seed the estimator's starting calibration from the reference
    # driver's dump (perturbed when sim_do_perturbation is set) so both
    # estimators start from the identical wrong calib
    seed_path = os.path.join(out, "calib_seed.txt")
    if os.path.exists(seed_path):
        with open(seed_path) as f:
            seed_rows = [
                [float(x) for x in ln.split()] for ln in f.read().split("\n") if ln
            ]
        cams = []
        for i, c in enumerate(cfg.cameras):
            r = seed_rows[1 + i]
            cams.append(dataclasses.replace(
                c, intrinsics=np.asarray(r[0:8]),
                q_ItoC=np.asarray(r[8:12]), p_IinC=np.asarray(r[12:15]),
            ))
        cfg = dataclasses.replace(
            cfg, cameras=cams, camimu_dt=seed_rows[0][0]
        )
    self_init = name in ("static_init", "dyn_init")
    if self_init:
        # both paths enabled like the reference's InertialInitializer
        # dispatcher; the disparity gate picks static vs dynamic
        cfg = dataclasses.replace(cfg, use_static_init=True)
        init = None
    else:
        cfg = dataclasses.replace(cfg, use_static_init=False, use_dynamic_init=False)
    mgr = UVioManager(cfg) if isinstance(cfg, UVioConfig) else VioManager(cfg)

    if not self_init:
        init = np.loadtxt(os.path.join(out, "init.txt"))
        mgr.initialize_with_gt(init[0], init[1:5], init[5:8], init[8:11],
                               init[11:14], init[14:17])

    # UWB range sets (exact streams the reference consumed)
    uwb_path = os.path.join(out, "uwb.csv")
    uwb_sets = []
    if isinstance(cfg, UVioConfig) and os.path.exists(uwb_path):
        rows = np.loadtxt(uwb_path, delimiter=",")
        tv, idx = np.unique(rows[:, 0], return_index=True)
        for t_u in tv[np.argsort(idx)]:
            rr = rows[rows[:, 0] == t_u]
            uwb_sets.append(
                (float(t_u), {int(a): float(d) for a, d in rr[:, 1:3]})
            )
        uwb_sets.sort(key=lambda s: s[0])

    imu = np.loadtxt(os.path.join(out, "imu.csv"), delimiter=",")
    cam = np.loadtxt(os.path.join(out, "cam.csv"), delimiter=",")
    # group camera rows into frames: (t, [(ids, uvs) per cam])
    frames = []
    t_vals, idx = np.unique(cam[:, 0], return_index=True)
    order = np.argsort(idx)
    for t in t_vals[order]:
        rows = cam[cam[:, 0] == t]
        per_cam = []
        for c in range(len(cfg.cameras)):
            rc = rows[rows[:, 1] == c]
            per_cam.append((rc[:, 2].astype(np.int64), rc[:, 3:5]))
        frames.append((float(t), per_cam))
    frames.sort(key=lambda f: f[0])

    est_t, est_q, est_p = [], [], []
    frame_s = []
    calib_rows = []
    record_calib = (
        cfg.calib_cam_pose or cfg.calib_cam_intrinsics or cfg.calib_cam_timeoffset
    )
    fi = 0
    ui = 0
    dt_cam = float(getattr(cfg, "camimu_dt", 0.0))
    import time as _time
    wall0 = _time.perf_counter()
    for k in range(imu.shape[0]):
        t = float(imu[k, 0])
        mgr.feed_imu(t, imu[k, 1:4], imu[k, 4:7])
        # UWB sets arrive right after the IMU sample covering them
        # (ref_uwb_head2head.cc feeds at next_uwb <= t_imu - dt)
        while ui < len(uwb_sets) and uwb_sets[ui][0] <= t - dt_cam:
            mgr.feed_uwb(uwb_sets[ui][0], uwb_sets[ui][1])
            ui += 1
        # one-frame buffer: feed frame i when frame i+1's time has passed,
        # mirroring run_simulation.cpp's buffer_timecam handoff
        while fi + 1 < len(frames) and frames[fi + 1][0] <= t:
            ti, obs = frames[fi]
            if self_init or ti > float(init[0]):
                s0 = _time.perf_counter()
                mgr.feed_features(ti, obs)
                frame_s.append(_time.perf_counter() - s0)
                if mgr.is_initialized:
                    if not est_t and getattr(mgr, "init_replay_rows", None):
                        # the init stamp is in the past (end of the still
                        # window / start of the dynamic window); the
                        # reference emits estimates while fast-forwarding
                        # the buffered frames — record ours the same way
                        # so init latency is measured symmetrically
                        for (rt, rq, rp) in mgr.init_replay_rows:
                            est_t.append(float(rt))
                            est_q.append(rq)
                            est_p.append(rp)
                    if not est_t or float(mgr.state.time) > est_t[-1] + 1e-9:
                        est_t.append(float(mgr.state.time))
                        est_q.append(np.asarray(mgr.state.q))
                        est_p.append(np.asarray(mgr.state.p))
                        if record_calib and len(est_t) % 5 == 0:
                            st_ = mgr.state
                            row = [est_t[-1], float(st_.calib_dt)]
                            for ci in range(len(cfg.cameras)):
                                row += list(np.asarray(st_.calib_cam_intr[ci]))
                                row += list(np.asarray(st_.calib_cam_q[ci]))
                                row += list(np.asarray(st_.calib_cam_p[ci]))
                            calib_rows.append(row)
            fi += 1
    wall = _time.perf_counter() - wall0
    # init latency is computed symmetrically in main() from the first
    # row of each estimate file (both estimators' internal "init stamp"
    # bookkeeping differs: window start vs end vs decision frame)
    t_init_ours = est_t[0] if (self_init and est_t) else None
    # final calibration estimates (same row format as calib_seed.txt)
    if cfg.calib_cam_pose or cfg.calib_cam_intrinsics or cfg.calib_cam_timeoffset:
        st = mgr.state
        with open(os.path.join(out, "ours_calib_final.txt"), "w") as f:
            f.write(f"{float(st.calib_dt):.17g}\n")
            for i in range(len(cfg.cameras)):
                intr = np.asarray(st.calib_cam_intr[i])
                q = np.asarray(st.calib_cam_q[i])
                p = np.asarray(st.calib_cam_p[i])
                f.write(" ".join(f"{x:.17g}" for x in [*intr, *q, *p]) + "\n")
        # per-frame calibration trajectory for convergence analysis /
        # plots (`ResultSimulation`-style, eval/simres.py semantics)
        if calib_rows:
            np.savetxt(os.path.join(out, "ours_calib_traj.csv"),
                       np.asarray(calib_rows),
                       header="t dt intr0(8) q0(4) p0(3) [intr1 q1 p1 ...]")
    if isinstance(cfg, UVioConfig):
        with open(os.path.join(out, "ours_anchors_est.txt"), "w") as f:
            st = mgr.state
            for aid, slot in mgr.anchor_slot_by_id.items():
                p = np.asarray(st.anchors_p[slot])
                f.write(f"{aid} {p[0]:.12f} {p[1]:.12f} {p[2]:.12f} "
                        f"{float(st.anchors_gamma[slot]):.12f} "
                        f"{float(st.anchors_alpha[slot]):.12f}\n")
    est = np.column_stack([
        np.asarray(est_t),
        np.asarray(est_p),
        np.asarray(est_q),
    ])
    np.savetxt(os.path.join(out, "ours_est.txt"), est, fmt="%.9f")
    # steady-state fps: skip the jit-compile warmup frames (deployment
    # amortizes compiles via the persistent compilation cache); the
    # reference's fps has no compile component to exclude
    skip = min(25, len(frame_s) // 4)
    steady = np.asarray(frame_s[skip:])
    return {
        "frames": len(est_t),
        "wall_s": wall,
        "fps": len(est_t) / max(wall, 1e-9),
        "steady_fps": float(1.0 / max(steady.mean(), 1e-9)) if len(steady) else 0.0,
        "t_init": t_init_ours,
        "t_first": float(imu[0, 0]),
    }


def evaluate(out):
    from uvio_jax.eval.traj import ate, load_tum

    tg, qg, pg = load_tum(os.path.join(out, "gt.txt"))
    res = {}
    for tag, fn in (("ref", "ref_est.txt"), ("ours", "ours_est.txt")):
        te, qe, pe = load_tum(os.path.join(out, fn))
        for method in ("posyaw", "se3"):
            r = ate(te, qe, pe, tg, qg, pg, method=method)
            res[f"{tag}_{method}_pos_rmse"] = float(r["rmse_pos"])
            res[f"{tag}_{method}_rot_rmse"] = float(r["rmse_ori_deg"])
    # final anchor-state accuracy vs truth (uwb scenario only)
    truth = {aid: (np.asarray(p), g, a) for aid, p, g, a in UWB_TRUTH["anchors"]}
    for tag, fn in (("ref", "anchors_est.txt"), ("ours", "ours_anchors_est.txt")):
        path = os.path.join(out, fn)
        if not os.path.exists(path):
            continue
        rows = np.loadtxt(path)
        rows = np.atleast_2d(rows)
        perr, gerr, aerr = [], [], []
        for r in rows:
            tp, tg_, ta = truth[int(r[0])]
            perr.append(np.linalg.norm(r[1:4] - tp))
            gerr.append(abs(r[4] - tg_))
            aerr.append(abs(r[5] - ta))
        res[f"{tag}_anchor_pos_rmse"] = float(np.sqrt(np.mean(np.square(perr))))
        res[f"{tag}_anchor_gamma_mae"] = float(np.mean(gerr))
        res[f"{tag}_anchor_alpha_mae"] = float(np.mean(aerr))
    # final calibration accuracy vs the TRUE chain (online-calib
    # scenarios; the estimators started from the perturbed seed)
    if os.path.exists(os.path.join(out, "calib_seed.txt")):
        import jax.numpy as jnp

        from uvio_jax.math import quat_inv, quat_multiply
        from uvio_jax.utils.config import load_config as _lc

        true_cfg, _ = _lc(os.path.join(out, "config"))
        for tag, fn in (("ref", "ref_calib_final.txt"), ("ours", "ours_calib_final.txt")):
            path = os.path.join(out, fn)
            if not os.path.exists(path):
                continue
            with open(path) as f:
                rows = [[float(x) for x in ln.split()] for ln in f.read().split("\n") if ln]
            res[f"{tag}_calib_dt_err_ms"] = abs(rows[0][0] - true_cfg.camimu_dt) * 1e3
            ie, re_, pe_ = [], [], []
            for i, c in enumerate(true_cfg.cameras):
                r = rows[1 + i]
                ie.append(np.abs(np.asarray(r[0:4]) - c.intrinsics[:4]).max())
                dq = np.asarray(quat_multiply(
                    jnp.asarray(r[8:12]), quat_inv(jnp.asarray(c.q_ItoC))
                ))
                re_.append(np.degrees(2.0 * np.arcsin(min(1.0, np.linalg.norm(dq[:3])))))
                pe_.append(np.linalg.norm(np.asarray(r[12:15]) - c.p_IinC))
            res[f"{tag}_calib_intr_err_px"] = float(max(ie))
            res[f"{tag}_calib_rot_err_deg"] = float(max(re_))
            res[f"{tag}_calib_pos_err_m"] = float(max(pe_))
        # convergence over the run (simres.py semantics: first vs last
        # decile of |err| per recorded calib column, vs the true chain)
        traj_path = os.path.join(out, "ours_calib_traj.csv")
        if os.path.exists(traj_path):
            rows = np.atleast_2d(np.loadtxt(traj_path))
            truth_row = [true_cfg.camimu_dt]
            for c in true_cfg.cameras:
                truth_row += list(c.intrinsics) + list(c.q_ItoC) + list(c.p_IinC)
            k = min(rows.shape[1] - 1, len(truth_row))
            d = np.abs(rows[:, 1:1 + k] - np.asarray(truth_row)[None, :k])
            n10 = max(1, len(d) // 10)
            first, last = d[:n10].mean(0), d[-n10:].mean(0)
            res["ours_calib_converged_frac"] = float(np.mean(last <= first + 1e-12))
    return res


def run_multiseed(args):
    """Per-scenario Monte-Carlo over `sim_seed_measurements`: rerun the
    reference AND the replay on N independently-seeded streams, record
    mean/std of the se3 ATE columns under `<name>__multiseed` in the
    results json."""
    path = os.path.join(REPO, "benchmarks/head2head_results.json")
    merged = {}
    if os.path.exists(path):
        with open(path) as f:
            merged = json.load(f)
    for name in args.scenarios.split(","):
        name = name.strip()
        cols = {k: [] for k in ("ref_pos", "ref_rot", "ours_pos", "ours_rot")}
        lats = {"ref": [], "ours": []}
        for s in range(args.seeds):
            sname = f"{name}_s{s}"
            ov = dict(SCENARIOS[name])
            ov["sim_seed_measurements"] = str(s)
            # make_config keys dirs by scenario name
            cdir = make_config(sname, ov) if s else make_config(sname, ov)
            out, ref_stats = run_reference_as(name, sname, cdir, args.seconds)
            replay_uvio_jax(name if name in SCENARIOS else sname, cdir, out)
            res = evaluate(out)
            cols["ref_pos"].append(res["ref_se3_pos_rmse"])
            cols["ref_rot"].append(res["ref_se3_rot_rmse"])
            cols["ours_pos"].append(res["ours_se3_pos_rmse"])
            cols["ours_rot"].append(res["ours_se3_rot_rmse"])
            if name in ("static_init", "dyn_init"):
                imu0 = float(np.loadtxt(os.path.join(out, "imu.csv"),
                                        delimiter=",", max_rows=1)[0])
                for tag, fn in (("ref", "ref_est.txt"), ("ours", "ours_est.txt")):
                    rows = np.atleast_2d(np.loadtxt(os.path.join(out, fn)))
                    lats[tag].append(float(rows[0, 0]) - imu0)
            print(f"[{sname}] ref {cols['ref_pos'][-1]:.4f}/{cols['ref_rot'][-1]:.3f} "
                  f"ours {cols['ours_pos'][-1]:.4f}/{cols['ours_rot'][-1]:.3f}")
        entry = {
            k + suffix: float(f(v))
            for k, v in cols.items()
            for suffix, f in (("_mean", np.mean), ("_std", np.std))
        }
        entry["n_seeds"] = args.seeds
        if lats["ref"]:
            entry["ref_latency_mean"] = float(np.mean(lats["ref"]))
            entry["ours_latency_mean"] = float(np.mean(lats["ours"]))
        merged[f"{name}__multiseed"] = entry
        print(f"[{name}] MULTISEED ref {entry['ref_pos_mean']:.4f}±{entry['ref_pos_std']:.4f} m "
              f"/ {entry['ref_rot_mean']:.3f}±{entry['ref_rot_std']:.3f} deg | "
              f"ours {entry['ours_pos_mean']:.4f}±{entry['ours_pos_std']:.4f} m "
              f"/ {entry['ours_rot_mean']:.3f}±{entry['ours_rot_std']:.3f} deg")
        with open(path, "w") as f:
            json.dump(merged, f, indent=2)


def run_reference_as(base_name, sname, cdir, seconds):
    """run_reference but with the scenario TYPE keyed by base_name (uwb /
    self-init drivers) and output under the seed-suffixed dir."""
    out = f"/tmp/h2h/{sname}"
    os.makedirs(out, exist_ok=True)
    if base_name == "uwb":
        truth = make_uwb_files(cdir, out)
        cmd = [f"{BUILD}/ref_uwb_head2head",
               os.path.join(cdir, "estimator_config.yaml"), out, truth,
               str(seconds)]
    elif base_name in ("static_init", "dyn_init"):
        cmd = [f"{BUILD}/ref_selfinit_head2head",
               os.path.join(cdir, "estimator_config.yaml"), out, str(seconds)]
    else:
        cmd = [f"{BUILD}/ref_head2head",
               os.path.join(cdir, "estimator_config.yaml"), out, str(seconds)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
    if r.returncode != 0:
        raise RuntimeError(f"reference run failed for {sname}:\n{r.stdout}\n{r.stderr}")
    last = r.stdout.strip().splitlines()[-1]
    return out, json.loads(last[last.index("{"):])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--scenarios", type=str, default=",".join(SCENARIOS))
    ap.add_argument("--skip-build", action="store_true")
    ap.add_argument(
        "--replay-only", action="store_true",
        help="reuse the dumped streams + reference rows in /tmp/h2h and "
        "the committed results json; rerun only the uvio_jax replays",
    )
    ap.add_argument(
        "--seeds", type=int, default=0,
        help="N>0: run each scenario over N measurement seeds and record "
        "mean/std of the ATE columns (single-seed ATE differences at the "
        "mm / centi-degree level are init-draw noise; the distribution "
        "is the honest comparison)",
    )
    args = ap.parse_args()

    if not args.skip_build and not args.replay_only:
        build_reference()

    if args.seeds > 0:
        run_multiseed(args)
        return

    prev = {}
    if args.replay_only:
        with open(os.path.join(REPO, "benchmarks/head2head_results.json")) as f:
            prev = json.load(f)

    results = {}
    for name in args.scenarios.split(","):
        name = name.strip()
        cdir = f"/tmp/h2h/{name}/config" if args.replay_only else make_config(
            name, SCENARIOS[name]
        )
        if args.replay_only:
            out = f"/tmp/h2h/{name}"
            ref_stats = {
                "fps": prev[name]["ref_fps_cpu"],
                "frames": prev[name]["frames"],
            }
        else:
            out, ref_stats = run_reference(name, cdir, args.seconds)
        ours_stats = replay_uvio_jax(name, cdir, out)
        res = evaluate(out)
        res["ref_fps_cpu"] = ref_stats["fps"]
        res["ours_replay_fps"] = ours_stats["fps"]
        res["ours_replay_steady_fps"] = ours_stats["steady_fps"]
        res["frames"] = ref_stats["frames"]
        if name in ("static_init", "dyn_init"):
            # symmetric latency: first estimate row vs stream start (the
            # drivers' internal init stamps use differing conventions)
            t_first = ours_stats["t_first"]
            ref_rows = np.loadtxt(os.path.join(out, "ref_est.txt"))
            res["ref_init_latency_s"] = float(np.atleast_2d(ref_rows)[0, 0] - t_first)
            if ours_stats.get("t_init") is not None:
                res["ours_init_latency_s"] = ours_stats["t_init"] - t_first
        results[name] = res
        print(f"[{name}] ref ATE(se3) {res['ref_se3_pos_rmse']:.4f} m / "
              f"{res['ref_se3_rot_rmse']:.3f} deg | ours ATE(se3) "
              f"{res['ours_se3_pos_rmse']:.4f} m / {res['ours_se3_rot_rmse']:.3f} deg")

    # merge: keep rows of scenarios not re-run in this invocation
    path = os.path.join(REPO, "benchmarks/head2head_results.json")
    merged = {}
    if os.path.exists(path):
        with open(path) as f:
            merged = json.load(f)
    merged.update(results)
    with open(path, "w") as f:
        json.dump(merged, f, indent=2)

    print("\n| scenario | ref ATE pos (m) | ours ATE pos (m) | ref ATE rot (deg) | ours ATE rot (deg) |")
    print("|---|---|---|---|---|")
    for name, r in results.items():
        print(f"| {name} | {r['ref_se3_pos_rmse']:.4f} | {r['ours_se3_pos_rmse']:.4f} "
              f"| {r['ref_se3_rot_rmse']:.3f} | {r['ours_se3_rot_rmse']:.3f} |")


if __name__ == "__main__":
    main()
