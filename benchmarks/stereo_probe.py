#!/usr/bin/env python
"""Stereo rot-gap probe on the own-sim oracle (PARITY known gap).

Runs mono vs stereo on the same simulated world and prints attitude /
bias errors vs groundtruth to localize the constant ~0.2 deg stereo
attitude bias seen in the head-to-head.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from uvio_jax.manager import CameraConfig, VioConfig, VioManager  # noqa: E402
from uvio_jax.math import quat_to_rot  # noqa: E402
from uvio_jax.sim import SimCamera, SimParams, Simulator, circle_trajectory  # noqa: E402


def run(stereo: bool, seed=21, duration=14.0):
    cams = [SimCamera(), SimCamera(p_IinC=np.array([-0.11, 0.0, 0.0]))]
    sim = Simulator(
        SimParams(seed=seed, cameras=cams, num_pts=60),
        trajectory=circle_trajectory(duration=duration + 6.0),
    )
    use = cams if stereo else cams[:1]
    cfgs = [CameraConfig(model=c.model, intrinsics=c.intrinsics,
                         q_ItoC=c.q_ItoC, p_IinC=c.p_IinC) for c in use]
    cfg = VioConfig(max_clones=11, sigma_pix=1.0, cameras=cfgs)
    mgr = VioManager(cfg)
    g0 = sim.get_gt_state(sim.t_start)
    mgr.initialize_with_gt(sim.t_start, g0["q_GtoI"], g0["p_IinG"],
                           g0["v_IinG"], g0["bg"], g0["ba"])
    rows = []
    while sim.ok():
        r = sim.get_next_imu()
        if r is None:
            break
        t, wm, am = r
        mgr.feed_imu(t, wm, am)
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= t:
            rc = sim.get_next_cam()
            if rc is None:
                break
            tc, obs = rc
            mgr.feed_features(tc, obs if stereo else obs[:1])
            g = sim.get_gt_state(tc)
            Re = np.asarray(quat_to_rot(mgr.state.q))
            Rg = np.asarray(quat_to_rot(jnp.asarray(g["q_GtoI"])))
            # attitude error vector in the G frame: R_err = Re Rg^T
            Rerr = Re @ Rg.T
            ang = np.degrees(np.arccos(np.clip((np.trace(Rerr) - 1) / 2, -1, 1)))
            # axis decomposition (small angle): skew part
            w = 0.5 * np.array([Rerr[2, 1] - Rerr[1, 2],
                                Rerr[0, 2] - Rerr[2, 0],
                                Rerr[1, 0] - Rerr[0, 1]])
            rows.append({
                "t": tc - sim.t_start,
                "ang": ang,
                "axis": np.degrees(w),
                "bg_err": np.asarray(mgr.state.bg) - g["bg"],
                "ba_err": np.asarray(mgr.state.ba) - g["ba"],
                "p_err": np.linalg.norm(np.asarray(mgr.state.p) - g["p_IinG"]),
            })
            if rows[-1]["t"] > duration:
                break
    return rows


def summarize(tag, rows):
    tail = [r for r in rows if r["t"] > 4.0]
    ang = np.array([r["ang"] for r in tail])
    ax = np.stack([r["axis"] for r in tail])
    bg = np.stack([r["bg_err"] for r in tail])
    ba = np.stack([r["ba_err"] for r in tail])
    pe = np.array([r["p_err"] for r in tail])
    print(f"[{tag}] rot err mean {ang.mean():.3f} deg; axis mean (deg) {ax.mean(0)}")
    print(f"  bg_err mean {bg.mean(0)}  ba_err mean {ba.mean(0)}  |p_err| mean {pe.mean():.3f}")


if __name__ == "__main__":
    summarize("mono ", run(False))
    summarize("stereo", run(True))
