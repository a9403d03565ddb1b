"""Capture real inputs from a simulated run: per-frame FrameBundles of
the host loop, and raw rendered image streams.

Runs the UVioManager host loop on a seeded B-spline simulator (EuRoC
default noise, biased UWB anchors, SLAM landmarks) and records the
exact padded FrameBundles the host dispatches to the device, plus the
device state at the end of a warmup prefix. This gives benchmarks and
scaling studies REALISTIC inputs — chi2 gates see real residuals, SLAM
slots fill and re-anchor, UWB ranges accept/reject — instead of random
tensors (the reference benches on recorded datasets for the same
reason, `run_simulation.cpp`).
"""

from __future__ import annotations

import numpy as np


def capture_sim_bundles(
    n_warm: int = 20,
    n_bench: int = 100,
    seed: int = 7,
    max_slam: int = 25,
    dtype: str = "float32",
):
    """Returns (full_cfg, state0, bundles): the manager's FullStepConfig,
    the state snapshot after `n_warm` frames, and the next `n_bench`
    captured FrameBundles."""
    from ..manager import CameraConfig
    from ..sim import SimParams, Simulator, circle_trajectory
    from ..uwb_manager import AnchorConfig, UVioConfig, UVioManager

    uwb_anchors = {
        1: (np.array([4.0, 4.0, 2.0]), 0.15, 0.01),
        2: (np.array([-4.0, 4.0, 0.5]), -0.1, 0.005),
        3: (np.array([-4.0, -4.0, 2.5]), 0.2, 0.0),
        4: (np.array([4.0, -4.0, 1.0]), 0.0, 0.02),
    }
    sim = Simulator(
        SimParams(
            sim_freq_imu=200.0,
            sim_freq_cam=10.0,
            num_pts=60,
            seed=seed,
            uwb_anchors=uwb_anchors,
        ),
        trajectory=circle_trajectory(duration=(n_warm + n_bench) / 10.0 + 8.0),
    )
    cam = sim.params.cameras[0]
    rng = np.random.default_rng(1)
    anchor_cfgs = [
        AnchorConfig(
            anchor_id=aid,
            p_AinG=p + rng.normal(scale=0.05, size=3),
            prior_cov=np.diag([0.05**2] * 3 + [0.25**2, 0.025**2]),
        )
        for aid, (p, g, a) in uwb_anchors.items()
    ]
    cfg = UVioConfig(
        max_clones=11,
        max_msckf_in_update=40,
        max_slam=max_slam,
        sigma_pix=sim.params.sigma_pix,
        cameras=[
            CameraConfig(
                model=cam.model,
                intrinsics=cam.intrinsics,
                q_ItoC=cam.q_ItoC,
                p_IinC=cam.p_IinC,
            )
        ],
        max_anchors=len(anchor_cfgs),
        anchors=anchor_cfgs,
        sigma_range=sim.params.sigma_range,
        dtype=dtype,
    )
    mgr = UVioManager(cfg)
    gt0 = sim.get_gt_state(sim.t_start)
    mgr.initialize_with_gt(
        sim.t_start, gt0["q_GtoI"], gt0["p_IinG"], gt0["v_IinG"], gt0["bg"], gt0["ba"]
    )

    bundles, snap = [], {}
    orig = mgr._jit_full

    def capture(state, fb):
        if len(bundles) == n_warm and "state" not in snap:
            snap["state"] = state
        bundles.append(fb)
        return orig(state, fb)

    mgr._jit_full = capture
    frames = 0
    while sim.ok() and frames < n_warm + n_bench:
        r = sim.get_next_imu()
        if r is None:
            break
        t, wm, am = r
        mgr.feed_imu(t, wm, am)
        if sim.cur_uwb_t + 1.0 / sim.params.uwb_freq <= t:
            ru = sim.get_next_uwb()
            if ru is not None:
                mgr.feed_uwb(*ru)
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= t:
            rc = sim.get_next_cam()
            if rc is None:
                break
            mgr.feed_features(*rc)
            frames += 1

    return mgr._full_cfg, snap["state"], bundles[n_warm : n_warm + n_bench]


def render_image_stream(n_frames: int, duration: float = None, seed: int = 9):
    """Render a raw mono image stream from a seeded simulator run: the
    circle trajectory at 200 Hz IMU / 10 Hz camera, 90 map points drawn
    as blobs at the simulator camera's resolution (EuRoC 752x480).

    Returns (sim, imgs (F,H,W) float32, stamps (F,), imu (M,7) rows of
    t, w, a) with at most `n_frames` frames.
    """
    from ..sim import SimParams, Simulator, circle_trajectory

    sim = Simulator(
        SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=90, seed=seed),
        trajectory=circle_trajectory(
            duration=duration if duration is not None else 8.0 + n_frames / 10.0
        ),
    )
    imgs, stamps, imu = [], [], []
    while sim.ok() and len(imgs) < n_frames:
        r = sim.get_next_imu()
        if r is None:
            break
        t, wm, am = r
        imu.append((t, *wm, *am))
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= t:
            tc = sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam
            sim.cur_cam_t = tc
            imgs.append(sim.render_image(tc).astype(np.float32))
            stamps.append(tc)
    return sim, np.stack(imgs), np.asarray(stamps), np.asarray(imu)


def gt_initial_state(sim, layout, t: float, dtype="float32"):
    """Filter state at groundtruth for `t`, with the simulator camera's
    calibration and a small diagonal prior on the IMU block: the start
    state of the fused image -> pose step (`frontend/fused_vio.py`)."""
    import jax.numpy as jnp

    from ..types import init_state

    cam = sim.params.cameras[0]
    g0 = sim.get_gt_state(t)
    st = init_state(layout, dtype=dtype)
    return st.replace(
        time=jnp.asarray(t, jnp.float64),
        q=jnp.asarray(g0["q_GtoI"], dtype),
        p=jnp.asarray(g0["p_IinG"], dtype),
        v=jnp.asarray(g0["v_IinG"], dtype),
        bg=jnp.asarray(g0["bg"], dtype),
        ba=jnp.asarray(g0["ba"], dtype),
        q_fej=jnp.asarray(g0["q_GtoI"], dtype),
        p_fej=jnp.asarray(g0["p_IinG"], dtype),
        v_fej=jnp.asarray(g0["v_IinG"], dtype),
        calib_cam_q=jnp.asarray(cam.q_ItoC, dtype)[None],
        calib_cam_p=jnp.asarray(cam.p_IinC, dtype)[None],
        calib_cam_intr=jnp.asarray(cam.intrinsics, dtype)[None],
        cov=jnp.asarray(
            np.diag([1e-5] * 6 + [1e-4] * 3 + [1e-5] * 6
                    + [0.0] * (layout.dim - 15)), dtype),
    )
