"""End-to-end simulated VIO run (the `run_simulation` equivalent).

Generates seeded IMU + feature tracks from the B-spline simulator,
runs the MSCKF manager initialized from groundtruth, and reports ATE
and NEES against the exact simulated trajectory.

Usage:
    PYTHONPATH=. python examples/sim_vio.py [--duration 30] [--cpu]
"""

import argparse
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--imu-hz", type=float, default=200.0)
    ap.add_argument("--cam-hz", type=float, default=10.0)
    ap.add_argument("--num-pts", type=int, default=50)
    ap.add_argument("--max-slam", type=int, default=0)
    ap.add_argument("--static-init", action="store_true")
    ap.add_argument("--dynamic-init", action="store_true")
    ap.add_argument("--zupt", action="store_true")
    ap.add_argument("--uwb", action="store_true", help="UWB-aided (UVIO) mode")
    ap.add_argument(
        "--klt", action="store_true",
        help="run the real KLT frontend on rendered frames instead of the sim tracker",
    )
    ap.add_argument(
        "--still-time", type=float, default=None,
        help="stationary prefix seconds (default: 6 when --static-init, "
        "else 0 — static init needs a still start to detect)",
    )
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--record", type=str, default=None,
                    help="directory to write est.txt/gt.txt TUM trajectories")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    import uvio_jax  # noqa: F401
    from uvio_jax.manager import CameraConfig, VioConfig, VioManager
    from uvio_jax.sim import SimParams, Simulator, circle_trajectory
    from uvio_jax.eval import ate, nees

    uwb_anchors = {}
    if args.uwb:
        uwb_anchors = {
            1: (np.array([4.0, 4.0, 2.0]), 0.15, 0.01),
            2: (np.array([-4.0, 4.0, 0.5]), -0.1, 0.005),
            3: (np.array([-4.0, -4.0, 2.5]), 0.2, 0.0),
            4: (np.array([4.0, -4.0, 1.0]), 0.0, 0.02),
        }
    if args.still_time is None:
        args.still_time = 6.0 if args.static_init else 0.0
    sim = Simulator(
        SimParams(
            sim_freq_imu=args.imu_hz,
            sim_freq_cam=args.cam_hz,
            num_pts=args.num_pts,
            seed=args.seed,
            uwb_anchors=uwb_anchors,
        ),
        trajectory=circle_trajectory(
            duration=args.duration + 6.0 + args.still_time, still_time=args.still_time
        ),
    )
    cam = sim.params.cameras[0]
    cam_cfgs = [
        CameraConfig(
            model=cam.model,
            intrinsics=cam.intrinsics,
            q_ItoC=cam.q_ItoC,
            p_IinC=cam.p_IinC,
        )
    ]
    if args.uwb:
        from uvio_jax.uwb_manager import AnchorConfig, UVioConfig, UVioManager

        rng = np.random.default_rng(1)
        anchor_cfgs = [
            AnchorConfig(
                anchor_id=aid,
                p_AinG=p + rng.normal(scale=0.05, size=3),  # imperfect prior
                gamma=0.0,
                alpha=0.0,
                prior_cov=np.diag([0.05**2] * 3 + [0.25**2, 0.025**2]),
            )
            for aid, (p, g, a) in uwb_anchors.items()
        ]
        cfg = UVioConfig(
            max_clones=11,
            max_msckf_in_update=40,
            max_slam=args.max_slam,
            use_static_init=args.static_init,
            use_dynamic_init=args.dynamic_init,
            try_zupt=args.zupt,
            sigma_pix=sim.params.sigma_pix,
            cameras=cam_cfgs,
            max_anchors=len(anchor_cfgs),
            anchors=anchor_cfgs,
            sigma_range=sim.params.sigma_range,
        )
        mgr = UVioManager(cfg)
    else:
        cfg = VioConfig(
            max_clones=11,
            max_msckf_in_update=40,
            max_slam=args.max_slam,
            use_static_init=args.static_init,
            use_dynamic_init=args.dynamic_init,
            try_zupt=args.zupt,
            sigma_pix=sim.params.sigma_pix,
            cameras=cam_cfgs,
        )
        mgr = VioManager(cfg)

    if not (args.static_init or args.dynamic_init):
        gt0 = sim.get_gt_state(sim.t_start)
        mgr.initialize_with_gt(
            sim.t_start, gt0["q_GtoI"], gt0["p_IinG"], gt0["v_IinG"], gt0["bg"], gt0["ba"]
        )

    tracker = None
    if args.klt:
        from uvio_jax.frontend.tracker import KLTTracker

        tracker = KLTTracker(cam.intrinsics, cam.model, num_features=120, grid=(6, 8))

    est_t, est_q, est_p = [], [], []
    gt_q, gt_p = [], []
    cov_o, cov_p = [], []
    t_wall0 = time.time()
    frames = 0
    while sim.ok():
        r = sim.get_next_imu()
        if r is None:
            break
        t, wm, am = r
        mgr.feed_imu(t, wm, am)
        if args.uwb and sim.cur_uwb_t + 1.0 / sim.params.uwb_freq <= t:
            ru = sim.get_next_uwb()
            if ru is not None:
                mgr.feed_uwb(*ru)
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= t:
            rc = sim.get_next_cam()
            if rc is None:
                break
            tc, obs = rc
            if tracker is not None:
                img = sim.render_image(tc)
                ids, uvs = tracker.feed(tc, img)
                obs = [(ids, uvs)]
            mgr.feed_features(tc, obs)
            if not mgr.is_initialized:
                continue
            frames += 1
            st = mgr.state
            est_t.append(tc)
            est_q.append(np.asarray(st.q))
            est_p.append(np.asarray(st.p))
            g = sim.get_gt_state(tc)
            gt_q.append(g["q_GtoI"])
            gt_p.append(g["p_IinG"])
            P = np.asarray(st.cov)
            cov_o.append(P[0:3, 0:3])
            cov_p.append(P[3:6, 3:6])
            if frames % 50 == 0:
                ep = np.linalg.norm(est_p[-1] - gt_p[-1])
                print(f"t={tc - sim.t_start:6.2f}s frames={frames} |p_err|={ep:.3f} m")
        if est_t and est_t[-1] - sim.t_start > args.duration:
            break
    wall = time.time() - t_wall0

    est_t = np.asarray(est_t)
    if args.record:
        import os as _os

        from uvio_jax.eval import save_tum

        _os.makedirs(args.record, exist_ok=True)
        save_tum(_os.path.join(args.record, "est.txt"), est_t, np.asarray(est_q), np.asarray(est_p))
        save_tum(_os.path.join(args.record, "gt.txt"), est_t, np.asarray(gt_q), np.asarray(gt_p))
        print(f"recorded TUM trajectories to {args.record}/")
    # self-initialized runs define their own origin/yaw: align with posyaw
    # (the observability-aware alignment the reference defaults to)
    method = "posyaw" if (args.static_init or args.dynamic_init) else "none"
    res = ate(
        est_t,
        np.asarray(est_q),
        np.asarray(est_p),
        est_t,
        np.asarray(gt_q),
        np.asarray(gt_p),
        method=method,
    )
    if args.static_init or args.dynamic_init:
        n_o = n_p = np.array([np.nan])  # NEES needs a shared frame (gt init)
    else:
        n_o, n_p = nees(
            np.asarray(est_q),
            np.asarray(est_p),
            np.asarray(cov_o),
            np.asarray(cov_p),
            np.asarray(gt_q),
            np.asarray(gt_p),
        )
    sim_dur = est_t[-1] - est_t[0]
    print(
        f"\nframes={frames} wall={wall:.1f}s ({frames / wall:.1f} fps, "
        f"{sim_dur / wall:.2f}x realtime)"
    )
    print(f"ATE  rmse_pos = {res['rmse_pos']:.4f} m   rmse_ori = {res['rmse_ori_deg']:.3f} deg")
    print(f"NEES ori median = {np.median(n_o):.2f}  pos median = {np.median(n_p):.2f}  (target ~3)")
    return res, (n_o, n_p)


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
