"""UWB range update tests: Jacobian vs autodiff, chi2 rejection,
anchor/extrinsic calibration convergence, and the UVIO manager drain."""

import jax
import jax.numpy as jnp
import pytest
import numpy as np
from scipy.spatial.transform import Rotation as Rsp

from uvio_jax.math import quat_to_rot, rot_to_quat
from uvio_jax.types import StateLayout, init_state
from uvio_jax.update.uwb import _range_jacobian, predicted_range, uwb_update

RNG = np.random.default_rng(2)


def make_state(layout, n_anchors=3):
    s = init_state(layout)
    R = Rsp.from_euler("xyz", [10, -5, 30], degrees=True).as_matrix()
    q = rot_to_quat(jnp.asarray(R))
    s = s.replace(
        q=q, q_fej=q,
        p=jnp.asarray([1.0, 2.0, 0.5]), p_fej=jnp.asarray([1.0, 2.0, 0.5]),
        uwb_p_IinU=jnp.asarray([0.05, -0.02, 0.1]),
        cov=jnp.asarray(np.eye(layout.dim) * 1e-2),
        time=jnp.asarray(0.0),
    )
    for a in range(n_anchors):
        s = s.replace(
            anchors_p=s.anchors_p.at[a].set(jnp.asarray(RNG.uniform(-5, 5, 3))),
            anchors_gamma=s.anchors_gamma.at[a].set(0.1 * a),
            anchors_alpha=s.anchors_alpha.at[a].set(0.01 * a),
            anchors_valid=s.anchors_valid.at[a].set(True),
        )
    return s


def test_range_jacobian_matches_autodiff():
    layout = StateLayout(max_clones=3, max_anchors=3, calib_uwb_extrinsics=True)
    s = make_state(layout)

    for aidx in range(3):
        H, d = _range_jacobian(s, layout, jnp.int32(aidx))

        # numeric: perturb each state block through the boxplus used by inject
        from uvio_jax.filter.ekf import inject

        def yhat_of_dx(dx):
            sp = inject(s, layout, dx)
            # FEJ must follow for the Jacobian check (fej == value here)
            sp = sp.replace(q_fej=sp.q, p_fej=sp.p)
            y, _, _, _ = predicted_range(sp, jnp.int32(aidx))
            return y

        eps = 1e-7
        D = layout.dim
        cols = (
            list(range(0, 6))
            + list(range(layout.calib_uwb_off, layout.calib_uwb_off + 3))
            + list(range(layout.anchor_slot_off(aidx), layout.anchor_slot_off(aidx) + 5))
        )
        for c in cols:
            dx = np.zeros(D)
            dx[c] = eps
            num = (float(yhat_of_dx(jnp.asarray(dx))) - float(yhat_of_dx(jnp.zeros(D)))) / eps
            np.testing.assert_allclose(num, float(H[0, c]), atol=1e-5,
                                       err_msg=f"anchor {aidx} column {c}")


def test_uwb_update_reduces_error():
    layout = StateLayout(max_clones=3, max_anchors=3)
    s = make_state(layout)
    # true ranges from a slightly different position
    p_true = np.asarray(s.p) + np.array([0.2, -0.1, 0.05])
    R = quat_to_rot(s.q)
    p_U_true = p_true - np.asarray(R).T @ np.asarray(s.uwb_p_IinU)
    ranges = np.zeros(3)
    for a in range(3):
        d = np.linalg.norm(np.asarray(s.anchors_p[a]) - p_U_true)
        ranges[a] = (1 + float(s.anchors_alpha[a])) * d + float(s.anchors_gamma[a])
    ns, info = uwb_update(
        s, layout, jnp.asarray(ranges), jnp.ones(3, bool), sigma_range=0.05
    )
    assert bool(jnp.all(info["accepted"]))
    err0 = np.linalg.norm(np.asarray(s.p) - p_true)
    err1 = np.linalg.norm(np.asarray(ns.p) - p_true)
    assert err1 < err0


def test_uwb_chi2_rejects_outlier():
    layout = StateLayout(max_clones=3, max_anchors=3)
    s = make_state(layout)
    y0, _, _, _ = predicted_range(s, jnp.int32(0))
    ranges = np.array([float(y0) + 25.0, 0.0, 0.0])  # gross outlier
    mask = np.array([True, False, False])
    ns, info = uwb_update(s, layout, jnp.asarray(ranges), jnp.asarray(mask), sigma_range=0.05)
    assert not bool(info["accepted"][0])
    np.testing.assert_allclose(np.asarray(ns.p), np.asarray(s.p), atol=1e-12)


def test_uwb_invalid_anchor_ignored():
    layout = StateLayout(max_clones=3, max_anchors=3)
    s = make_state(layout, n_anchors=2)  # anchor 2 invalid
    ranges = np.array([0.0, 0.0, 3.0])
    mask = np.array([False, False, True])
    ns, info = uwb_update(s, layout, jnp.asarray(ranges), jnp.asarray(mask))
    assert not bool(info["accepted"][2])
    np.testing.assert_allclose(np.asarray(ns.cov), np.asarray(s.cov), atol=1e-12)


def test_uvio_manager_drain():
    from uvio_jax.uwb_manager import AnchorConfig, UVioConfig, UVioManager
    from uvio_jax.manager import CameraConfig

    anchors = [
        AnchorConfig(anchor_id=10, p_AinG=np.array([3.0, 0, 1.5])),
        AnchorConfig(anchor_id=11, p_AinG=np.array([-2.0, 2, 0.5]), fix=True),
    ]
    cfg = UVioConfig(
        max_clones=5, max_anchors=4, anchors=anchors, sigma_range=0.05,
        cameras=[CameraConfig()],
    )
    mgr = UVioManager(cfg)
    assert mgr.anchors_initialized
    # fixed anchor has zero covariance
    off = mgr.layout.anchor_slot_off(mgr.anchor_slot_by_id[11])
    P = np.asarray(mgr.state.cov)
    np.testing.assert_allclose(P[off : off + 5, off : off + 5], 0.0)
    off0 = mgr.layout.anchor_slot_off(mgr.anchor_slot_by_id[10])
    assert P[off0, off0] > 0

    mgr.initialize_with_gt(0.0, np.array([0, 0, 0, 1.0]), np.zeros(3), np.zeros(3),
                           np.zeros(3), np.zeros(3))
    for i in range(30):
        t = 0.005 * (i + 1)
        mgr.feed_imu(t, np.zeros(3), np.array([0, 0, 9.81]))
    # true range from p=0: |p_A| (lever arm zero)
    d10 = np.linalg.norm(anchors[0].p_AinG)
    # traveled-distance gate (UVioManager.cpp:64-67): ranges arriving
    # before the platform has moved past min_dist_to_use_uwb are dropped
    mgr.feed_uwb(0.04, {10: d10})
    assert len(mgr.uwb_buffer) == 0
    mgr.distance = 0.01  # pretend we've moved
    mgr.feed_uwb(0.05, {10: d10 + 0.01, 99: 5.0})  # unknown anchor dropped
    assert len(mgr.uwb_buffer) == 1
    assert 99 not in mgr.uwb_buffer[0][1]
    # drain happens before the visual update
    mgr._pre_visual_update(0.1)
    assert len(mgr.uwb_buffer) == 0
    assert float(mgr.state.time) >= 0.05 - 1e-9
    # out-of-order set dropped
    mgr.feed_uwb(0.02, {10: d10})
    assert len(mgr.uwb_buffer) == 0


def test_uvio_manager_preserves_base_config():
    """Regression: the UVIO subclass must not lose base-config state.

    Round-1 bug: UVioManager rebuilt the layout/state after the base
    ctor and dropped slam_rep, IMU-intrinsic calibration, the estimated
    camimu_dt seed, calibration priors, and the integration method
    (silently forcing rk4). The layout is now built once via
    `_layout_extras`, matching `UVioManager.cpp:26-55` which extends the
    base state instead of replacing it.
    """
    from uvio_jax.manager import CameraConfig
    from uvio_jax.uwb_manager import AnchorConfig, UVioConfig, UVioManager

    cfg = UVioConfig(
        max_clones=5,
        max_slam=10,
        feat_rep_slam=1,
        calib_cam_timeoffset=True,
        camimu_dt=0.03,
        calib_cam_pose=True,
        calib_imu_intrinsics=True,
        integration="discrete",
        max_anchors=4,
        calib_uwb_extrinsics=True,
        p_IinU=np.array([0.05, -0.02, 0.1]),
        anchors=[AnchorConfig(anchor_id=7, p_AinG=np.array([1.0, 2.0, 0.5]))],
        cameras=[CameraConfig()],
    )
    mgr = UVioManager(cfg)
    L = mgr.layout
    # layout keeps every base option AND the UWB extras
    assert L.slam_rep == 1
    assert L.max_slam == 10
    assert L.calib_imu_intrinsics
    assert L.calib_cam_timeoffset and L.calib_cam_pose
    assert L.max_anchors == 4 and L.calib_uwb_extrinsics
    # calib seeds survive
    assert float(mgr.state.calib_dt) == 0.03
    np.testing.assert_allclose(
        np.asarray(mgr.state.uwb_p_IinU), [0.05, -0.02, 0.1]
    )
    # calibration priors are non-zero (were silently zeroed in round 1)
    P = np.asarray(mgr.state.cov)
    assert P[L.calib_dt_off, L.calib_dt_off] > 0
    assert P[L.calib_cam_pose_off, L.calib_cam_pose_off] > 0
    assert P[L.imu_intr_off, L.imu_intr_off] > 0
    # anchor prior installed, UWB extrinsic prior installed
    off = L.anchor_slot_off(mgr.anchor_slot_by_id[7])
    assert P[off, off] > 0
    assert P[L.calib_uwb_off, L.calib_uwb_off] > 0
    # integration method reaches the jitted propagators
    assert mgr._jit_prop.__wrapped__.keywords["integration"] == "discrete"
    assert mgr._jit_prop_only.__wrapped__.keywords["integration"] == "discrete"


def test_runtime_anchor_initialization():
    """Anchors arriving at runtime: best-determinant fixed, others
    estimated; late additions supported."""
    from uvio_jax.manager import CameraConfig
    from uvio_jax.uwb_manager import AnchorConfig, UVioConfig, UVioManager

    cfg = UVioConfig(max_clones=4, max_anchors=6, cameras=[CameraConfig()])
    mgr = UVioManager(cfg)
    assert not mgr.anchors_initialized
    a_good = AnchorConfig(anchor_id=1, p_AinG=np.zeros(3), prior_cov=np.eye(5) * 1e-6)
    a_bad = AnchorConfig(anchor_id=2, p_AinG=np.ones(3), prior_cov=np.eye(5) * 1e-2)
    mgr.feed_anchors([a_bad, a_good], n_fix=1)
    assert mgr.anchors_initialized
    # best (smallest det) anchor is fixed: zero covariance block
    off_good = mgr.layout.anchor_slot_off(mgr.anchor_slot_by_id[1])
    off_bad = mgr.layout.anchor_slot_off(mgr.anchor_slot_by_id[2])
    P = np.asarray(mgr.state.cov)
    np.testing.assert_allclose(P[off_good : off_good + 5, off_good : off_good + 5], 0.0)
    assert P[off_bad, off_bad] > 0
    # late addition, already-known anchor ignored
    mgr.feed_anchors([a_good, AnchorConfig(anchor_id=3, p_AinG=np.ones(3) * 2)])
    assert 3 in mgr.anchor_slot_by_id
    assert len(mgr.anchor_slot_by_id) == 3


def _run_uwb_sim(dtype="float64", duration=10.0, seed=7, fused_frames_out=None):
    """Full UWB-aided run: 4 biased anchors with imperfect position
    priors (the bench.py configuration) — the e2e path that the round-2
    f32 constructor crash escaped because no test built a float32
    manager."""
    from uvio_jax.manager import CameraConfig
    from uvio_jax.sim import SimParams, Simulator, circle_trajectory
    from uvio_jax.uwb_manager import AnchorConfig, UVioConfig, UVioManager

    uwb_anchors = {
        1: (np.array([4.0, 4.0, 2.0]), 0.15, 0.01),
        2: (np.array([-4.0, 4.0, 0.5]), -0.1, 0.005),
        3: (np.array([-4.0, -4.0, 2.5]), 0.2, 0.0),
        4: (np.array([4.0, -4.0, 1.0]), 0.0, 0.02),
    }
    sim = Simulator(
        SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=50, seed=seed,
                  uwb_anchors=uwb_anchors),
        trajectory=circle_trajectory(duration=duration + 6.0),
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
        max_clones=11, max_msckf_in_update=40, max_slam=15,
        sigma_pix=sim.params.sigma_pix,
        cameras=[CameraConfig(model=cam.model, intrinsics=cam.intrinsics,
                              q_ItoC=cam.q_ItoC, p_IinC=cam.p_IinC)],
        max_anchors=4, anchors=anchor_cfgs, sigma_range=sim.params.sigma_range,
        dtype=dtype,
    )
    mgr = UVioManager(cfg)
    gt0 = sim.get_gt_state(sim.t_start)
    mgr.initialize_with_gt(sim.t_start, gt0["q_GtoI"], gt0["p_IinG"],
                           gt0["v_IinG"], gt0["bg"], gt0["ba"])
    est = {"t": [], "q": [], "p": []}
    gt = {"q": [], "p": []}
    frames = 0
    while sim.ok():
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
            tc, obs = rc
            mgr.feed_features(tc, obs)
            frames += 1
            st = mgr.state
            est["t"].append(tc)
            est["q"].append(np.asarray(st.q))
            est["p"].append(np.asarray(st.p))
            g = sim.get_gt_state(tc)
            gt["q"].append(g["q_GtoI"])
            gt["p"].append(g["p_IinG"])
        if est["t"] and est["t"][-1] - sim.t_start > duration:
            break
        if fused_frames_out is not None and frames >= fused_frames_out:
            break
    return ({k: np.asarray(v) for k, v in est.items()},
            {k: np.asarray(v) for k, v in gt.items()}, mgr)


def test_uvio_manager_f32_anchors_fused_frames():
    """Regression (round-2 BENCH crash): a float32 manager with anchors
    + imperfect priors must construct and run fused frames end-to-end.
    `uwb_manager.py` passed f64 prior blocks into the f32 covariance."""
    est, gt, mgr = _run_uwb_sim(dtype="float32", fused_frames_out=5)
    assert len(est["t"]) >= 5
    assert float(mgr.state.time) > 0.0
    assert np.isfinite(np.asarray(mgr.state.cov)).all()
    assert np.isfinite(est["p"]).all()
    # UWB sets were actually drained through the fused step
    assert np.asarray(mgr.last_uwb_info["accepted"]).any()


@pytest.mark.slow
def test_uwb_e2e_ate():
    """UWB e2e accuracy regression: 4 biased
    anchors, imperfect priors, ATE-gated. UWB must also beat pure VIO
    drift on position over the same stream."""
    from uvio_jax.eval import ate

    est, gt, _ = _run_uwb_sim(dtype="float64", duration=10.0)
    res = ate(est["t"], est["q"], est["p"], est["t"], gt["q"], gt["p"], method="none")
    assert res["rmse_pos"] < 0.12, res
    assert res["rmse_ori_deg"] < 1.2, res

