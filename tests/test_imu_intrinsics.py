"""IMU intrinsic calibration (Dw/Da scale+misalignment, Tg g-sensitivity,
gyro/acc frame rotation) — the reference's `StateOptions::do_calib_imu_intrinsics`
path (`State.h:91-135`, `Propagator.cpp:403-429, 830-960`)."""

import numpy as np
import pytest

import jax.numpy as jnp

from uvio_jax.filter.propagator import dm_matrix, tg_matrix, _h_dm, _h_tg
from uvio_jax.manager import CameraConfig, VioConfig, VioManager
from uvio_jax.sim import SimParams, Simulator, circle_trajectory
from uvio_jax.types.layout import IMU_MODEL_KALIBR, IMU_MODEL_RPNG, StateLayout
from uvio_jax.types.state import dm_identity


def test_dm_identity_roundtrip():
    for model in (IMU_MODEL_KALIBR, IMU_MODEL_RPNG):
        v = jnp.asarray(dm_identity(model))
        assert np.allclose(np.asarray(dm_matrix(v, model)), np.eye(3))


def test_dm_triangle_fill():
    v = jnp.arange(1.0, 7.0)
    Dk = np.asarray(dm_matrix(v, IMU_MODEL_KALIBR))
    # kalibr: lower triangle, column-wise (State::Dm, State.h:91-102)
    assert np.allclose(Dk, [[1, 0, 0], [2, 4, 0], [3, 5, 6]])
    Dr = np.asarray(dm_matrix(v, IMU_MODEL_RPNG))
    assert np.allclose(Dr, [[1, 2, 4], [0, 3, 5], [0, 0, 6]])
    Tg = np.asarray(tg_matrix(jnp.arange(1.0, 10.0)))
    assert np.allclose(Tg, np.arange(1.0, 10.0).reshape(3, 3).T)


def test_h_dm_h_tg_match_jacobians():
    """_h_dm / _h_tg must equal d(Dm v)/d(vec) and d(Tg a)/d(vec)."""
    import jax

    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal(3))
    for model in (IMU_MODEL_KALIBR, IMU_MODEL_RPNG):
        J = jax.jacobian(lambda vec: dm_matrix(vec, model) @ v)(
            jnp.asarray(rng.standard_normal(6))
        )
        assert np.allclose(np.asarray(J), np.asarray(_h_dm(v, model, jnp.float64)))
    a = jnp.asarray(rng.standard_normal(3))
    J = jax.jacobian(lambda vec: tg_matrix(vec) @ a)(jnp.asarray(rng.standard_normal(9)))
    assert np.allclose(np.asarray(J), np.asarray(_h_tg(a, jnp.float64)))


def test_layout_offsets():
    L = StateLayout(max_clones=5, calib_imu_intrinsics=True, calib_imu_g_sensitivity=True)
    assert L.imu_intr_dim == 24
    assert L.imu_dw_off == 15 and L.imu_da_off == 21
    assert L.imu_tg_off == 27 and L.imu_theta_off == 36
    assert L.calib_off == 39
    L2 = StateLayout(max_clones=5, calib_imu_intrinsics=True)
    assert L2.imu_intr_dim == 15 and L2.imu_theta_off == 27 and L2.calib_off == 30
    L3 = StateLayout(max_clones=5)
    assert L3.imu_intr_dim == 0 and L3.calib_off == 15


def _run(sim, cfg, duration=14.0):
    mgr = VioManager(cfg)
    g0 = sim.get_gt_state(sim.t_start)
    mgr.initialize_with_gt(
        sim.t_start, g0["q_GtoI"], g0["p_IinG"], g0["v_IinG"], g0["bg"], g0["ba"]
    )
    errs = []
    last_t = sim.t_start
    while sim.ok() and last_t - sim.t_start < duration:
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
            mgr.feed_features(tc, obs)
            g = sim.get_gt_state(tc)
            errs.append(np.linalg.norm(np.asarray(mgr.state.p) - g["p_IinG"]))
            last_t = tc
    return mgr, np.asarray(errs)


TRUE_DW = np.array([1.02, 0.004, -0.003, 0.985, 0.006, 1.01])
TRUE_DA = np.array([0.99, -0.005, 0.004, 1.015, -0.006, 0.98])


@pytest.mark.slow
def test_seeded_true_intrinsics_track():
    """Simulator applies inverse intrinsics to measurements; a filter
    seeded with the TRUE intrinsics must track as well as a perfect-IMU
    run (validates the correction chain `Propagator.cpp:403-429`)."""
    params = SimParams(seed=5, imu_dw=TRUE_DW, imu_da=TRUE_DA)
    sim = Simulator(params, trajectory=circle_trajectory(duration=24.0))
    cam = sim.params.cameras[0]
    cfg = VioConfig(
        max_clones=11,
        sigma_pix=sim.params.sigma_pix,
        imu_dw=TRUE_DW,
        imu_da=TRUE_DA,
        cameras=[CameraConfig(model=cam.model, intrinsics=cam.intrinsics,
                              q_ItoC=cam.q_ItoC, p_IinC=cam.p_IinC)],
    )
    _, errs = _run(sim, cfg)
    assert errs[-1] < 0.15, errs[-5:]


@pytest.mark.slow
def test_wrong_intrinsics_hurt_then_calibration_recovers():
    """Identity-seeded filter on a miscalibrated IMU drifts; enabling
    online intrinsic calibration must (a) keep tracking and (b) move the
    Dw/Da estimates toward truth."""
    def fresh_sim():
        return Simulator(
            SimParams(seed=5, imu_dw=TRUE_DW, imu_da=TRUE_DA),
            trajectory=circle_trajectory(duration=24.0),
        )

    sim = fresh_sim()
    cam = sim.params.cameras[0]
    cam_cfg = [CameraConfig(model=cam.model, intrinsics=cam.intrinsics,
                            q_ItoC=cam.q_ItoC, p_IinC=cam.p_IinC)]
    base = dict(max_clones=11, sigma_pix=sim.params.sigma_pix, cameras=cam_cfg)

    # 20 s: under FEJ the calibrated run transiently trades accuracy
    # while Dw/Da converge (~t=14 s crossover on this trajectory), then
    # clearly beats the drifting miscalibrated run
    _, errs_wrong = _run(fresh_sim(), VioConfig(**base), duration=20.0)
    mgr, errs_cal = _run(
        fresh_sim(),
        VioConfig(**base, calib_imu_intrinsics=True, calib_imu_dw_prior=0.03, calib_imu_da_prior=0.03),
        duration=20.0,
    )

    err0_dw = np.linalg.norm(np.asarray(dm_identity(0)) - TRUE_DW)
    err1_dw = np.linalg.norm(np.asarray(mgr.state.calib_imu_dw) - TRUE_DW)
    err0_da = np.linalg.norm(np.asarray(dm_identity(0)) - TRUE_DA)
    err1_da = np.linalg.norm(np.asarray(mgr.state.calib_imu_da) - TRUE_DA)
    # combined intrinsic error must shrink markedly
    assert err1_dw + err1_da < 0.6 * (err0_dw + err0_da), (
        (err0_dw, err1_dw), (err0_da, err1_da)
    )
    # and the calibrated run must end at least as accurate as the
    # miscalibrated one; compare mean error over the last quarter of the
    # run (a single final-frame sample is noise-dominated at this scale)
    q = max(1, len(errs_cal) // 4)
    tail_cal = float(np.mean(errs_cal[-q:]))
    tail_wrong = float(np.mean(errs_wrong[-q:]))
    assert tail_cal < max(0.2, 1.1 * tail_wrong), (tail_cal, tail_wrong)
