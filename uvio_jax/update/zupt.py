"""Zero-velocity update (ZUPT).

Equivalent of `ov_msckf/src/update/UpdaterZeroVelocity.{h,cpp}`: stack
per-IMU-sample residuals

    r_w = w_m - bg              (gyro says not rotating)
    r_a = a_m - ba - R_GtoI g   (accel says only gravity)

over the padded IMU batch, with Jacobians into [theta, bg, ba], whiten
by the (noise-multiplied) continuous noise, chi2-test plus a velocity
norm test, and if accepted apply the EKF update and tell the manager to
*skip* propagation/cloning for this frame (the reference's early-return
path, `UpdaterZeroVelocity.cpp:65-330`; the image-disparity variant is
host-side in the manager).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..filter.ekf import ekf_update
from ..filter.propagator import NoiseManager
from ..math import quat_to_rot, skew
from ..math.chi2 import chi2_95
from ..types.layout import StateLayout
from ..types.state import FilterState


def _inertial_system(state, layout, imu_t, imu_w, imu_a, noises, gravity_mag, noise_mult):
    """Stacked zero-motion inertial residual system over the padded IMU
    batch. Returns (Hm, rm, r_diag, rmask, dof, max_dof)."""
    L = layout
    D = L.dim
    dtype = state.cov.dtype
    imu_w = imu_w.astype(dtype)
    imu_a = imu_a.astype(dtype)
    M = imu_t.shape[0]
    dts = jnp.diff(imu_t)
    valid = dts > 0
    n_valid = jnp.sum(valid) + 1
    dt_avg = jnp.sum(jnp.where(valid, dts, 0.0)) / jnp.maximum(jnp.sum(valid), 1)

    gravity = jnp.array([0.0, 0.0, gravity_mag], dtype=dtype)
    # residual at the CURRENT attitude (the reference's a_hat - Rot()*g,
    # `UpdaterZeroVelocity.cpp:163-166`); only the Jacobian linearizes
    # at FEJ. Using the FEJ attitude in the residual poisons long ZUPT
    # holds: no propagation happens while frozen, so q_fej goes stale
    # while q keeps being corrected, and the stale-residual chi2 creeps
    # up until the ZUPT permanently rejects.
    Rg = quat_to_rot(state.q) @ gravity
    Rg_fej = quat_to_rot(state.q_fej) @ gravity

    # rows: per sample [r_w(3); r_a(3)] with the innovation convention
    # res = z - h(x) ~ +H dx (ekf_update applies x += K res): the
    # measurement models are h_w = bg (+w_true=0) and h_a = ba + R g, so
    # H_bg = +I, H_ba = +I, H_theta = +[R_fej g]x. (The reference writes
    # the equivalent all-negated pair res = -w_hat with H = -I,
    # UpdaterZeroVelocity.cpp:162-180.)
    r_w = imu_w - state.bg[None, :]
    r_a = imu_a - state.ba[None, :] - Rg[None, :]
    smask = jnp.concatenate([jnp.array([True]), valid])  # first sample + valid steps

    H_one = jnp.zeros((6, D), dtype)
    H_one = H_one.at[3:6, L.theta_off : L.theta_off + 3].set(skew(Rg_fej))
    H_one = H_one.at[0:3, L.bg_off : L.bg_off + 3].set(jnp.eye(3, dtype=dtype))
    H_one = H_one.at[3:6, L.ba_off : L.ba_off + 3].set(jnp.eye(3, dtype=dtype))

    H = jnp.tile(H_one, (M, 1))  # (6M, D)
    res = jnp.concatenate([r_w, r_a], axis=1).reshape(-1)  # (6M,)
    safe_dt = jnp.where(dt_avg > 0, dt_avg, 1.0)
    sig_w2 = noise_mult * noises.sigma_w**2 / safe_dt
    sig_a2 = noise_mult * noises.sigma_a**2 / safe_dt
    r_diag = jnp.tile(
        jnp.concatenate([jnp.full(3, sig_w2, dtype), jnp.full(3, sig_a2, dtype)]), M
    )
    rmask = jnp.repeat(smask, 6)
    dt_sum = jnp.sum(jnp.where(valid, dts, 0.0))
    return H * rmask[:, None], res * rmask, r_diag, rmask, 6 * n_valid, 6 * M, dt_sum


def _compress(layout, Hm, rm, r_diag, rmask, noise_mult):
    """Whiten + QR-compress the stacked system to its 9 structural
    columns [theta, bg, ba], mirroring the reference's
    `measurement_compress_inplace` before the chi2
    (UpdaterZeroVelocity.cpp:186-193): the gate then tests only the
    9-dof projection of the residual (dof = res.rows() = 9), not the
    thousands of noise-only components orthogonal to the Jacobian.

    Returns (Hc (9,D), rc (9,), R_meas = noise_mult * I9).
    """
    L = layout
    D = L.dim
    dtype = Hm.dtype
    # whiten rows by the raw discrete sigma; the zupt noise multiplier
    # becomes the post-compression R = mult * I (reference order)
    w = jnp.where(rmask, 1.0 / jnp.sqrt(r_diag / noise_mult), 0.0)
    cols = jnp.concatenate(
        [
            jnp.arange(L.theta_off, L.theta_off + 3),
            jnp.arange(L.bg_off, L.bg_off + 3),
            jnp.arange(L.ba_off, L.ba_off + 3),
        ]
    )
    Hs = (Hm * w[:, None])[:, cols]  # (6M, 9)
    rw = rm * w
    Q9, R9 = jnp.linalg.qr(Hs, mode="reduced")  # (6M,9),(9,9)
    rc = Q9.T @ rw
    Hc = jnp.zeros((9, D), dtype).at[:, cols].set(R9)
    return Hc, rc


def _bias_inflated_cov(state, layout, noises, dt_sum):
    """Covariance with the bias random walk over the window added
    (`model_time_varying_bias`, UpdaterZeroVelocity.cpp:195-204 +
    268-276: Q_bias = dt_summed * sigma_b^2 enters both the chi2 gate
    and, on accept, the pre-update bias propagation)."""
    L = layout
    dtype = state.cov.dtype
    q = jnp.zeros((L.dim,), dtype)
    # dt_sum is on the f64 time axis; cast to the compute dtype
    q = q.at[L.bg_off : L.bg_off + 3].set((dt_sum * noises.sigma_wb**2).astype(dtype))
    q = q.at[L.ba_off : L.ba_off + 3].set((dt_sum * noises.sigma_ab**2).astype(dtype))
    return state.cov + jnp.diag(q)


def _gate(cov, state, Hm, rm, r_diag, rmask, dof, max_dof, chi2_mult, max_velocity):
    """chi2 + velocity-norm acceptance gate. Returns (accept, gamma).
    `cov` is the (bias-inflated) covariance used for the innovation."""
    PHt = cov @ Hm.T
    S = Hm @ PHt + jnp.diag(jnp.where(rmask, r_diag, 1.0))
    chol = jax.scipy.linalg.cho_factor(0.5 * (S + S.T), lower=True)
    gamma = rm @ jax.scipy.linalg.cho_solve(chol, rm)
    accept = (gamma < chi2_mult * chi2_95(dof, max_dof=max_dof)) & (
        jnp.linalg.norm(state.v) < max_velocity
    )
    return accept, gamma


def zupt_try_update(
    state: FilterState,
    layout: StateLayout,
    imu_t: jnp.ndarray,
    imu_w: jnp.ndarray,
    imu_a: jnp.ndarray,
    noises: NoiseManager,
    gravity_mag: float,
    chi2_mult: float = 1.0,
    noise_mult: float = 10.0,
    max_velocity: float = 0.1,
    stamp_time: jnp.ndarray = None,
):
    """Returns (new_state, accepted, chi2). Applies the update only when
    the chi2 + velocity gates pass (lax.cond inside). `stamp_time` is
    the camera-clock frame time stored on accept (imu_t spans the
    offset-shifted IMU-clock window when dt calibration is active)."""
    L = layout
    Hm, rm, r_diag, rmask, dof, max_dof, dt_sum = _inertial_system(
        state, L, imu_t, imu_w, imu_a, noises, gravity_mag, noise_mult
    )
    Hc, rc = _compress(L, Hm, rm, r_diag, rmask, noise_mult)
    cov_infl = _bias_inflated_cov(state, L, noises, dt_sum)
    rc_diag = jnp.full((9,), noise_mult, state.cov.dtype)
    accept, gamma = _gate(
        cov_infl, state, Hc, rc, rc_diag, jnp.ones((9,), bool),
        jnp.int32(9), 9, chi2_mult, max_velocity,
    )

    def do(st):
        # bias random-walk propagation before the update (the reference's
        # EKFPropagation(Phi=I, Q_bias) on accept)
        st = st.replace(cov=cov_infl)
        new_st, _ = ekf_update(st, L, Hc, rc, rc_diag, jnp.ones((9,), bool))
        return new_st.replace(
            time=imu_t[-1] if stamp_time is None else stamp_time
        )

    new_state = jax.lax.cond(accept, do, lambda s: s, state)
    return new_state, accept, gamma


def zupt_explicit_update(
    state: FilterState,
    layout: StateLayout,
    imu_t: jnp.ndarray,
    imu_w: jnp.ndarray,
    imu_a: jnp.ndarray,
    noises: NoiseManager,
    gravity_mag: float,
    chi2_mult: float = 1.0,
    noise_mult: float = 10.0,
    max_velocity: float = 0.1,
    stamp_time: jnp.ndarray = None,
    integration: str = "rk4",
):
    """Explicit zero-motion variant (`UpdaterZeroVelocity.cpp:283-330`,
    `explicitly_enforce_zero_motion`): gate exactly like the inertial
    variant, but on accept PROPAGATE mean+cov through the IMU window and
    constrain the propagated IMU pose to the newest clone with a 9-dof
    pseudo-measurement [log(R_I R_c^T); p_I - p_c; v] = 0.

    The reference clones at the new time, constrains the clone pair, and
    immediately marginalizes the new clone; constraining the propagated
    IMU state against the newest clone is the same measurement without
    the transient slot traffic (static-slot friendly). Falls back to the
    inertial update when no clone exists yet.

    Returns (new_state, accepted, chi2).
    """
    from ..filter.propagator import propagate_mean_cov
    from ..math import log_so3

    L = layout
    D = L.dim
    dtype = state.cov.dtype
    Hm, rm, r_diag, rmask, dof, max_dof, dt_sum = _inertial_system(
        state, L, imu_t, imu_w, imu_a, noises, gravity_mag, noise_mult
    )
    Hc9, rc9 = _compress(L, Hm, rm, r_diag, rmask, noise_mult)
    accept_gate, gamma = _gate(
        _bias_inflated_cov(state, L, noises, dt_sum), state,
        Hc9, rc9, jnp.full((9,), noise_mult, dtype), jnp.ones((9,), bool),
        jnp.int32(9), 9, chi2_mult, max_velocity,
    )
    has_clone = state.clone_head >= 0

    def do_explicit(st):
        st, _ = propagate_mean_cov(
            st, L, imu_t, imu_w, imu_a, noises, gravity_mag,
            integration=integration, stamp_time=stamp_time,
        )
        slot = jnp.maximum(st.clone_head, 0)
        qc = st.clones_q[slot]
        pc = st.clones_p[slot]
        R_I = quat_to_rot(st.q)
        R_c = quat_to_rot(qc)
        # res = 0 - h with h = [log(R_I R_c^T); p_I - p_c; v]
        res = jnp.concatenate(
            [-log_so3(R_I @ R_c.T), -(st.p - pc), -st.v]
        ).astype(dtype)
        # Jacobians at FEJ (error convention R = (I - [th]x) R_hat):
        # dh_ori/dth_I = -I, dh_ori/dth_c = R_I R_c^T (~= I at zero motion)
        R_If = quat_to_rot(st.q_fej)
        R_cf = quat_to_rot(st.clones_q_fej[slot])
        D_hat = (R_If @ R_cf.T).astype(dtype)
        I3 = jnp.eye(3, dtype=dtype)
        H = jnp.zeros((9, D), dtype)
        H = H.at[0:3, L.theta_off : L.theta_off + 3].set(-I3)
        H = H.at[3:6, L.p_off : L.p_off + 3].set(I3)
        H = H.at[6:9, L.v_off : L.v_off + 3].set(I3)
        coff = jnp.asarray(L.clone_slot_off(slot), jnp.int32)
        zero = jnp.zeros((), jnp.int32)
        H = jax.lax.dynamic_update_slice(H, D_hat, (zero, coff))
        H = jax.lax.dynamic_update_slice(H, -I3, (zero + 3, coff + 3))
        # noise (ori, pos, vel) — reference's fixed pseudo-noise
        r9 = jnp.concatenate(
            [jnp.full(3, 1e-2**2, dtype), jnp.full(3, 1e-1**2, dtype),
             jnp.full(3, 1e-1**2, dtype)]
        )
        new_st, _ = ekf_update(st, L, H, res, r9, jnp.ones(9, bool))
        return new_st

    def do_inertial(st):
        # mirror zupt_try_update's accept path exactly: bias random-walk
        # inflation, then the 9-dof compressed system (the gate above
        # tested this same compressed system against the inflated cov)
        st = st.replace(cov=_bias_inflated_cov(st, L, noises, dt_sum))
        new_st, _ = ekf_update(
            st, L, Hc9, rc9,
            jnp.full((9,), noise_mult, dtype), jnp.ones((9,), bool),
        )
        return new_st.replace(
            time=imu_t[-1] if stamp_time is None else stamp_time
        )

    new_state = jax.lax.cond(
        accept_gate,
        lambda s: jax.lax.cond(has_clone, do_explicit, do_inertial, s),
        lambda s: s,
        state,
    )
    return new_state, accept_gate, gamma
