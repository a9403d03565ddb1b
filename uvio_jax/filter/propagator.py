"""IMU propagation as a fused scan.

JAX equivalent of `ov_msckf/src/state/Propagator.{h,cpp}`:
the per-sample loop (`Propagator.cpp:83-99` predict_and_compute with
Phi/Qd product-sum accumulation) becomes one `lax.scan` over a padded
IMU batch; boundary interpolation (`select_imu_readings`) happens on the
host (pure data plumbing).

Mean integration: RK4 over the IMU kinematics (predict_mean_rk4,
`Propagator.cpp:507-620`); error-state transition: the discrete
closed-form F/G (`compute_F_and_G_discrete`, `Propagator.cpp:830-960`,
without IMU-intrinsic calib blocks) evaluated with averaged w/a and
first-estimate (FEJ) linearization points.

Padded samples carry dt=0 and contribute exactly F=I, Qd=0.

Error order within the 15-dof IMU block: theta p v bg ba.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..math import (
    exp_so3,
    jr_so3,
    log_so3,
    omega,
    quat_multiply,
    quat_norm,
    quat_to_rot,
    rot_to_quat,
    skew,
)
from ..types.layout import IMU_MODEL_KALIBR, StateLayout
from ..types.state import FilterState
from .ekf import augment_clone, propagate_covariance


# ---------------------------------------------------------------------------
# IMU intrinsics (State::Dm / State::Tg, `State.h:91-135`)
# ---------------------------------------------------------------------------


def dm_matrix(vec, imu_model: int):
    """3x3 scale/misalignment matrix from its 6-vector.

    KALIBR fills the lower triangle column-wise, RPNG the upper
    triangle (`State::Dm`)."""
    z = jnp.zeros((), vec.dtype)
    if imu_model == IMU_MODEL_KALIBR:
        rows = [
            jnp.stack([vec[0], z, z]),
            jnp.stack([vec[1], vec[3], z]),
            jnp.stack([vec[2], vec[4], vec[5]]),
        ]
    else:
        rows = [
            jnp.stack([vec[0], vec[1], vec[3]]),
            jnp.stack([z, vec[2], vec[4]]),
            jnp.stack([z, z, vec[5]]),
        ]
    return jnp.stack(rows)


def tg_matrix(vec):
    """3x3 gravity-sensitivity matrix, column-wise fill (`State::Tg`)."""
    return vec.reshape(3, 3).T


def _h_dm(v, imu_model: int, dtype):
    """d(Dm @ v)/d(vec) — (3, 6) (`Propagator::compute_H_Dw/H_Da`)."""
    z = jnp.zeros((), dtype)
    if imu_model == IMU_MODEL_KALIBR:
        # cols: v1*I3 | v2*e2 | v2*e3 | v3*e3
        rows = [
            jnp.stack([v[0], z, z, z, z, z]),
            jnp.stack([z, v[0], z, v[1], z, z]),
            jnp.stack([z, z, v[0], z, v[1], v[2]]),
        ]
    else:
        # cols: v1*e1 | v2*e1 | v2*e2 | v3*I3
        rows = [
            jnp.stack([v[0], v[1], z, v[2], z, z]),
            jnp.stack([z, z, v[1], z, v[2], z]),
            jnp.stack([z, z, z, z, z, v[2]]),
        ]
    return jnp.stack(rows)


def _h_tg(a, dtype):
    """d(Tg @ a)/d(vec) — (3, 9) = [a1*I3, a2*I3, a3*I3]
    (`Propagator::compute_H_Tg`)."""
    eye3 = jnp.eye(3, dtype=dtype)
    return jnp.concatenate([a[0] * eye3, a[1] * eye3, a[2] * eye3], axis=1)


@dataclasses.dataclass(frozen=True)
class NoiseManager:
    """Continuous-time IMU noise sigmas (`ov_core` NoiseManager)."""

    sigma_w: float = 1.6968e-04  # gyro white noise (rad/s/sqrt(hz))
    sigma_wb: float = 1.9393e-05  # gyro bias walk
    sigma_a: float = 2.0000e-3  # accel white noise
    sigma_ab: float = 3.0000e-03  # accel bias walk


def _rk4_mean(q, p, v, w1, a1, w2, a2, dt, gravity):
    """RK4 integration of q_GtoI, p, v (predict_mean_rk4 behavior)."""
    safe_dt = jnp.where(dt > 0, dt, 1.0)
    w_alpha = (w2 - w1) / safe_dt
    a_jerk = (a2 - a1) / safe_dt

    q0 = q

    def deriv(dq, vv, w_hat, a_hat):
        q_dot = 0.5 * omega(w_hat) @ dq
        R_Gto = quat_to_rot(quat_multiply(dq, q0))
        v_dot = R_Gto.T @ a_hat - gravity
        return q_dot, vv, v_dot

    dq0 = jnp.array([0.0, 0.0, 0.0, 1.0], dtype=q.dtype)
    # k1
    k1_q, k1_p, k1_v = deriv(dq0, v, w1, a1)
    # k2 (midpoint)
    w_mid = w1 + 0.5 * w_alpha * dt
    a_mid = a1 + 0.5 * a_jerk * dt
    dq1 = quat_norm(dq0 + 0.5 * k1_q * dt)
    k2_q, k2_p, k2_v = deriv(dq1, v + 0.5 * k1_v * dt, w_mid, a_mid)
    # k3
    dq2 = quat_norm(dq0 + 0.5 * k2_q * dt)
    k3_q, k3_p, k3_v = deriv(dq2, v + 0.5 * k2_v * dt, w_mid, a_mid)
    # k4
    dq3 = quat_norm(dq0 + k3_q * dt)
    k4_q, k4_p, k4_v = deriv(dq3, v + k3_v * dt, w2, a2)

    dq = quat_norm(dq0 + (dt / 6.0) * (k1_q + 2 * k2_q + 2 * k3_q + k4_q))
    new_q = quat_multiply(dq, q0)
    new_p = p + (dt / 6.0) * (k1_p + 2 * k2_p + 2 * k3_p + k4_p)
    new_v = v + (dt / 6.0) * (k1_v + 2 * k2_v + 2 * k3_v + k4_v)
    return new_q, new_p, new_v


def _rk4_deltas(w1, a1, w2, a2, dt):
    """Input-only decomposition of `_rk4_mean`.

    RK4's incremental quaternion evolves from identity under measured
    body rates (independent of the carried orientation), and its v/p
    stage sums factor as R(q_k)^T times body-frame integrals:
        dq  : the RK4 rotation increment
        Jv  = dt/6 (a1 + 2 R1^T am + 2 R2^T am + R3^T a2)
        Jp  = dt^2/6 (a1 + R1^T am + R2^T am)
    giving exactly  v' = v + R^T Jv - g dt,
                    p' = p + v dt + R^T Jp - g dt^2/2.
    """
    dtype = w1.dtype
    safe_dt = jnp.where(dt > 0, dt, 1.0)
    w_mid = 0.5 * (w1 + w2)
    a_mid = 0.5 * (a1 + a2)
    dq0 = jnp.array([0.0, 0.0, 0.0, 1.0], dtype=dtype)
    k1_q = 0.5 * omega(w1) @ dq0
    dq1 = quat_norm(dq0 + 0.5 * k1_q * dt)
    k2_q = 0.5 * omega(w_mid) @ dq1
    dq2 = quat_norm(dq0 + 0.5 * k2_q * dt)
    k3_q = 0.5 * omega(w_mid) @ dq2
    dq3 = quat_norm(dq0 + k3_q * dt)
    k4_q = 0.5 * omega(w2) @ dq3
    dq = quat_norm(dq0 + (dt / 6.0) * (k1_q + 2 * k2_q + 2 * k3_q + k4_q))

    R1t = quat_to_rot(dq1).T
    R2t = quat_to_rot(dq2).T
    R3t = quat_to_rot(dq3).T
    Jv = (dt / 6.0) * (a1 + 2.0 * (R1t @ a_mid) + 2.0 * (R2t @ a_mid) + R3t @ a2)
    Jp = (dt * dt / 6.0) * (a1 + R1t @ a_mid + R2t @ a_mid)
    return dq, Jv, Jp


def _f_and_g_discrete(
    R_k,
    p_k,
    v_k,
    new_q,
    new_p,
    new_v,
    w_hat,
    a_hat,
    dt,
    gravity,
    dtype,
    layout: StateLayout = None,
    intr=None,
):
    """F (15, 15+s) and G (15, 12) (compute_F_and_G_discrete,
    `Propagator.cpp:830-960`), s = layout.imu_intr_dim.

    R_k/p_k/v_k are the FEJ linearization points of the *start* state.
    `intr`, when intrinsic calibration is on, is a dict with the
    correction matrices and uncorrected/corrected readings:
    RwDw (=R_GYROtoIMU @ Dw), RaDa, R_w, R_a, Tg, w_unc, a_unc, w_k, a_k.
    """
    eye3 = jnp.eye(3, dtype=dtype)
    R_new = quat_to_rot(new_q)
    dR = R_new @ R_k.T
    Jr = jr_so3(log_so3(dR))
    dRJrdt = dR @ Jr * dt

    if intr is None:
        RwDw = RaDa = eye3
        TgM = jnp.zeros((3, 3), dtype=dtype)
    else:
        RwDw, RaDa, TgM = intr["RwDw"], intr["RaDa"], intr["Tg"]

    s = 0 if layout is None else layout.imu_intr_dim
    F = jnp.zeros((15, 15 + s), dtype=dtype)
    # theta rows
    F = F.at[0:3, 0:3].set(dR)
    F = F.at[0:3, 9:12].set(-dRJrdt @ RwDw)
    F = F.at[0:3, 12:15].set(dRJrdt @ RwDw @ TgM @ RaDa)
    # position rows
    F = F.at[3:6, 0:3].set(
        -skew(new_p - p_k - v_k * dt + 0.5 * gravity * dt * dt) @ R_k.T
    )
    F = F.at[3:6, 3:6].set(eye3)
    F = F.at[3:6, 6:9].set(eye3 * dt)
    F = F.at[3:6, 12:15].set(-0.5 * dt * dt * R_k.T @ RaDa)
    # velocity rows
    F = F.at[6:9, 0:3].set(-skew(new_v - v_k + gravity * dt) @ R_k.T)
    F = F.at[6:9, 6:9].set(eye3)
    F = F.at[6:9, 12:15].set(-dt * R_k.T @ RaDa)
    # bias rows
    F = F.at[9:12, 9:12].set(eye3)
    F = F.at[12:15, 12:15].set(eye3)

    if s > 0:
        L = layout
        model = L.imu_model
        H_Dw = _h_dm(intr["w_unc"], model, dtype)
        H_Da = _h_dm(intr["a_unc"], model, dtype)
        dw0, da0 = L.imu_dw_off, L.imu_da_off
        F = F.at[0:3, dw0 : dw0 + 6].set(dRJrdt @ intr["R_w"] @ H_Dw)
        # NB the reference omits Dw in this block
        # (`Propagator.cpp:934` uses R_wtoI*Tg*R_atoI*H_Da); we keep the
        # exact chain rule d(w_I)/d(Da) = -R_w Dw Tg R_a H_Da.
        F = F.at[0:3, da0 : da0 + 6].set(-dRJrdt @ RwDw @ TgM @ intr["R_a"] @ H_Da)
        F = F.at[3:6, da0 : da0 + 6].set(0.5 * dt * dt * R_k.T @ intr["R_a"] @ H_Da)
        F = F.at[6:9, da0 : da0 + 6].set(dt * R_k.T @ intr["R_a"] @ H_Da)
        if L.calib_imu_g_sensitivity:
            tg0 = L.imu_tg_off
            F = F.at[0:3, tg0 : tg0 + 9].set(-dRJrdt @ RwDw @ _h_tg(intr["a_k"], dtype))
        th0 = L.imu_theta_off
        if model == IMU_MODEL_KALIBR:
            # gyro-to-IMU rotation error
            F = F.at[0:3, th0 : th0 + 3].set(dRJrdt @ skew(intr["w_k"]))
        else:
            # acc-to-IMU rotation error
            F = F.at[0:3, th0 : th0 + 3].set(-dRJrdt @ RwDw @ TgM @ skew(intr["a_k"]))
            F = F.at[3:6, th0 : th0 + 3].set(0.5 * dt * dt * R_k.T @ skew(intr["a_k"]))
            F = F.at[6:9, th0 : th0 + 3].set(dt * R_k.T @ skew(intr["a_k"]))
        # intrinsics rows themselves are identity, handled by the
        # caller's Phi recursion (they never change).

    G = jnp.zeros((15, 12), dtype=dtype)
    G = G.at[0:3, 0:3].set(-dRJrdt @ RwDw)
    G = G.at[0:3, 3:6].set(dRJrdt @ RwDw @ TgM @ RaDa)
    G = G.at[3:6, 3:6].set(-0.5 * dt * dt * R_k.T @ RaDa)
    G = G.at[6:9, 3:6].set(-dt * R_k.T @ RaDa)
    G = G.at[9:12, 6:9].set(eye3 * dt)
    G = G.at[12:15, 9:12].set(eye3 * dt)
    return F, G


def _xi_sum(w_hat, a_hat, dt, dtype):
    """Closed-form ACI2 integration components (`compute_Xi_sum`,
    `Propagator.cpp:588-668`): returns (R_ktok1, Xi_1, Xi_2, Jr_ktok1,
    Xi_3, Xi_4) for constant w/a over dt, with the reference's small-w
    series switch done branchlessly via `jnp.where`."""
    eye3 = jnp.eye(3, dtype=dtype)
    w_norm = jnp.linalg.norm(w_hat)
    safe_w = jnp.maximum(w_norm, 1e-15)
    k_hat = w_hat / safe_w
    d_th = w_norm * dt
    d_t2, d_t3 = dt * dt, dt * dt * dt
    w2, w3 = safe_w * safe_w, safe_w * safe_w * safe_w
    cth, sth = jnp.cos(d_th), jnp.sin(d_th)
    d_th2, d_th3 = d_th * d_th, d_th * d_th * d_th
    sK = skew(k_hat)
    sK2 = sK @ sK
    sA = skew(a_hat)
    kdota = jnp.dot(k_hat, a_hat)

    R_ktok1 = exp_so3(-w_hat * dt)
    Jr_ktok1 = jr_so3(-w_hat * dt)

    # constant-omega branch
    Xi1_l = eye3 * dt + (1.0 - cth) / safe_w * sK + (dt - sth / safe_w) * sK2
    Xi2_l = 0.5 * d_t2 * eye3 + (d_th - sth) / w2 * sK + (0.5 * d_t2 - (1.0 - cth) / w2) * sK2
    Xi3_l = (
        0.5 * d_t2 * sA
        + (sth - d_th) / w2 * sA @ sK
        + (sth - d_th * cth) / w2 * sK @ sA
        + (0.5 * d_t2 - (1.0 - cth) / w2) * sA @ sK2
        + (0.5 * d_t2 + (1.0 - cth - d_th * sth) / w2) * (sK2 @ sA + kdota * sK)
        - (3.0 * sth - 2.0 * d_th - d_th * cth) / w2 * kdota * sK2
    )
    Xi4_l = (
        d_t3 / 6.0 * sA
        + (2.0 * (1.0 - cth) - d_th2) / (2.0 * w3) * sA @ sK
        + (2.0 * (1.0 - cth) - d_th * sth) / w3 * sK @ sA
        + ((sth - d_th) / w3 + d_t3 / 6.0) * sA @ sK2
        + (d_th - 2.0 * sth + d_th3 / 6.0 + d_th * cth) / w3 * (sK2 @ sA + kdota * sK)
        + (4.0 * cth - 4.0 + d_th2 + d_th * sth) / w3 * kdota * sK2
    )
    # small-w series branch
    Xi1_s = dt * (eye3 + sth * sK + (1.0 - cth) * sK2)
    Xi2_s = 0.5 * dt * Xi1_s
    Xi3_s = (
        0.5
        * d_t2
        * (
            sA
            + sth * (-sA @ sK + sK @ sA + kdota * sK2)
            + (1.0 - cth) * (sA @ sK2 + sK2 @ sA + kdota * sK)
        )
    )
    Xi4_s = dt / 3.0 * Xi3_s

    small = w_norm < jnp.asarray(np.pi / 360.0, dtype)  # 0.5 deg total
    pick = lambda a, b: jnp.where(small, a, b)
    return (
        R_ktok1,
        pick(Xi1_s, Xi1_l),
        pick(Xi2_s, Xi2_l),
        Jr_ktok1,
        pick(Xi3_s, Xi3_l),
        pick(Xi4_s, Xi4_l),
    )


def _discrete_mean(q, p, v, w_hat, a_hat, dt, gravity):
    """Zeroth-order quaternion integrator (`predict_mean_discrete`,
    Trawny eq. 101/103) + piecewise-constant acceleration."""
    dtype = q.dtype
    w_norm = jnp.linalg.norm(w_hat)
    safe_w = jnp.maximum(w_norm, 1e-15)
    eye4 = jnp.eye(4, dtype=dtype)
    Om = omega(w_hat)
    bigO_l = jnp.cos(0.5 * w_norm * dt) * eye4 + jnp.sin(0.5 * w_norm * dt) / safe_w * Om
    bigO_s = eye4 + 0.5 * dt * Om
    bigO = jnp.where(w_norm > 1e-12, bigO_l, bigO_s)
    new_q = quat_norm(bigO @ q)
    R = quat_to_rot(q)
    new_v = v + R.T @ a_hat * dt - gravity * dt
    new_p = p + v * dt + 0.5 * R.T @ a_hat * dt * dt - 0.5 * gravity * dt * dt
    return new_q, new_p, new_v


def _analytic_mean(q, p, v, a_hat, dt, gravity, xi):
    """Closed-form constant-(w,a) mean (`predict_mean_analytic`)."""
    R_ktok1, Xi1, Xi2 = xi[0], xi[1], xi[2]
    R = quat_to_rot(q)
    new_q = quat_multiply(rot_to_quat(R_ktok1), q)
    new_v = v + R.T @ (Xi1 @ a_hat) - gravity * dt
    new_p = p + v * dt + R.T @ (Xi2 @ a_hat) - 0.5 * gravity * dt * dt
    return new_q, new_p, new_v


def _f_and_g_analytic(
    R_k, p_k, v_k, new_q, new_p, new_v, dt, gravity, dtype, xi, layout, intr
):
    """F (15, 15+s) and G (15, 12) with the ACI2 closed-form noise/bias
    integrals (`compute_F_and_G_analytic`, `Propagator.cpp:693-829`).

    Unlike the discrete variant, the bias/noise couplings into p and v
    use the exact integrals Xi_3/Xi_4 instead of the piecewise-constant
    dt/0.5dt^2 factors — the reference uses this F for BOTH the rk4 and
    analytical integration settings.
    """
    eye3 = jnp.eye(3, dtype=dtype)
    _, Xi1, Xi2, Jr_ktok1, Xi3, Xi4 = xi
    R_new = quat_to_rot(new_q)
    dR = R_new @ R_k.T
    dRJrdt = dR @ Jr_ktok1 * dt

    if intr is None:
        RwDw = RaDa = eye3
        TgM = jnp.zeros((3, 3), dtype=dtype)
    else:
        RwDw, RaDa, TgM = intr["RwDw"], intr["RaDa"], intr["Tg"]
    RkT = R_k.T
    # exact bias->p/v integral factors
    P4 = RkT @ Xi4
    P3 = RkT @ Xi3
    P2w = RkT @ (Xi2 + Xi4 @ RwDw @ TgM)
    P1w = RkT @ (Xi1 + Xi3 @ RwDw @ TgM)

    s = 0 if layout is None else layout.imu_intr_dim
    F = jnp.zeros((15, 15 + s), dtype=dtype)
    F = F.at[0:3, 0:3].set(dR)
    F = F.at[3:6, 0:3].set(
        -skew(new_p - p_k - v_k * dt + 0.5 * gravity * dt * dt) @ RkT
    )
    F = F.at[6:9, 0:3].set(-skew(new_v - v_k + gravity * dt) @ RkT)
    F = F.at[3:6, 3:6].set(eye3)
    F = F.at[3:6, 6:9].set(eye3 * dt)
    F = F.at[6:9, 6:9].set(eye3)
    # bg
    F = F.at[0:3, 9:12].set(-dRJrdt @ RwDw)
    F = F.at[3:6, 9:12].set(P4 @ RwDw)
    F = F.at[6:9, 9:12].set(P3 @ RwDw)
    F = F.at[9:12, 9:12].set(eye3)
    # ba
    F = F.at[0:3, 12:15].set(dRJrdt @ RwDw @ TgM @ RaDa)
    F = F.at[3:6, 12:15].set(-P2w @ RaDa)
    F = F.at[6:9, 12:15].set(-P1w @ RaDa)
    F = F.at[12:15, 12:15].set(eye3)

    if s > 0:
        L = layout
        model = L.imu_model
        H_Dw = _h_dm(intr["w_unc"], model, dtype)
        H_Da = _h_dm(intr["a_unc"], model, dtype)
        dw0, da0 = L.imu_dw_off, L.imu_da_off
        F = F.at[0:3, dw0 : dw0 + 6].set(dRJrdt @ intr["R_w"] @ H_Dw)
        F = F.at[3:6, dw0 : dw0 + 6].set(-P4 @ intr["R_w"] @ H_Dw)
        F = F.at[6:9, dw0 : dw0 + 6].set(-P3 @ intr["R_w"] @ H_Dw)
        F = F.at[0:3, da0 : da0 + 6].set(-dRJrdt @ RwDw @ TgM @ intr["R_a"] @ H_Da)
        F = F.at[3:6, da0 : da0 + 6].set(P2w @ intr["R_a"] @ H_Da)
        F = F.at[6:9, da0 : da0 + 6].set(P1w @ intr["R_a"] @ H_Da)
        if L.calib_imu_g_sensitivity:
            tg0 = L.imu_tg_off
            H_Tg = _h_tg(intr["a_k"], dtype)
            F = F.at[0:3, tg0 : tg0 + 9].set(-dRJrdt @ RwDw @ H_Tg)
            F = F.at[3:6, tg0 : tg0 + 9].set(P4 @ RwDw @ H_Tg)
            F = F.at[6:9, tg0 : tg0 + 9].set(P3 @ RwDw @ H_Tg)
        th0 = L.imu_theta_off
        if model == IMU_MODEL_KALIBR:
            sw = skew(intr["w_k"])
            F = F.at[0:3, th0 : th0 + 3].set(dRJrdt @ sw)
            F = F.at[3:6, th0 : th0 + 3].set(-P4 @ sw)
            F = F.at[6:9, th0 : th0 + 3].set(-P3 @ sw)
        else:
            sa = skew(intr["a_k"])
            F = F.at[0:3, th0 : th0 + 3].set(-dRJrdt @ RwDw @ TgM @ sa)
            F = F.at[3:6, th0 : th0 + 3].set(P2w @ sa)
            F = F.at[6:9, th0 : th0 + 3].set(P1w @ sa)

    G = jnp.zeros((15, 12), dtype=dtype)
    G = G.at[0:3, 0:3].set(-dRJrdt @ RwDw)
    G = G.at[3:6, 0:3].set(P4 @ RwDw)
    G = G.at[6:9, 0:3].set(P3 @ RwDw)
    G = G.at[0:3, 3:6].set(dRJrdt @ RwDw @ TgM @ RaDa)
    G = G.at[3:6, 3:6].set(-P2w @ RaDa)
    G = G.at[6:9, 3:6].set(-P1w @ RaDa)
    G = G.at[9:12, 6:9].set(eye3 * dt)
    G = G.at[12:15, 9:12].set(eye3 * dt)
    return F, G


INTEGRATION_DISCRETE = "discrete"
INTEGRATION_RK4 = "rk4"
INTEGRATION_ANALYTICAL = "analytical"


def propagate_mean_cov(
    state: FilterState,
    layout: StateLayout,
    imu_t: jnp.ndarray,
    imu_w: jnp.ndarray,
    imu_a: jnp.ndarray,
    noises: NoiseManager,
    gravity_mag: float,
    integration: str = INTEGRATION_RK4,
    stamp_time: jnp.ndarray = None,
):
    """Propagate mean+covariance through a padded IMU batch.

    imu_t (M,), imu_w (M,3), imu_a (M,3); intervals are consecutive
    sample pairs; padding = repeated timestamps (dt==0 -> identity).
    Returns (new_state, w_hat_last) where w_hat_last is the bias-
    corrected angular velocity at the end (for the clone dt Jacobian).

    `stamp_time`: timestamp to store in the state (camera clock). When
    the camera-IMU time offset is estimated, the IMU window endpoints
    are in the IMU clock (`t_cam + calib_dt`) but the state keeps the
    camera-clock stamp, exactly like `state->_timestamp = timestamp`
    after propagating to `timestamp + t_off` (`Propagator.cpp:54-135`).
    Defaults to imu_t[-1] (no-offset behavior).
    """
    dtype = state.cov.dtype
    gravity = jnp.array([0.0, 0.0, gravity_mag], dtype=dtype)
    bg, ba = state.bg, state.ba
    # time axis stays f64; compute in the state dtype
    imu_w = imu_w.astype(dtype)
    imu_a = imu_a.astype(dtype)

    # IMU intrinsic correction matrices (identity unless seeded/estimated):
    #   a_I = R_AtoI Da (a_m - ba);  w_I = R_WtoI Dw (w_m - bg - Tg a_I)
    # (`Propagator.cpp:403-429`)
    model = layout.imu_model
    Dw = dm_matrix(state.calib_imu_dw.astype(dtype), model)
    Da = dm_matrix(state.calib_imu_da.astype(dtype), model)
    TgM = tg_matrix(state.calib_imu_tg.astype(dtype))
    R_w = quat_to_rot(state.calib_imu_gq.astype(dtype))
    R_a = quat_to_rot(state.calib_imu_aq.astype(dtype))
    RwDw = R_w @ Dw
    RaDa = R_a @ Da
    s = layout.imu_intr_dim

    q0, p0, v0 = state.q, state.p, state.v
    Rf0 = quat_to_rot(state.q_fej)
    pf0, vf0 = state.p_fej, state.v_fej

    # -- pass 0: batched measurement correction (state-independent) ----
    dts = (imu_t[1:] - imu_t[:-1]).astype(dtype)  # (n,)
    has = dts > 0
    safe_dt = jnp.where(has, dts, 1.0)
    a_raw = imu_a - ba  # (M,3)
    a_c = a_raw @ RaDa.T
    w_u = imu_w - bg - a_c @ TgM.T
    w_c = w_u @ RwDw.T
    w1, w2 = w_c[:-1], w_c[1:]
    a1, a2 = a_c[:-1], a_c[1:]
    w_hat = 0.5 * (w1 + w2)
    a_hat = 0.5 * (a1 + a2)
    w_unc = 0.5 * (w_u[:-1] + w_u[1:])
    a_unc = 0.5 * (a_raw[:-1] + a_raw[1:])

    use_xi = integration in (INTEGRATION_RK4, INTEGRATION_ANALYTICAL)
    xi = (
        jax.vmap(lambda w, a, d: _xi_sum(w, a, d, dtype))(w_hat, a_hat, safe_dt)
        if use_xi
        else None
    )

    # -- pass 1: mean via per-interval deltas + associative composition --
    # The mean recurrence decomposes exactly: each interval's body-frame
    # rotation increment dq_k and body-frame integrals Jv_k/Jp_k depend
    # only on measurements, with
    #     q_{k+1} = dq_k (x) q_k
    #     v_{k+1} = v_k + R(q_k)^T Jv_k - g dt_k
    #     p_{k+1} = p_k + v_k dt_k + R(q_k)^T Jp_k - g dt_k^2 / 2
    # so the sequential part reduces to one quaternion prefix product
    # (log-depth `associative_scan`) and two cumsums — no per-sample
    # small-op chain. Algebraically identical to integrating the
    # same method step-by-step.
    if integration == INTEGRATION_ANALYTICAL:
        dq = jax.vmap(lambda R: rot_to_quat(R))(xi[0])
        Jv = jnp.einsum("nij,nj->ni", xi[1], a_hat)
        Jp = jnp.einsum("nij,nj->ni", xi[2], a_hat)
    elif integration == INTEGRATION_DISCRETE:
        # zeroth-order quat integrator: bigO q == dq (x) q with
        # dq = [sin(|w|dt/2) w/|w|, cos(|w|dt/2)] (Trawny eq. 101/103)
        wn = jnp.linalg.norm(w_hat, axis=-1, keepdims=True)
        swn = jnp.maximum(wn, 1e-15)
        half = 0.5 * wn[..., 0] * safe_dt
        dq_l = jnp.concatenate(
            [jnp.sin(half)[..., None] * w_hat / swn, jnp.cos(half)[..., None]], axis=-1
        )
        dq_s = jnp.concatenate(
            [0.5 * w_hat * safe_dt[:, None], jnp.ones_like(half)[..., None]], axis=-1
        )
        dq = quat_norm(jnp.where(wn > 1e-12, dq_l, dq_s))
        Jv = a_hat * safe_dt[:, None]
        Jp = 0.5 * a_hat * safe_dt[:, None] ** 2
    else:
        dq, Jv, Jp = jax.vmap(lambda *a: _rk4_deltas(*a))(w1, a1, w2, a2, dts)

    ident_q = jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype)
    dq = jnp.where(has[:, None], dq, ident_q[None])
    Jv = jnp.where(has[:, None], Jv, 0.0)
    Jp = jnp.where(has[:, None], Jp, 0.0)
    dts_m = jnp.where(has, dts, 0.0)

    # inclusive prefix products S_k = dq_k (x) ... (x) dq_0
    S = jax.lax.associative_scan(lambda a, b: quat_multiply(b, a), dq)
    q_e = quat_multiply(S, q0[None])  # (n,4) endpoint of each interval
    q_s = jnp.concatenate([q0[None], q_e[:-1]], axis=0)  # starts
    R_s_val = quat_to_rot(q_s)  # (n,3,3) R_GtoI at interval starts
    dv = jnp.einsum("nji,nj->ni", R_s_val, Jv) - gravity[None] * dts_m[:, None]
    v_e = v0[None] + jnp.cumsum(dv, axis=0)
    v_s = jnp.concatenate([v0[None], v_e[:-1]], axis=0)
    dp = (
        v_s * dts_m[:, None]
        + jnp.einsum("nji,nj->ni", R_s_val, Jp)
        - 0.5 * gravity[None] * dts_m[:, None] ** 2
    )
    p_e = p0[None] + jnp.cumsum(dp, axis=0)
    p_s = jnp.concatenate([p0[None], p_e[:-1]], axis=0)
    q, p, v = q_e[-1], p_e[-1], v_e[-1]

    # FEJ: linearization start of interval 0 is the stored first-estimate
    # (differs from the value only on the first interval after an EKF
    # update); every later interval starts at its value == fej, matching
    # the reference (`Propagator.cpp:473-479`).
    R_s = quat_to_rot(q_s)  # (n,3,3)
    R_s = R_s.at[0].set(Rf0)
    p_s = p_s.at[0].set(pf0)
    v_s = v_s.at[0].set(vf0)

    # -- pass 2: batched F/G construction (no recurrence) ---------------
    def build_fg(R_k, p_k, v_k, nq, np_, nv, wh, ah, wu, au, d, xi_i):
        intr = {
            "RwDw": RwDw, "RaDa": RaDa, "R_w": R_w, "R_a": R_a, "Tg": TgM,
            "w_unc": wu, "a_unc": au, "w_k": wh, "a_k": ah,
        }
        if integration == INTEGRATION_DISCRETE:
            return _f_and_g_discrete(
                R_k, p_k, v_k, nq, np_, nv, wh, ah, d, gravity, dtype,
                layout=layout, intr=intr,
            )
        # rk4 AND analytical both use the ACI2 closed-form F/G, exactly
        # like the reference (`Propagator.cpp:454-459`)
        return _f_and_g_analytic(
            R_k, p_k, v_k, nq, np_, nv, d, gravity, dtype, xi_i, layout, intr
        )

    args = (R_s, p_s, v_s, q_e, p_e, v_e, w_hat, a_hat, w_unc, a_unc, safe_dt)
    if use_xi:
        F, G = jax.vmap(build_fg)(*args, xi)
    else:
        F, G = jax.vmap(lambda *a: build_fg(*a, None))(*args)
    eye = jnp.eye(15, 15 + s, dtype=dtype)
    F = jnp.where(has[:, None, None], F, eye[None])
    G = jnp.where(has[:, None, None], G, jnp.zeros_like(G))

    # per-interval discrete noise: Qd_i = G diag(qc) G^T
    sig = jnp.asarray(
        [noises.sigma_w**2] * 3 + [noises.sigma_a**2] * 3
        + [noises.sigma_wb**2] * 3 + [noises.sigma_ab**2] * 3,
        dtype,
    )
    qc = sig[None, :] / safe_dt[:, None]  # (n,12)
    Qd_i = jnp.einsum("nij,nj,nkj->nik", G, qc, G)
    Qd_i = 0.5 * (Qd_i + jnp.swapaxes(Qd_i, -1, -2))

    # -- pass 3: log-depth composition of (Phi, Qd) ---------------------
    # Phi over the contiguous [imu(15) | intr(s)] block is
    # [[Phi_ii, Phi_ik], [0, I]]; composing segment A (first) with B:
    #   ii = B_ii A_ii ; ik = B_ii A_ik + B_ik ; Q = B_ii Q_A B_ii^T + Q_B
    # Matrix composition is associative -> pairwise tree reduction, each
    # level one batched matmul (MXU-friendly) instead of n sequential
    # 15x15 products.
    Phi_ii = F[:, :, :15]
    Phi_ik = F[:, :, 15:]  # (n,15,s), s may be 0
    Qd = Qd_i
    n = Phi_ii.shape[0]
    pow2 = 1
    while pow2 < n:
        pow2 *= 2
    pad = pow2 - n
    if pad:
        Phi_ii = jnp.concatenate(
            [Phi_ii, jnp.tile(jnp.eye(15, dtype=dtype)[None], (pad, 1, 1))], axis=0
        )
        Phi_ik = jnp.concatenate(
            [Phi_ik, jnp.zeros((pad, 15, s), dtype)], axis=0
        )
        Qd = jnp.concatenate([Qd, jnp.zeros((pad, 15, 15), dtype)], axis=0)
    while Phi_ii.shape[0] > 1:
        A_ii, B_ii = Phi_ii[0::2], Phi_ii[1::2]
        A_ik, B_ik = Phi_ik[0::2], Phi_ik[1::2]
        A_Q, B_Q = Qd[0::2], Qd[1::2]
        Phi_ii = jnp.einsum("nij,njk->nik", B_ii, A_ii)
        Phi_ik = jnp.einsum("nij,njk->nik", B_ii, A_ik) + B_ik
        Qd = jnp.einsum("nij,njk,nlk->nil", B_ii, A_Q, B_ii) + B_Q
    Phi = jnp.concatenate([Phi_ii[0], Phi_ik[0]], axis=1) if s else Phi_ii[0]
    Qd = 0.5 * (Qd[0] + Qd[0].T)

    cov = propagate_covariance(state.cov, Phi, Qd)
    new_state = state.replace(
        q=q,
        p=p,
        v=v,
        q_fej=q,
        p_fej=p,
        v_fej=v,
        cov=cov,
        time=imu_t[-1] if stamp_time is None else stamp_time,
    )
    # final corrected angular rate (for the clone time-offset Jacobian)
    return new_state, w_c[-1]


def propagate_mean_only(
    state, imu_t, imu_w, imu_a, gravity_mag: float, imu_model: int = IMU_MODEL_KALIBR
):
    """Mean-only RK4 propagation (no covariance) — the
    `fast_state_propagate` path for IMU-rate odometry output
    (`Propagator.cpp:140-267`). Returns (q, p, v) at imu_t[-1]."""
    dtype = state.cov.dtype
    gravity = jnp.array([0.0, 0.0, gravity_mag], dtype=dtype)
    bg, ba = state.bg, state.ba
    imu_w = imu_w.astype(dtype)
    imu_a = imu_a.astype(dtype)
    RwDw = quat_to_rot(state.calib_imu_gq.astype(dtype)) @ dm_matrix(
        state.calib_imu_dw.astype(dtype), imu_model
    )
    RaDa = quat_to_rot(state.calib_imu_aq.astype(dtype)) @ dm_matrix(
        state.calib_imu_da.astype(dtype), imu_model
    )
    TgM = tg_matrix(state.calib_imu_tg.astype(dtype))

    def body(carry, inp):
        q, p, v = carry
        t1, w1m, a1m, t2, w2m, a2m = inp
        dt = (t2 - t1).astype(dtype)
        has = dt > 0
        a1 = RaDa @ (a1m - ba)
        a2 = RaDa @ (a2m - ba)
        new_q, new_p, new_v = _rk4_mean(
            q,
            p,
            v,
            RwDw @ (w1m - bg - TgM @ a1),
            a1,
            RwDw @ (w2m - bg - TgM @ a2),
            a2,
            dt,
            gravity,
        )
        return (
            jnp.where(has, new_q, q),
            jnp.where(has, new_p, p),
            jnp.where(has, new_v, v),
        ), None

    (q, p, v), _ = jax.lax.scan(
        body,
        (state.q, state.p, state.v),
        (imu_t[:-1], imu_w[:-1], imu_a[:-1], imu_t[1:], imu_w[1:], imu_a[1:]),
    )
    return q, p, v


def propagate_and_clone(
    state: FilterState,
    layout: StateLayout,
    imu_t: jnp.ndarray,
    imu_w: jnp.ndarray,
    imu_a: jnp.ndarray,
    noises: NoiseManager,
    gravity_mag: float,
    integration: str = INTEGRATION_RK4,
    stamp_time: jnp.ndarray = None,
) -> FilterState:
    """`Propagator::propagate_and_clone` — propagate to the newest image
    time (imu_t[-1], or `stamp_time` in the camera clock when the
    time offset is applied) then stochastically clone."""
    new_state, w_hat = propagate_mean_cov(
        state, layout, imu_t, imu_w, imu_a, noises, gravity_mag,
        integration=integration, stamp_time=stamp_time,
    )
    return augment_clone(new_state, layout, w_hat)


def select_imu_readings_np(
    times: np.ndarray, ws: np.ndarray, accs: np.ndarray, t0: float, t1: float, m_max: int
):
    """Host-side IMU slicing with boundary interpolation.

    Behavioral equivalent of `Propagator::select_imu_readings` +
    `interpolate_data` (`Propagator.cpp:269-386`): produce the samples
    covering [t0, t1] with linearly interpolated boundary samples, then
    pad (by repeating the last sample) to `m_max` rows.
    Returns (t (m_max,), w (m_max,3), a (m_max,3)).

    Dispatches to the native C++ implementation when built
    (uvio_jax/native); this numpy body is the fallback and the
    behavioral specification.
    """
    from ..native import select_imu_readings as _native

    out = _native(times, ws, accs, t0, t1, m_max)
    if out is not None:
        return out
    assert t1 > t0, "backwards propagation request"

    def interp(t):
        i = np.searchsorted(times, t)
        i = np.clip(i, 1, len(times) - 1)
        lam = (t - times[i - 1]) / (times[i] - times[i - 1])
        w = (1 - lam) * ws[i - 1] + lam * ws[i]
        a = (1 - lam) * accs[i - 1] + lam * accs[i]
        return w, a

    sel = (times > t0) & (times < t1)
    t_mid = times[sel]
    w_mid = ws[sel]
    a_mid = accs[sel]
    w0, a0 = interp(t0)
    w1, a1 = interp(t1)
    t = np.concatenate([[t0], t_mid, [t1]])
    w = np.concatenate([[w0], w_mid, [w1]])
    a = np.concatenate([[a0], a_mid, [a1]])
    if len(t) > m_max:
        raise ValueError(
            f"IMU batch {len(t)} exceeds max_imu_batch={m_max}; raise the layout limit"
        )
    pad = m_max - len(t)
    t = np.concatenate([t, np.full(pad, t[-1])])
    w = np.concatenate([w, np.tile(w[-1], (pad, 1))])
    a = np.concatenate([a, np.tile(a[-1], (pad, 1))])
    return t, w, a
