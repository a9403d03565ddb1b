"""Cubic SE(3) B-spline for trajectory simulation.

JAX equivalent of `ov_core/src/sim/BsplineSE3.{h,cpp}`: uniform
cubic B-spline over SE(3) control poses,

    T(u) = T_i0 * exp(b0(u) Omega_1) * exp(b1(u) Omega_2) * exp(b2(u) Omega_3)

with Omega_k = log(T_{k-1}^{-1} T_k) and the cumulative cubic basis

    b0 = (5 + 3u - 3u^2 + u^3)/6,  b1 = (1 + 3u + 3u^2 - 2u^3)/6,
    b2 = u^3/6.

Unlike the reference (hand-derived analytic velocity/acceleration
formulas), derivatives here come from `jax.jacfwd` through the spline —
exactly consistent with the pose function by construction.

Control poses are stored as (R_ItoG, p_IinG); all queries are vmapped
over time arrays. Evaluation outside [t1, t_end-2dt] clamps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..math import exp_se3, inv_se3, log_se3, quat_to_rot


def build_controls(times: np.ndarray, q_GtoI: np.ndarray, p_IinG: np.ndarray):
    """Host-side control-pose construction (feed_trajectory behavior).

    Uses the trajectory poses directly as uniformly-spaced control poses
    with dt = average sample spacing (the reference does the same).
    Returns (t0, dt, T_controls (N,4,4) as T_ItoG).
    """
    dt = float(np.mean(np.diff(times)))
    R_GtoI = np.asarray(quat_to_rot(jnp.asarray(q_GtoI)))
    T = np.zeros((len(times), 4, 4))
    T[:, :3, :3] = np.transpose(R_GtoI, (0, 2, 1))  # R_ItoG
    T[:, :3, 3] = p_IinG
    T[:, 3, 3] = 1.0
    return float(times[0]), dt, jnp.asarray(T)


def _basis(u):
    b0 = (5.0 + 3.0 * u - 3.0 * u * u + u**3) / 6.0
    b1 = (1.0 + 3.0 * u + 3.0 * u * u - 2.0 * u**3) / 6.0
    b2 = (u**3) / 6.0
    return b0, b1, b2


def pose_at(controls: jnp.ndarray, t0: float, dt: float, t):
    """T_ItoG(t) (4,4). `t` scalar (vmap for batches)."""
    n = controls.shape[0]
    s = (t - t0) / dt
    i1 = jnp.clip(jnp.floor(s).astype(jnp.int32), 1, n - 3)
    u = s - i1.astype(s.dtype)
    T0 = controls[i1 - 1]
    T1 = controls[i1]
    T2 = controls[i1 + 1]
    T3 = controls[i1 + 2]
    w1 = log_se3(inv_se3(T0) @ T1)
    w2 = log_se3(inv_se3(T1) @ T2)
    w3 = log_se3(inv_se3(T2) @ T3)
    b0, b1, b2 = _basis(u)
    return T0 @ exp_se3(b0 * w1) @ exp_se3(b1 * w2) @ exp_se3(b2 * w3)


def _vee(M):
    return jnp.stack([M[2, 1], M[0, 2], M[1, 0]])


def state_at(controls: jnp.ndarray, t0: float, dt: float, t):
    """Full kinematic state at time t.

    Returns dict with R_GtoI, p_IinG, v_IinG, a_IinG, w_IinI
    (angular velocity in IMU frame) — what `Simulator::get_next_imu`
    consumes (`BsplineSE3::get_acceleration` equivalent).

    The control-pose log terms are hoisted OUT of the differentiated
    function: they are piecewise-constant in t, and differentiating
    through `log_se3`'s arccos produces 0*inf = NaN when a control
    delta lands on a non-smooth point of the primal (observed with an
    emulated f64 whose transcendental rounding differs from the CPU's). Hoisting makes
    the 1st/2nd jacfwd structurally safe and cheaper.
    """
    n = controls.shape[0]
    s0 = (t - t0) / dt
    i1 = jnp.clip(jnp.floor(s0).astype(jnp.int32), 1, n - 3)
    T0 = controls[i1 - 1]
    T1 = controls[i1]
    T2 = controls[i1 + 1]
    T3 = controls[i1 + 2]
    w1 = log_se3(inv_se3(T0) @ T1)
    w2 = log_se3(inv_se3(T1) @ T2)
    w3 = log_se3(inv_se3(T2) @ T3)

    def pose_fn(tt):
        u = (tt - t0) / dt - i1.astype(jnp.result_type(tt))
        b0, b1, b2 = _basis(u)
        return T0 @ exp_se3(b0 * w1) @ exp_se3(b1 * w2) @ exp_se3(b2 * w3)

    T = pose_fn(t)
    dT = jax.jacfwd(pose_fn)(t)
    ddT = jax.jacfwd(jax.jacfwd(pose_fn))(t)
    R_ItoG = T[:3, :3]
    p = T[:3, 3]
    v = dT[:3, 3]
    a = ddT[:3, 3]
    # omega in IMU frame: [w]_x = R_ItoG^T dR_ItoG
    w = _vee(R_ItoG.T @ dT[:3, :3])
    return {
        "R_GtoI": R_ItoG.T,
        "p_IinG": p,
        "v_IinG": v,
        "a_IinG": a,
        "w_IinI": w,
    }


state_at_batch = jax.jit(
    jax.vmap(state_at, in_axes=(None, None, None, 0)), static_argnums=(1, 2)
)
pose_at_batch = jax.jit(
    jax.vmap(pose_at, in_axes=(None, None, None, 0)), static_argnums=(1, 2)
)
