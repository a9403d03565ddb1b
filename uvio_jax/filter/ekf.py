"""Fused EKF kernels on the fixed-layout state.

JAX equivalent of the reference EKF heart
(`ov_msckf/src/state/StateHelper.{h,cpp}`):

  * `propagate_covariance`  <-  EKFPropagation (block-sparse: only the
    15-dof IMU block evolves; cross rows get Phi on the left)
  * `ekf_update`            <-  EKFUpdate (K = P H^T S^-1 via Cholesky,
    symmetric downdate, boxplus), with *masked padded rows* instead of
    dynamic row counts
  * `augment_clone`         <-  augment_clone + the stochastic-cloning
    covariance copy (rows written into a ring-buffer slot instead of a
    matrix resize)
  * `marginalize_clone/slam`<-  marginalize (slot invalidation + row/col
    zeroing instead of block deletion)
  * `initialize_invertible` /
    `delayed_initialize`    <-  initialize_invertible / initialize
    (QR split into an invertible init system + an update system)

All functions are pure, jit-safe, static-shape. Rows of measurement
Jacobians are padded and masked: a masked-out row has H=0, res=0 and a
unit noise entry, which makes it exactly inert in the update algebra.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..math import quat_multiply, quat_norm
from ..types.layout import StateLayout
from ..types.state import FilterState


# ---------------------------------------------------------------------------
# covariance propagation
# ---------------------------------------------------------------------------


def propagate_covariance(cov: jnp.ndarray, phi: jnp.ndarray, qd: jnp.ndarray) -> jnp.ndarray:
    """P <- [Phi 0; 0 I] P [.]^T + diag(Qd, 0) for the leading block.

    Mirrors `StateHelper::EKFPropagation` (`StateHelper.cpp:36-114`) for
    the contiguous leading block. `phi` is (15, b): the top rows of the
    block transition over [imu(15) | imu-intrinsics(b-15)] — the
    intrinsics rows are constant identity, so only the 15 IMU rows of
    the covariance change.
    """
    b = phi.shape[1]
    rows = phi @ cov[:b, :]  # (15, D)
    new_ii = rows[:, :b] @ phi.T + qd  # (15, 15)
    cov = cov.at[:15, :].set(rows)
    cov = cov.at[:, :15].set(rows.T)
    cov = cov.at[:15, :15].set(0.5 * (new_ii + new_ii.T))
    return cov


# ---------------------------------------------------------------------------
# boxplus injection
# ---------------------------------------------------------------------------


def _dq(dtheta):
    """Small JPL error quaternion [dtheta/2, 1], normalized (Type::update)."""
    w = jnp.ones(dtheta.shape[:-1] + (1,), dtheta.dtype)
    return quat_norm(jnp.concatenate([0.5 * dtheta, w], axis=-1))


def inject(state: FilterState, layout: StateLayout, dx: jnp.ndarray) -> FilterState:
    """Apply an error-state correction to every mean block (masked).

    FEJ linearization points are deliberately left untouched.
    """
    L = layout
    # imu
    q = quat_multiply(_dq(dx[L.theta_off : L.theta_off + 3]), state.q)
    p = state.p + dx[L.p_off : L.p_off + 3]
    v = state.v + dx[L.v_off : L.v_off + 3]
    bg = state.bg + dx[L.bg_off : L.bg_off + 3]
    ba = state.ba + dx[L.ba_off : L.ba_off + 3]
    # clones
    dxc = dx[L.clone_off : L.clone_off + 6 * L.max_clones].reshape(L.max_clones, 6)
    cmask = state.clones_valid[:, None]
    clones_q = jnp.where(
        cmask, quat_multiply(_dq(dxc[:, 0:3]), state.clones_q), state.clones_q
    )
    clones_p = jnp.where(cmask, state.clones_p + dxc[:, 3:6], state.clones_p)
    # slam landmarks
    if L.max_slam > 0:
        dxs = dx[L.slam_off : L.slam_off + 3 * L.max_slam].reshape(L.max_slam, 3)
        slam_p = jnp.where(state.slam_valid[:, None], state.slam_p + dxs, state.slam_p)
    else:
        slam_p = state.slam_p
    # imu intrinsics
    calib_imu_dw = state.calib_imu_dw
    calib_imu_da = state.calib_imu_da
    calib_imu_tg = state.calib_imu_tg
    calib_imu_gq = state.calib_imu_gq
    calib_imu_aq = state.calib_imu_aq
    if L.calib_imu_intrinsics:
        calib_imu_dw = calib_imu_dw + dx[L.imu_dw_off : L.imu_dw_off + 6]
        calib_imu_da = calib_imu_da + dx[L.imu_da_off : L.imu_da_off + 6]
        if L.calib_imu_g_sensitivity:
            calib_imu_tg = calib_imu_tg + dx[L.imu_tg_off : L.imu_tg_off + 9]
        dth = dx[L.imu_theta_off : L.imu_theta_off + 3]
        from ..types.layout import IMU_MODEL_KALIBR

        if L.imu_model == IMU_MODEL_KALIBR:
            calib_imu_gq = quat_multiply(_dq(dth), calib_imu_gq)
        else:
            calib_imu_aq = quat_multiply(_dq(dth), calib_imu_aq)
    # calib
    calib_dt = state.calib_dt
    calib_cam_q = state.calib_cam_q
    calib_cam_p = state.calib_cam_p
    calib_cam_intr = state.calib_cam_intr
    if L.calib_cam_timeoffset:
        calib_dt = calib_dt + dx[L.calib_dt_off]
    if L.calib_cam_pose:
        dxe = dx[
            L.calib_cam_pose_off : L.calib_cam_pose_off + 6 * L.num_cams
        ].reshape(L.num_cams, 6)
        calib_cam_q = quat_multiply(_dq(dxe[:, 0:3]), calib_cam_q)
        calib_cam_p = calib_cam_p + dxe[:, 3:6]
    if L.calib_cam_intrinsics:
        dxi = dx[
            L.calib_cam_intr_off : L.calib_cam_intr_off + 8 * L.num_cams
        ].reshape(L.num_cams, 8)
        calib_cam_intr = calib_cam_intr + dxi
    uwb_p = state.uwb_p_IinU
    if L.calib_uwb_extrinsics:
        uwb_p = uwb_p + dx[L.calib_uwb_off : L.calib_uwb_off + 3]
    # anchors
    if L.max_anchors > 0:
        dxa = dx[L.anchor_off : L.anchor_off + 5 * L.max_anchors].reshape(
            L.max_anchors, 5
        )
        amask = state.anchors_valid
        anchors_p = jnp.where(
            amask[:, None], state.anchors_p + dxa[:, 0:3], state.anchors_p
        )
        anchors_gamma = jnp.where(
            amask, state.anchors_gamma + dxa[:, 3], state.anchors_gamma
        )
        anchors_alpha = jnp.where(
            amask, state.anchors_alpha + dxa[:, 4], state.anchors_alpha
        )
    else:
        anchors_p = state.anchors_p
        anchors_gamma = state.anchors_gamma
        anchors_alpha = state.anchors_alpha
    return state.replace(
        q=q,
        p=p,
        v=v,
        bg=bg,
        ba=ba,
        clones_q=clones_q,
        clones_p=clones_p,
        slam_p=slam_p,
        calib_imu_dw=calib_imu_dw,
        calib_imu_da=calib_imu_da,
        calib_imu_tg=calib_imu_tg,
        calib_imu_gq=calib_imu_gq,
        calib_imu_aq=calib_imu_aq,
        calib_dt=calib_dt,
        calib_cam_q=calib_cam_q,
        calib_cam_p=calib_cam_p,
        calib_cam_intr=calib_cam_intr,
        uwb_p_IinU=uwb_p,
        anchors_p=anchors_p,
        anchors_gamma=anchors_gamma,
        anchors_alpha=anchors_alpha,
    )


# ---------------------------------------------------------------------------
# EKF update
# ---------------------------------------------------------------------------


def ekf_update(
    state: FilterState,
    layout: StateLayout,
    H: jnp.ndarray,
    res: jnp.ndarray,
    r_diag: jnp.ndarray,
    mask: jnp.ndarray,
):
    """Masked dense EKF update; returns (new_state, diagnostics).

    `H` (m, D), `res` (m,), `r_diag` (m,) measurement noise variances,
    `mask` (m,) bool for real rows. Equivalent to
    `StateHelper::EKFUpdate` (`StateHelper.cpp:116-197`) with the
    per-variable block loop fused into one dense kernel.
    """
    m = H * mask[:, None]
    r = res * mask
    rd = jnp.where(mask, r_diag, 1.0)
    PHt = state.cov @ m.T  # (D, m)
    S = m @ PHt + jnp.diag(rd)
    S = 0.5 * (S + S.T)
    chol = jax.scipy.linalg.cho_factor(S, lower=True)
    K = jax.scipy.linalg.cho_solve(chol, PHt.T).T  # (D, m)
    dx = K @ r
    cov = state.cov - K @ PHt.T
    cov = 0.5 * (cov + cov.T)
    new_state = inject(state.replace(cov=cov), layout, dx)
    # corrupted-covariance flag (reference exits on a negative diagonal,
    # `StateHelper.cpp:102-113`). Tolerance is dtype/scale aware: the
    # f32 MXU path rounds K*PHt' enough that healthy diagonals can dip
    # a few ulp below zero — real corruption is orders larger (or NaN,
    # which fails any comparison).
    diag = jnp.diagonal(cov)
    tol = jnp.maximum(
        32.0 * jnp.finfo(cov.dtype).eps * jnp.maximum(jnp.max(diag), 1.0),
        1e-9,
    )
    diag_ok = jnp.all(diag > -tol)
    return new_state, {"dx": dx, "cov_ok": diag_ok}


# ---------------------------------------------------------------------------
# stochastic cloning / marginalization (slot ring buffer)
# ---------------------------------------------------------------------------


def augment_clone(
    state: FilterState, layout: StateLayout, w_hat: jnp.ndarray
) -> FilterState:
    """Stochastically clone the current IMU pose into the next ring slot.

    Covariance rows for the slot are `J P` with J selecting the imu
    theta/p rows (plus the time-offset column `dnc_dt = [w; v]` when
    dt calibration is on), cf. `StateHelper::augment_clone`
    (`StateHelper.cpp:341-391, 579-616`).
    """
    L = layout
    slot = jnp.where(
        state.clone_head < 0, 0, (state.clone_head + 1) % L.max_clones
    ).astype(jnp.int32)
    off = L.clone_off + 6 * slot

    # J: (6, D) — identity into imu theta/p (+ dt column)
    J = jnp.zeros((6, L.dim), dtype=state.cov.dtype)
    J = J.at[0:3, L.theta_off : L.theta_off + 3].set(jnp.eye(3, dtype=state.cov.dtype))
    J = J.at[3:6, L.p_off : L.p_off + 3].set(jnp.eye(3, dtype=state.cov.dtype))
    if L.calib_cam_timeoffset:
        J = J.at[0:3, L.calib_dt_off].set(w_hat)
        J = J.at[3:6, L.calib_dt_off].set(state.v)

    rows = J @ state.cov  # (6, D)
    block = rows @ J.T  # (6, 6)
    cov = jax.lax.dynamic_update_slice(state.cov, rows, (off, jnp.int32(0)))
    cov = jax.lax.dynamic_update_slice(cov, rows.T, (jnp.int32(0), off))
    cov = jax.lax.dynamic_update_slice(cov, block, (off, off))

    return state.replace(
        cov=cov,
        clones_q=state.clones_q.at[slot].set(state.q),
        clones_p=state.clones_p.at[slot].set(state.p),
        clones_q_fej=state.clones_q_fej.at[slot].set(state.q),
        clones_p_fej=state.clones_p_fej.at[slot].set(state.p),
        clones_t=state.clones_t.at[slot].set(state.time),
        clones_valid=state.clones_valid.at[slot].set(True),
        clone_head=slot,
    )


def _zero_rows_cols(cov, off, size):
    z_rows = jnp.zeros((size, cov.shape[0]), dtype=cov.dtype)
    cov = jax.lax.dynamic_update_slice(cov, z_rows, (off, jnp.int32(0)))
    cov = jax.lax.dynamic_update_slice(cov, z_rows.T, (jnp.int32(0), off))
    return cov


def marginalize_clone(
    state: FilterState, layout: StateLayout, slot: jnp.ndarray
) -> FilterState:
    """Drop a clone: invalidate the slot and zero its covariance rows/cols.

    Equivalent of `StateHelper::marginalize` block deletion
    (`StateHelper.cpp:271-339`) under the slot-pool design. Zeroing keeps
    the invariant that dead slots contribute exact zeros everywhere.
    """
    off = layout.clone_off + 6 * slot
    cov = _zero_rows_cols(state.cov, off, 6)
    return state.replace(
        cov=cov,
        clones_valid=state.clones_valid.at[slot].set(False),
        clones_t=state.clones_t.at[slot].set(-1.0),
    )


def marginalize_slam(
    state: FilterState, layout: StateLayout, slot: jnp.ndarray
) -> FilterState:
    off = layout.slam_off + 3 * slot
    cov = _zero_rows_cols(state.cov, off, 3)
    return state.replace(
        cov=cov,
        slam_valid=state.slam_valid.at[slot].set(False),
        slam_id=state.slam_id.at[slot].set(-1),
    )


# ---------------------------------------------------------------------------
# variable initialization
# ---------------------------------------------------------------------------


def initialize_invertible_block(
    cov: jnp.ndarray,
    slot_off: jnp.ndarray,
    H_R: jnp.ndarray,
    H_L: jnp.ndarray,
    r_diag: jnp.ndarray,
    res: jnp.ndarray,
):
    """Initialize a `s`-dof block at (traced) offset `slot_off`.

    H_R (s, D) full-width Jacobian wrt existing states, H_L (s, s)
    invertible Jacobian wrt the new block. Returns (new_cov, dx_new)
    where `dx_new = H_L^{-1} res` is the boxplus for the new block.
    Mirrors `StateHelper::initialize_invertible` (`StateHelper.cpp:
    484-577`) with the resize replaced by a slot write.
    """
    s = H_L.shape[0]
    M_a = cov @ H_R.T  # (D, s)
    M = H_R @ M_a + jnp.diag(r_diag)  # (s, s)
    # invert via QR + triangular solve (an LU-free form; not yet timed
    # against a plain LU solve on the GPU)
    Ql, Rl = jnp.linalg.qr(H_L)
    H_Linv = jax.scipy.linalg.solve_triangular(Rl, Ql.T, lower=False)
    P_LL = H_Linv @ M @ H_Linv.T
    cross = -M_a @ H_Linv.T  # (D, s)
    cov = jax.lax.dynamic_update_slice(cov, cross.T, (slot_off, jnp.int32(0)))
    cov = jax.lax.dynamic_update_slice(cov, cross, (jnp.int32(0), slot_off))
    cov = jax.lax.dynamic_update_slice(cov, P_LL, (slot_off, slot_off))
    dx_new = H_Linv @ res
    return cov, dx_new


def set_block_covariance(cov: jnp.ndarray, slot_off, block: jnp.ndarray):
    """Overwrite a diagonal block (zeroing its cross terms) — the
    equivalent of `StateHelper::set_initial_covariance`."""
    s = block.shape[0]
    # callers pass numpy f64 prior blocks; the state covariance may be f32
    block = jnp.asarray(block, cov.dtype)
    cov = _zero_rows_cols(cov, slot_off, s)
    cov = jax.lax.dynamic_update_slice(cov, block, (slot_off, slot_off))
    return cov


def get_marginal_covariance(cov: jnp.ndarray, blocks) -> jnp.ndarray:
    """Marginal covariance of a set of (offset, size) error-state blocks
    (`StateHelper::get_marginal_covariance`, StateHelper.cpp:226-254):
    the joint sub-covariance with rows/cols gathered in block order.

    `blocks` is a static list of (offset, size) pairs.
    """
    idx = jnp.concatenate(
        [jnp.arange(off, off + size) for off, size in blocks]
    )
    return cov[jnp.ix_(idx, idx)]
