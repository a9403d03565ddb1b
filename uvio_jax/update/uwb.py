"""UWB range updates with bias-compensated anchors.

JAX equivalent of the reference's novel layer
(`uvio/src/update/UpdaterUWB.{h,cpp}`, `UVioUpdaterHelper.cpp:147-241`):

Range model (uvio_sensor_data.h:34-69):

    y = (1 + alpha_a) * d + gamma_a + n,
    d = || p_AinG - p_UinG ||,
    p_UinG = p_IinG - R_GtoI^T p_IinU        (lever arm, UVioUpdaterHelper)

Per-range *single* updates (scan) so chi2 can reject individual ranges
(the reference's explicit design rationale, `UVioManager.cpp:334-336`).

Jacobian blocks (validated against autodiff in tests):
    dr/dtheta  = -(1+a) u^T R^T [p_IinU]_x        (JPL left error on q_GtoI)
    dr/dp      = -(1+a) u^T
    dr/dp_IinU =  (1+a) u^T R^T
    dr/dp_A    = -(1+a) (-u^T) = ... see code
    dr/dgamma  = -1,  dr/dalpha = -d
with u = (p_AinG - p_UinG)/d.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..filter.ekf import ekf_update
from ..math import quat_to_rot, skew
from ..math.chi2 import chi2_95
from ..types.layout import StateLayout
from ..types.state import FilterState


def predicted_range(state: FilterState, anchor_idx):
    """(y_hat, d, u, p_U) for one anchor index (traced)."""
    R = quat_to_rot(state.q)
    p_U = state.p - R.T @ state.uwb_p_IinU
    p_A = state.anchors_p[anchor_idx]
    diff = p_A - p_U
    d = jnp.linalg.norm(diff)
    safe_d = jnp.where(d < 1e-9, 1.0, d)
    u = diff / safe_d
    y_hat = (1.0 + state.anchors_alpha[anchor_idx]) * d + state.anchors_gamma[anchor_idx]
    return y_hat, d, u, p_U


def _range_jacobian(state: FilterState, layout: StateLayout, anchor_idx):
    """H (1,D) for the range of one anchor.

    Linearized at the CURRENT pose like the reference
    (`UVioUpdaterHelper.cpp:188-231` uses `clone_I->Rot()/pos()`, no
    FEJ): consecutive single-range updates re-linearize at the already-
    corrected pose.

    Reference deviation (kept deliberately): the reference's anchor-
    position Jacobian carries a spurious `R_GtoI^T` factor
    (`UVioUpdaterHelper.cpp:238` `H_z_anc = (1+α) H_n R^T` — the anchor
    state p_AinG lives in the global frame, so d‖p_A−p_U‖/dp_A is the
    bare unit vector). We use the analytically correct `(1+α) u^T`
    (validated against autodiff in tests/test_uwb.py).
    """
    L = layout
    D = L.dim
    dtype = state.cov.dtype
    R = quat_to_rot(state.q)
    p_U = state.p - R.T @ state.uwb_p_IinU
    p_A = state.anchors_p[anchor_idx]
    alpha = state.anchors_alpha[anchor_idx]
    diff = p_A - p_U
    d = jnp.linalg.norm(diff)
    safe_d = jnp.where(d < 1e-9, 1.0, d)
    u = diff / safe_d
    k = 1.0 + alpha

    # H = d(y_hat)/dx; the EKF consumes r = y - y_hat ~ -H dx + n, i.e.
    # standard innovation form with K = P H^T S^{-1}.
    H = jnp.zeros((1, D), dtype)
    # dp_U/dtheta = R^T [p_IinU]_x  (JPL left error on q_GtoI), and
    # dy/dp_U = -(1+a) u^T:
    dpu_dth = R.T @ skew(state.uwb_p_IinU)
    H = H.at[0, L.theta_off : L.theta_off + 3].set(-k * (u @ dpu_dth))
    H = H.at[0, L.p_off : L.p_off + 3].set(-k * u)
    if L.calib_uwb_extrinsics:
        # dp_U/dp_IinU = -R^T  ->  dy = +(1+a) u^T R^T
        H = jax.lax.dynamic_update_slice(
            H, (k * (u @ R.T))[None, :], (jnp.int32(0), jnp.int32(L.calib_uwb_off))
        )
    # anchor block [p_A(3), gamma, alpha]: dy = [(1+a) u^T, 1, d]
    a_off = jnp.int32(L.anchor_off + 5 * anchor_idx)
    row = jnp.concatenate([k * u, jnp.ones((1,), dtype), d[None]])
    H = jax.lax.dynamic_update_slice(H, row[None, :], (jnp.int32(0), a_off))
    return H, d


def uwb_update(
    state: FilterState,
    layout: StateLayout,
    ranges: jnp.ndarray,
    range_mask: jnp.ndarray,
    sigma_range: float = 0.1,
    chi2_mult: float = 1.0,
):
    """Sequential per-anchor single-range updates (UpdaterUWB::update_single).

    ranges (A,), range_mask (A,) valid measurements. Returns
    (state, {accepted (A,)}).
    """
    L = layout
    A = L.max_anchors
    dtype = state.cov.dtype
    ranges = ranges.astype(dtype)

    def body(st, inp):
        a_idx, y, valid = inp
        valid = valid & st.anchors_valid[a_idx]
        H, d = _range_jacobian(st, L, a_idx)
        y_hat, _, _, _ = predicted_range(st, a_idx)
        r = jnp.where(valid, y - y_hat, 0.0)[None]
        Hm = H * valid
        S = (Hm @ st.cov @ Hm.T)[0, 0] + sigma_range**2
        gamma = r[0] * r[0] / S
        accept = valid & (gamma < chi2_mult * chi2_95(1))

        def do(s):
            new_s, _ = ekf_update(
                s, L, Hm, r, jnp.full((1,), sigma_range**2, dtype), jnp.ones((1,), bool)
            )
            return new_s

        st = jax.lax.cond(accept, do, lambda s: s, st)
        return st, accept

    idxs = jnp.arange(A, dtype=jnp.int32)
    state, accepted = jax.lax.scan(body, state, (idxs, ranges, range_mask))
    return state, {"accepted": accepted}
