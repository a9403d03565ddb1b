"""SLAM landmark updates — delayed initialization and re-observation.

JAX equivalent of `ov_msckf/src/update/UpdaterSLAM.{h,cpp}`:

  * `slam_delayed_init` <- `UpdaterSLAM::delayed_init` (UpdaterSLAM.cpp:
    61-251): triangulate candidate long tracks, split each stacked
    system via QR into an invertible 3-dof init system + an update
    system (`StateHelper::initialize`), chi2-gate, write the landmark
    into its slot (covariance cross terms via H_L^{-1}), then apply the
    leftover update rows.
  * `slam_update` <- `UpdaterSLAM::update` (UpdaterSLAM.cpp:253-479):
    re-observation EKF update of existing landmarks; the landmark
    Jacobian lands in the landmark's own covariance columns (no
    nullspace projection). chi2 failures are reported so the manager
    can count them toward marginalization (update_fail_count).

Landmark representations (update/representations.py): GLOBAL_3D,
ANCHORED_MSCKF_INVERSE_DEPTH (the reference's shipped default),
ANCHORED_3D, and GLOBAL_FULL_INVERSE_DEPTH — with anchor-pose Jacobian
terms and covariance-exact anchor changes for the anchored ones.

Slot alignment: the SLAM obs tensor is indexed by *slam slot* (S,K,C,2),
so landmark columns are static offsets; candidates carry explicit slot
targets and are initialized sequentially in a scan (each init changes
the covariance).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..filter.ekf import ekf_update, initialize_invertible_block
from ..math.chi2 import chi2_95
from ..types.layout import StateLayout
from ..types.state import FilterState
from .msckf import _pack_rows, clone_camera_poses, feature_system
from .representations import (
    ANCHORED_MSCKF_INVERSE_DEPTH,
    GLOBAL_3D,
    GLOBAL_FULL_INVERSE_DEPTH,
    anchor_point_from_value,
    anchored_chain,
    d_anchor_point_d_value,
    d_point_d_sphere,
    is_anchored,
    point_to_rep,
    value_from_anchor_point,
)
from .triangulation import triangulate_batch
from ..cam import models as cam_models
from ..math import quat_to_rot, skew


def slam_update(
    state: FilterState,
    layout: StateLayout,
    obs_uv: jnp.ndarray,
    obs_mask: jnp.ndarray,
    cam_model: int,
    sigma_pix: float = 1.0,
    chi2_mult: float = 1.0,
):
    """EKF update on existing landmarks. obs tensors are (S,K,C,·)
    aligned to slam slots; invalid slots must be masked out."""
    L = layout
    S, K, C, D = L.max_slam, L.max_clones, L.num_cams, L.dim
    obs_uv = obs_uv.astype(state.cov.dtype)
    obs_mask = obs_mask & state.slam_valid[:, None, None]

    # representation -> global positions + FEJ chain pieces
    p_glob, p_glob_fej, J_rep, H_anc = anchored_chain(state, L)
    Hx, H_fG, res, row_mask = feature_system(
        state, L, cam_model, p_glob, p_glob_fej, obs_uv, obs_mask, sigma_pix
    )
    M = Hx.shape[1]
    # landmark columns: chain through the representation; one-hot einsum
    # places each landmark's block into its own slot columns
    H_f = jnp.einsum("smj,sjk->smk", H_fG, J_rep)
    eyeS = jnp.eye(S, dtype=Hx.dtype)
    slam_block = jnp.einsum("smj,st->smtj", H_f, eyeS).reshape(S, M, 3 * S)
    Hx = Hx.at[:, :, L.slam_off : L.slam_off + 3 * S].set(slam_block)
    # anchor-pose columns: d h/d p_FinG @ d p_FinG/d(anchor clone)
    # (UpdaterHelper.cpp:100-112 H_anc — included for ALL anchored reps)
    if L.slam_rep != GLOBAL_3D:
        extra = jnp.einsum("smj,sjk->smk", H_fG, H_anc)  # (S,M,6)

        def add_anchor(Hx_s, extra_s, a_slot):
            off = jnp.int32(L.clone_off + 6 * a_slot)
            cur = jax.lax.dynamic_slice(Hx_s, (jnp.int32(0), off), (M, 6))
            return jax.lax.dynamic_update_slice(Hx_s, cur + extra_s, (jnp.int32(0), off))

        Hx = jax.vmap(add_anchor)(Hx, extra, state.slam_anchor_slot)

    # Pack valid rows first and TRUNCATE to a small static per-landmark
    # row capacity: the padded (K*C*2)-row blocks are almost entirely
    # zeros in steady state (only the newest frame's obs are unconsumed
    # — 2C valid rows of 22), and the chi2/compression/update cost
    # scales with the row count. Capacity covers a 4-frame backlog
    # (occlusion-resume); overflow beyond it is dropped (rare; those
    # measurements are consumed unused, like the reference dropping
    # measurements cleaned from the database).
    Mr = min(M, 8 * C)
    order = jnp.argsort(~row_mask, axis=1, stable=True)
    take = lambda a: jnp.take_along_axis(
        a, order.reshape(order.shape + (1,) * (a.ndim - 2)), axis=1
    )[:, :Mr]
    Hx = take(Hx)
    res = jnp.take_along_axis(res, order, axis=1)[:, :Mr]
    row_mask_t = jnp.take_along_axis(row_mask, order, axis=1)[:, :Mr]

    # chi2 gate per landmark: gamma = r^T (H P H^T + R)^{-1} r, dof=rows
    def gamma_one(H_o, r_o):
        Sm = H_o @ state.cov @ H_o.T + sigma_pix**2 * jnp.eye(Mr, dtype=H_o.dtype)
        chol = jax.scipy.linalg.cho_factor(Sm, lower=True)
        return r_o @ jax.scipy.linalg.cho_solve(chol, r_o)

    gamma = jax.vmap(gamma_one)(Hx, res)
    nrows = jnp.sum(row_mask_t, axis=1)
    has_obs = nrows > 0
    keep = (gamma < chi2_mult * chi2_95(jnp.maximum(nrows, 1), max_dof=Mr)) & has_obs

    w = keep[:, None, None].astype(Hx.dtype)
    H_big = (Hx * w).reshape(S * Mr, D)
    r_big = (res * keep[:, None]).reshape(S * Mr)
    # with the truncated row capacity S*Mr may be BELOW D, so the
    # compressed system has min(S*Mr, D) rows, not always D
    rows_c = min(S * Mr, D)
    Q, Rf = jnp.linalg.qr(H_big, mode="reduced")
    r_c = Q.T @ r_big
    new_state, diag = ekf_update(
        state, L, Rf, r_c,
        jnp.full((rows_c,), sigma_pix**2, H_big.dtype),
        jnp.ones((rows_c,), bool),
    )
    failed = has_obs & ~keep
    return new_state, {"kept": keep, "failed": failed, "cov_ok": diag["cov_ok"]}


def slam_delayed_init(
    state: FilterState,
    layout: StateLayout,
    obs_uv: jnp.ndarray,
    obs_mask: jnp.ndarray,
    target_slots: jnp.ndarray,
    cand_ids: jnp.ndarray,
    cam_model: int,
    sigma_pix: float = 1.0,
    chi2_mult: float = 1.0,
):
    """Initialize up to F_c candidate landmarks into given slam slots.

    obs_uv (Fc,K,C,2), obs_mask (Fc,K,C), target_slots (Fc,) int32
    (slam slot index, assumed free), cand_ids (Fc,) int32 feature ids
    (-1 = inactive candidate).
    """
    L = layout
    Fc, K, C, D = obs_uv.shape[0], L.max_clones, L.num_cams, L.dim
    obs_uv = obs_uv.astype(state.cov.dtype)

    # triangulate candidates
    uvn_obs = jnp.stack(
        [
            cam_models.undistort(state.calib_cam_intr[c], cam_model, obs_uv[:, :, c, :])
            for c in range(C)
        ],
        axis=2,
    )
    (R_val, p_val), _ = clone_camera_poses(state, L)
    # GLOBAL_3D landmarks persist with a frozen (FEJ) linearization and no
    # inverse-depth conditioning to absorb depth error, so they demand much
    # stronger geometry; anchored inverse depth tolerates the reference's
    # full 40x depth/baseline bound.
    max_bl = 40.0 if L.slam_rep != GLOBAL_3D else 10.0
    feat_p, tri_ok = triangulate_batch(
        uvn_obs.reshape(Fc, K * C, 2),
        obs_mask.reshape(Fc, K * C),
        R_val.reshape(K * C, 3, 3),
        p_val.reshape(K * C, 3),
        max_baseline=max_bl,
    )

    Hx, H_f, res, row_mask = feature_system(
        state, L, cam_model, feat_p, feat_p, obs_uv, obs_mask, sigma_pix
    )
    # representation chain at the anchor (= newest clone, like the
    # reference which anchors new landmarks at the last clone)
    anchor_slot = state.clone_head
    anchor_cam = jnp.int32(0)
    rep = L.slam_rep
    # the 1-dof depth rep initializes through the full 3-dof inverse
    # depth chain (its own chain has a singular bearing block); the
    # bearing dofs are frozen right after insertion below
    from .representations import ANCHORED_INVERSE_DEPTH_SINGLE, ANCHORED_MSCKF_INVERSE_DEPTH

    rep_init = (
        ANCHORED_MSCKF_INVERSE_DEPTH
        if rep == ANCHORED_INVERSE_DEPTH_SINGLE
        else rep
    )
    if is_anchored(rep):
        # landmark VALUE: triangulated point in the CURRENT anchor frame
        vals0 = jax.vmap(
            lambda p: point_to_rep(state, L, p, anchor_slot, anchor_cam)
        )(feat_p)
        # Jacobian chain at the FEJ anchor pose, like the reference
        # (`get_feature_jacobian_representation` FEJ branch,
        # UpdaterHelper.cpp:88-99): re-express the triangulated global
        # point in the FEJ anchor frame and linearize there.
        R_ItoC = quat_to_rot(state.calib_cam_q[anchor_cam])
        p_IinC = state.calib_cam_p[anchor_cam]
        R_GtoI_af = quat_to_rot(state.clones_q_fej[anchor_slot])
        p_I_af = state.clones_p_fej[anchor_slot]
        R_GtoC_af = R_ItoC @ R_GtoI_af
        p_FinA_fej = jax.vmap(
            lambda p: R_ItoC @ (R_GtoI_af @ (p - p_I_af)) + p_IinC
        )(feat_p)
        J_chain = jax.vmap(
            lambda pA: R_GtoC_af.T
            @ d_anchor_point_d_value(rep_init, value_from_anchor_point(rep_init, pA))
        )(p_FinA_fej)
        H_fG = H_f
        H_f = jnp.einsum("smj,sjk->smk", H_fG, J_chain)
        # anchor-pose term added into the anchor clone's columns
        M0 = H_fG.shape[1]

        def anc_one(pA):
            th = -R_GtoI_af.T @ skew(R_ItoC.T @ (pA - p_IinC))
            return jnp.concatenate([th, jnp.eye(3, dtype=pA.dtype)], axis=1)

        H_anc0 = jax.vmap(anc_one)(p_FinA_fej)  # (Fc,3,6)
        extra = jnp.einsum("smj,sjk->smk", H_fG, H_anc0)
        a_off = jnp.int32(L.clone_off + 6 * anchor_slot)

        def add_anchor(Hx_s, extra_s):
            cur = jax.lax.dynamic_slice(Hx_s, (jnp.int32(0), a_off), (M0, 6))
            return jax.lax.dynamic_update_slice(
                Hx_s, cur + extra_s, (jnp.int32(0), a_off)
            )

        Hx = jax.vmap(add_anchor)(Hx, extra)
        # anchored features must be in front of the anchor camera
        depth_ok = jax.vmap(
            lambda v: anchor_point_from_value(rep, v)[2] > 0.1
        )(vals0)
        tri_ok = tri_ok & depth_ok
    elif rep == GLOBAL_FULL_INVERSE_DEPTH:
        vals0 = jax.vmap(
            lambda p: point_to_rep(state, L, p, anchor_slot, anchor_cam)
        )(feat_p)
        J_chain = jax.vmap(d_point_d_sphere)(vals0)
        H_f = jnp.einsum("smj,sjk->smk", H_f, J_chain)
    else:
        vals0 = feat_p
    Hx_p, H_f_p, res_p, rm_p = _pack_rows(Hx, H_f, res, row_mask)
    active = (cand_ids >= 0) & tri_ok & (jnp.sum(rm_p, axis=1) >= 6)

    M = Hx.shape[1]

    # QR split (StateHelper::initialize Givens equivalent), hoisted out
    # of the sequential scan: the rotation depends only on each
    # candidate's own H_f, so all candidates factor in one vmap batch
    # instead of 8 sequential small complete-QRs
    def split_one(Hx_f, Hf_f, r_f):
        Q, _ = jnp.linalg.qr(Hf_f, mode="complete")
        return (Q.T @ Hf_f)[:3], Q.T @ Hx_f, Q.T @ r_f

    Hf_tri_b, Hx_q_b, r_q_b = jax.vmap(split_one)(Hx_p, H_f_p, res_p)

    def init_one(st, inp):
        Hf_tri, Hx_q, r_q, rm_f, slot, fid, act, p_f = inp
        Hx_init, r_init = Hx_q[:3], r_q[:3]
        Hx_up, r_up = Hx_q[3:], r_q[3:]
        # chi2 on the update portion (dof = total rows, reference quirk:
        # StateHelper.cpp:469-474 uses res.rows())
        Sm = Hx_up @ st.cov @ Hx_up.T + sigma_pix**2 * jnp.eye(M - 3, dtype=st.cov.dtype)
        chol = jax.scipy.linalg.cho_factor(Sm, lower=True)
        gamma = r_up @ jax.scipy.linalg.cho_solve(chol, r_up)
        nrows = jnp.sum(rm_f)
        ok = act & (gamma < chi2_mult * chi2_95(jnp.maximum(nrows, 1), max_dof=M))
        # guard invertibility (Hf_tri is upper triangular from the QR)
        ok = ok & (jnp.abs(jnp.prod(jnp.diagonal(Hf_tri))) > 1e-9)

        def do(st):
            off = L.slam_slot_off(slot)
            new_cov, dxf = initialize_invertible_block(
                st.cov, off, Hx_init, Hf_tri,
                jnp.full((3,), sigma_pix**2, st.cov.dtype), r_init,
            )
            p_new = p_f + dxf
            # FEJ value frozen at the PRE-correction triangulated value:
            # the reference sets the landmark fej before
            # `StateHelper::initialize` applies the init correction
            # (UpdaterSLAM.cpp:218-226 + StateHelper.cpp:393-482)
            st = st.replace(
                cov=new_cov,
                slam_p=st.slam_p.at[slot].set(p_new),
                slam_p_fej=st.slam_p_fej.at[slot].set(p_f),
                slam_valid=st.slam_valid.at[slot].set(True),
                slam_id=st.slam_id.at[slot].set(fid),
                slam_anchor_slot=st.slam_anchor_slot.at[slot].set(anchor_slot),
                slam_anchor_cam=st.slam_anchor_cam.at[slot].set(anchor_cam),
            )
            # apply the leftover (nullspace-projected) update rows
            st, _ = ekf_update(
                st, L, Hx_up, r_up,
                jnp.full((M - 3,), sigma_pix**2, st.cov.dtype),
                jnp.ones((M - 3,), bool),
            )
            if rep == ANCHORED_INVERSE_DEPTH_SINGLE:
                # freeze the bearing dofs: alpha/beta become perfectly
                # known constants (1-dof landmark, Landmark size 1)
                z2 = jnp.zeros((2, L.dim), st.cov.dtype)
                cov = jax.lax.dynamic_update_slice(st.cov, z2, (off, jnp.int32(0)))
                cov = jax.lax.dynamic_update_slice(cov, z2.T, (jnp.int32(0), off))
                st = st.replace(cov=cov)
            return st

        st = jax.lax.cond(ok, do, lambda s: s, st)
        return st, ok

    state, inited = jax.lax.scan(
        init_one,
        state,
        (Hf_tri_b, Hx_q_b, r_q_b, rm_p, target_slots, cand_ids, active, vals0),
    )
    return state, {"inited": inited}
