"""MSCKF visual update — fully batched.

JAX equivalent of `ov_msckf/src/update/UpdaterMSCKF.{h,cpp}` +
`UpdaterHelper.{h,cpp}`:

  * per-feature measurement Jacobians with FEJ linearization points
    (`UpdaterHelper::get_feature_jacobian_full`, UpdaterHelper.cpp:
    192-424) — here for the GLOBAL_3D landmark representation, with
    optional camera extrinsic/intrinsic calibration columns;
  * nullspace projection of H_f (`nullspace_project_inplace`,
    UpdaterHelper.cpp:426-454) as a batched complete QR over packed
    (valid-rows-first) per-feature systems;
  * 95% chi2 gating (`UpdaterMSCKF.cpp:221-243`);
  * measurement compression (`measurement_compress_inplace`,
    UpdaterHelper.cpp:456-487) as one tall reduced QR;
  * a single fused EKF update (`StateHelper::EKFUpdate`).

Shapes: F features x K clone slots x C cameras, rows = 2 per obs.
Masked rows are exact zeros end-to-end, which makes them algebraically
inert in every step (zero Kalman-gain columns; see ekf.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..cam import models as cam_models
from ..filter.ekf import ekf_update
from ..math import quat_to_rot, skew
from ..math.chi2 import chi2_95
from ..types.layout import StateLayout
from ..types.state import FilterState
from .triangulation import triangulate_batch


def clone_camera_poses(state: FilterState, layout: StateLayout):
    """Per (clone slot, camera) world->camera poses.

    Returns (R_GtoC (K,C,3,3), p_CinG (K,C,3)) for current values and
    the same pair for FEJ linearization points.
    """
    R_GtoI = quat_to_rot(state.clones_q)  # (K,3,3)
    R_GtoI_fej = quat_to_rot(state.clones_q_fej)
    R_ItoC = quat_to_rot(state.calib_cam_q)  # (C,3,3)
    p_IinC = state.calib_cam_p  # (C,3)

    def cam_pose(R_GtoI_k, p_IinG_k):
        R_GtoC = jnp.einsum("cij,jk->cik", R_ItoC, R_GtoI_k)
        # p_CinG = p_I + R_GtoI^T (-R_ItoC^T p_IinC)
        p_CinI = -jnp.einsum("cji,cj->ci", R_ItoC, p_IinC)
        p_CinG = p_IinG_k[None] + jnp.einsum("ji,cj->ci", R_GtoI_k, p_CinI)
        return R_GtoC, p_CinG

    R_val, p_val = jax.vmap(cam_pose)(R_GtoI, state.clones_p)
    R_fej, p_fej = jax.vmap(cam_pose)(R_GtoI_fej, state.clones_p_fej)
    return (R_val, p_val), (R_fej, p_fej)


def feature_system(
    state: FilterState,
    layout: StateLayout,
    cam_model: int,
    feat_p: jnp.ndarray,
    feat_p_fej: jnp.ndarray,
    obs_uv: jnp.ndarray,
    obs_mask: jnp.ndarray,
    sigma_pix: float,
):
    """Build the stacked measurement system for a feature batch.

    feat_p/feat_p_fej (F,3) global landmark estimates / linearization
    points; obs_uv (F,K,C,2) raw pixels; obs_mask (F,K,C).
    Returns H_x (F,M,D), H_f (F,M,3), res (F,M), row_mask (F,M) with
    M = 2*K*C rows per feature.
    """
    L = layout
    K, C, D = L.max_clones, L.num_cams, L.dim
    F = feat_p.shape[0]
    dtype = state.cov.dtype

    R_GtoI = quat_to_rot(state.clones_q)
    R_GtoI_fej = quat_to_rot(state.clones_q_fej)
    R_ItoC = quat_to_rot(state.calib_cam_q)
    p_IinC = state.calib_cam_p
    intr = state.calib_cam_intr

    # ---- value leg: predicted measurements (current estimates) ----
    # p_FinI[f,k] = R_GtoI_k (p_f - p_Ik)
    dpf = feat_p[:, None, :] - state.clones_p[None, :, :]  # (F,K,3)
    p_FinI = jnp.einsum("kij,fkj->fki", R_GtoI, dpf)  # (F,K,3)
    p_FinC = jnp.einsum("cij,fkj->fkci", R_ItoC, p_FinI) + p_IinC[None, None]  # (F,K,C,3)
    z = p_FinC[..., 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    uvn = p_FinC[..., 0:2] / safe_z[..., None]  # (F,K,C,2)
    uv_pred = _distort_percam(intr, cam_model, uvn)
    res2 = obs_uv - uv_pred  # (F,K,C,2)

    # ---- Jacobian leg: FEJ geometry, current-projection chain ----
    dpf_fej = feat_p_fej[:, None, :] - state.clones_p_fej[None, :, :]
    p_FinI_fej = jnp.einsum("kij,fkj->fki", R_GtoI_fej, dpf_fej)
    # FEJ camera-frame point: the projection Jacobian d uv_norm/d p_FinC
    # is evaluated at the FEJ linearization like the reference
    # (`UpdaterHelper.cpp:354-372`: p_FinCi is overwritten with the FEJ
    # value before dzn_dpfc is built; dz_dzn stays at the current uv).
    p_FinC_fej = (
        jnp.einsum("cij,fkj->fkci", R_ItoC, p_FinI_fej) + p_IinC[None, None]
    )  # (F,K,C,3)
    z_fej = p_FinC_fej[..., 2]
    safe_zf = jnp.where(jnp.abs(z_fej) < 1e-6, 1e-6, z_fej)

    # d uv / d uv_norm and d uv / d intrinsics at current estimate
    J_norm, J_calib = _distort_jacobian_percam(intr, cam_model, uvn)  # (F,K,C,2,2),(F,K,C,2,8)
    # d uv_norm / d p_FinC at the FEJ point
    zero = jnp.zeros_like(safe_zf)
    one = jnp.ones_like(safe_zf)
    Hproj = jnp.stack(
        [
            jnp.stack([one / safe_zf, zero, -p_FinC_fej[..., 0] / safe_zf**2], axis=-1),
            jnp.stack([zero, one / safe_zf, -p_FinC_fej[..., 1] / safe_zf**2], axis=-1),
        ],
        axis=-2,
    )  # (F,K,C,2,3)
    Hcam = jnp.einsum("fkcab,fkcbe->fkcae", J_norm, Hproj)  # (F,K,C,2,3) d uv/d p_FinC

    # d p_FinC / d theta_k = R_ItoC [p_FinI_fej]_x ; d/d p_k = -R_ItoC R_GtoI_fej
    RC = R_ItoC[None, None, :, :, :]  # (1,1,C,3,3)
    sk = skew(p_FinI_fej)  # (F,K,3,3)
    dpc_dth = jnp.einsum("cij,fkjl->fkcil", R_ItoC, sk)  # (F,K,C,3,3)
    RR_fej = jnp.einsum("cij,kjl->kcil", R_ItoC, R_GtoI_fej)  # (K,C,3,3)
    dpc_dp = -RR_fej[None]  # broadcast (F,K,C,3,3)
    dpc_df = RR_fej[None]

    H_th = jnp.einsum("fkcab,fkcbe->fkcae", Hcam, dpc_dth)  # (F,K,C,2,3)
    H_p = jnp.einsum("fkcab,fkcbe->fkcae", Hcam, jnp.broadcast_to(dpc_dp, Hcam.shape[:3] + (3, 3)))
    H_f = jnp.einsum("fkcab,fkcbe->fkcae", Hcam, jnp.broadcast_to(dpc_df, Hcam.shape[:3] + (3, 3)))

    # assemble H_x (F,K,C,2,D) by concatenating layout-ordered column
    # blocks (imu | calib | clones | slam | anchors); per-slot/per-cam
    # placement is a one-hot einsum — one fused op instead of an
    # unrolled update chain (keeps the compiled program small)
    lead = (F, K, C, 2)
    # imu (+imu-intrinsics) columns: no direct visual dependence
    blocks = [jnp.zeros(lead + (L.calib_off,), dtype)]
    if L.calib_cam_timeoffset:
        blocks.append(jnp.zeros(lead + (1,), dtype))
    if L.calib_cam_pose:
        # error on q_ItoC, p_IinC: d p_FinC/d th_C = [p_FinC - p_IinC]_x,
        # d/d p_IinC = I — evaluated at the FEJ point (the reference's
        # dpfc_dcalib uses the possibly-FEJ-overwritten p_FinCi)
        sk_c = skew(p_FinC_fej - p_IinC[None, None])  # (F,K,C,3,3)
        H_thc = jnp.einsum("fkcab,fkcbe->fkcae", Hcam, sk_c)
        H_ext = jnp.concatenate([H_thc, Hcam], axis=-1)  # (F,K,C,2,6)
        eyeC = jnp.eye(C, dtype=dtype)
        blocks.append(
            jnp.einsum("fkcre,cd->fkcrde", H_ext, eyeC).reshape(lead + (6 * C,))
        )
    if L.calib_cam_intrinsics:
        eyeC = jnp.eye(C, dtype=dtype)
        blocks.append(
            jnp.einsum("fkcre,cd->fkcrde", J_calib, eyeC).reshape(lead + (8 * C,))
        )
    if L.calib_uwb_extrinsics:
        blocks.append(jnp.zeros(lead + (3,), dtype))  # no visual dependence
    H_clone = jnp.concatenate([H_th, H_p], axis=-1)  # (F,K,C,2,6)
    eyeK = jnp.eye(K, dtype=dtype)
    blocks.append(
        jnp.einsum("fkcre,kj->fkcrje", H_clone, eyeK).reshape(lead + (6 * K,))
    )
    tail = L.dim - L.slam_off
    if tail > 0:
        blocks.append(jnp.zeros(lead + (tail,), dtype))
    Hx = jnp.concatenate(blocks, axis=-1)

    M = K * C * 2
    row_mask = jnp.broadcast_to(obs_mask[..., None], obs_mask.shape + (2,))
    Hx = (Hx * row_mask[..., None]).reshape(F, M, D)
    H_f = (H_f * row_mask[..., None]).reshape(F, M, 3)
    res = (res2 * row_mask).reshape(F, M)
    return Hx, H_f, res, row_mask.reshape(F, M)


def _distort_percam(intr, cam_model, uvn):
    """Apply per-camera distortion: uvn (F,K,C,2) -> uv (F,K,C,2)."""
    outs = [
        cam_models.distort(intr[c], cam_model, uvn[:, :, c, :])
        for c in range(uvn.shape[2])
    ]
    return jnp.stack(outs, axis=2)


def _distort_jacobian_percam(intr, cam_model, uvn):
    Jn, Jc = [], []
    for c in range(uvn.shape[2]):
        jn, jc = cam_models.distort_jacobian(intr[c], cam_model, uvn[:, :, c, :])
        Jn.append(jn)
        Jc.append(jc)
    return jnp.stack(Jn, axis=2), jnp.stack(Jc, axis=2)


def _pack_rows(Hx, H_f, res, row_mask):
    """Reorder each feature's rows so valid rows come first (stable).

    With trailing all-zero rows, Householder QR of H_f leaves those rows
    untouched, making the nullspace projection exact for padded systems.
    """
    order = jnp.argsort(~row_mask, axis=1, stable=True)  # valid first
    take = lambda a: jnp.take_along_axis(a, order.reshape(order.shape + (1,) * (a.ndim - 2)), axis=1)
    return take(Hx), take(H_f), jnp.take_along_axis(res, order, axis=1), jnp.take_along_axis(
        row_mask, order, axis=1
    )


def nullspace_project(Hx, H_f, res):
    """Left-nullspace projection of H_f per feature via complete QR.

    Returns (Hx_proj (F,M-3,D), res_proj (F,M-3)).
    """

    def one(Hx_f, Hf_f, r_f):
        Q, _ = jnp.linalg.qr(Hf_f, mode="complete")  # (M,M)
        Q2 = Q[:, 3:]
        return Q2.T @ Hx_f, Q2.T @ r_f

    return jax.vmap(one)(Hx, H_f, res)


def chi2_gate(Hx_proj, res_proj, cov, nobs_rows, sigma_pix, chi2_mult=1.0):
    """Per-feature Mahalanobis gating (UpdaterMSCKF.cpp:221-243).

    nobs_rows (F,) = number of valid rows (2n); dof = 2n - 3.
    Returns keep (F,) bool.
    """

    def one(H_o, r_o):
        S = H_o @ cov @ H_o.T + sigma_pix**2 * jnp.eye(H_o.shape[0], dtype=H_o.dtype)
        chol = jax.scipy.linalg.cho_factor(S, lower=True)
        return r_o @ jax.scipy.linalg.cho_solve(chol, r_o)

    gamma = jax.vmap(one)(Hx_proj, res_proj)
    dof = jnp.maximum(nobs_rows - 3, 1)
    return gamma < chi2_mult * chi2_95(dof, max_dof=Hx_proj.shape[1])


def compress_and_update(state, layout, Hx_proj, res_proj, keep, sigma_pix):
    """Stack kept features, compress via tall QR, one EKF update."""
    F, Mp, D = Hx_proj.shape
    w = keep[:, None, None].astype(Hx_proj.dtype)
    H_big = (Hx_proj * w).reshape(F * Mp, D)
    r_big = (res_proj * keep[:, None]).reshape(F * Mp)
    # measurement compression: rows -> at most D
    Q, Rf = jnp.linalg.qr(H_big, mode="reduced")  # (rows,D),(D,D)
    r_c = Q.T @ r_big
    r_diag = jnp.full((D,), sigma_pix**2, H_big.dtype)
    mask = jnp.ones((D,), bool)
    return ekf_update(state, layout, Rf, r_c, r_diag, mask)


def msckf_update(
    state: FilterState,
    layout: StateLayout,
    cam_model: int,
    obs_uv: jnp.ndarray,
    obs_mask: jnp.ndarray,
    sigma_pix: float = 1.0,
    chi2_mult: float = 1.0,
):
    """Full MSCKF update on a padded feature batch (UpdaterMSCKF::update).

    obs_uv (F,K,C,2) raw pixel tracks aligned to clone slots; obs_mask
    (F,K,C). Triangulates, builds Jacobians, projects, gates, compresses
    and applies one EKF update. Returns (new_state, info dict).
    """
    L = layout
    K, C = L.max_clones, L.num_cams
    obs_uv = obs_uv.astype(state.cov.dtype)
    # undistort obs to normalized coords for triangulation
    uvn_obs = jnp.stack(
        [
            cam_models.undistort(state.calib_cam_intr[c], cam_model, obs_uv[:, :, c, :])
            for c in range(C)
        ],
        axis=2,
    )
    (R_val, p_val), _ = clone_camera_poses(state, layout)
    R_flat = R_val.reshape(K * C, 3, 3)
    p_flat = p_val.reshape(K * C, 3)
    uvn_flat = uvn_obs.reshape(-1, K * C, 2)
    m_flat = obs_mask.reshape(-1, K * C)
    feat_p, tri_ok = triangulate_batch(uvn_flat, m_flat, R_flat, p_flat)

    Hx, H_f, res, row_mask = feature_system(
        state, layout, cam_model, feat_p, feat_p, obs_uv, obs_mask, sigma_pix
    )
    # drop features that failed triangulation or have <2 observations
    # (2n rows must exceed the 3 projected-out dof)
    ok = tri_ok & (jnp.sum(row_mask, axis=1) >= 4)
    Hx = Hx * ok[:, None, None]
    H_f = H_f * ok[:, None, None]
    res = res * ok[:, None]
    row_mask = row_mask & ok[:, None]

    Hx_p, H_f_p, res_p, rm_p = _pack_rows(Hx, H_f, res, row_mask)
    Hx_proj, res_proj = nullspace_project(Hx_p, H_f_p, res_p)
    nrows = jnp.sum(rm_p, axis=1)
    keep = chi2_gate(Hx_proj, res_proj, state.cov, nrows, sigma_pix, chi2_mult) & ok
    new_state, diag = compress_and_update(state, layout, Hx_proj, res_proj, keep, sigma_pix)
    info = {
        "tri_ok": tri_ok,
        "kept": keep,
        "num_used": jnp.sum(keep),
        "cov_ok": diag["cov_ok"],
    }
    return new_state, info
