"""Dynamic (in-motion) initialization.

JAX equivalent of `ov_init/src/dynamic/DynamicInitializer.cpp`
(1,209 LoC + ceres factors): recover orientation (gravity), velocity,
biases and feature depths from a short window while moving.

Differences from the reference's ceres pipeline, by design:

  * poses inside the window are not free variables — they are *shot*
    from (v0, g, bg, ba) through differentiable preintegration
    (`init/cpi.py`), so the IMU factors hold exactly and the MLE
    reduces to reprojection residuals + bias/gravity priors (the
    VINS-style closed formulation; ceres DENSE_SCHUR becomes one small
    Gauss-Newton with jacfwd Jacobians);
  * the linear bootstrap solves [v0, g, features] from the bearing
    cross-product system (same structure as `DynamicInitializer.cpp:
    355-389`), then the constrained |g| refinement happens inside the
    damped GN via a gravity-magnitude residual.

Everything is static-shape: P pose times, padded IMU slices between
them, F padded feature tracks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..math import rot_to_quat, skew
from .cpi import preintegrate, preintegrate_v1
from .static_init import StaticInitResult, gravity_aligned_quat


@dataclasses.dataclass
class DynamicInitOptions:
    num_pose: int = 6  # init_dyn_num_pose
    max_features: int = 25  # init_max_features
    gn_iters: int = 10  # init_dyn_mle_max_iter
    sigma_pix_norm: float = 2e-3  # reprojection sigma in normalized units
    bias_prior: float = 0.1
    gravity_mag: float = 9.81
    min_features: int = 8
    max_reproj_rmse: float = 5e-3  # acceptance gate (normalized units)
    # remaining reference knob set (`InertialInitializerOptions.h:64-116`)
    min_deg: float = 10.0  # init_dyn_min_deg: rotation gate before trying
    min_rec_cond: float = 1e-15  # init_dyn_min_rec_cond: Hessian rcond gate
    # covariance inflation of the seeded prior (applied as
    # sigma = base_sigma * sqrt(inflation); the defaults reproduce the
    # reference defaults 10/10/100/100)
    inflation_ori: float = 10.0  # init_dyn_inflation_orientation
    inflation_vel: float = 10.0  # init_dyn_inflation_velocity
    inflation_bg: float = 100.0  # init_dyn_inflation_bias_gyro
    inflation_ba: float = 100.0  # init_dyn_inflation_bias_accel
    # initial bias seeds for the MLE (init_dyn_bias_{g,a})
    init_bias_g: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    init_bias_a: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    # init_dyn_mle_opt_calib: parsed for config parity but NOT applied —
    # the reference itself ships it default-off and warns it is unstable;
    # calibration states refine online in the filter instead
    mle_opt_calib: bool = False
    # preintegration model: "midpoint" (autodiff midpoint scheme) or
    # "cpi_v1" (the reference's closed-form CpiV1, `cpi/CpiV1.cpp`)
    cpi_model: str = "midpoint" 


def _shoot_poses(cpis, v0, g):
    """Cumulative poses in the I0 frame from per-interval preintegrals.

    cpis: dict of stacked (P-1,...) preintegrals. Returns R_0p (P,3,3),
    p (P,3), v (P,3) — all in the I0 frame (p_0 = 0, R_00 = I).
    """
    P1 = cpis["dt"].shape[0]

    def body(carry, i):
        R0p, p, v = carry
        dt = cpis["dt"][i]
        al = cpis["alpha"][i]
        be = cpis["beta"][i]
        Rk = cpis["R_k2tau"][i]
        p_new = p + v * dt - 0.5 * g * dt * dt + R0p.T @ al
        v_new = v - g * dt + R0p.T @ be
        R_new = Rk @ R0p
        return (R_new, p_new, v_new), (R_new, p_new, v_new)

    eye = jnp.eye(3, dtype=v0.dtype)
    (_, _, _), (Rs, ps, vs) = jax.lax.scan(
        body, (eye, jnp.zeros(3, v0.dtype), v0), jnp.arange(P1)
    )
    R_all = jnp.concatenate([eye[None], Rs], axis=0)
    p_all = jnp.concatenate([jnp.zeros((1, 3), v0.dtype), ps], axis=0)
    v_all = jnp.concatenate([v0[None], vs], axis=0)
    return R_all, p_all, v_all


def _reproj_residuals(params, cpi_inputs, obs_uvn, obs_mask, R_ItoC, p_IinC, opts):
    """Stacked residual vector for the GN.

    params: dict with v0 (3,), g (3,), bg (3,), ba (3,), feats (F,3).
    cpi_inputs: (imu_t (P-1,M), imu_w (P-1,M,3), imu_a (P-1,M,3)).
    obs_uvn (F,P,2) normalized obs; obs_mask (F,P).
    """
    imu_t, imu_w, imu_a = cpi_inputs
    pre = preintegrate_v1 if opts.cpi_model == "cpi_v1" else preintegrate
    cpis = jax.vmap(lambda t, w, a: pre(t, w, a, params["bg"], params["ba"]))(
        imu_t, imu_w, imu_a
    )
    R0p, p0p, _ = _shoot_poses(cpis, params["v0"], params["g"])

    # p_FinC[f,p] = R_ItoC R_0p (x_f - p_p) + p_IinC
    d = params["feats"][:, None, :] - p0p[None, :, :]
    p_inI = jnp.einsum("pij,fpj->fpi", R0p, d)
    p_inC = jnp.einsum("ij,fpj->fpi", R_ItoC, p_inI) + p_IinC[None, None]
    z = p_inC[..., 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-3, 1e-3, z)
    pred = p_inC[..., :2] / safe_z[..., None]
    r_uv = (pred - obs_uvn) * obs_mask[..., None] / opts.sigma_pix_norm
    r_bias = jnp.concatenate([params["bg"], params["ba"]]) / opts.bias_prior
    r_grav = (jnp.linalg.norm(params["g"]) - opts.gravity_mag)[None] / 1e-3
    return jnp.concatenate([r_uv.reshape(-1), r_bias, r_grav])


def _flatten(params):
    return jnp.concatenate(
        [params["v0"], params["g"], params["bg"], params["ba"], params["feats"].reshape(-1)]
    )


def _unflatten(x, F):
    return {
        "v0": x[0:3],
        "g": x[3:6],
        "bg": x[6:9],
        "ba": x[9:12],
        "feats": x[12:].reshape(F, 3),
    }


def solve_dynamic_init(
    imu_t, imu_w, imu_a, obs_uvn, obs_mask, R_ItoC, p_IinC, opts: DynamicInitOptions
):
    """Device-side solve. imu_* are (P-1, M) padded slices between the P
    pose times; obs_uvn (F,P,2). Returns dict of results + diagnostics.
    """
    F = obs_uvn.shape[0]
    dtype = obs_uvn.dtype
    cpi_inputs = (imu_t, imu_w, imu_a)

    # ---- linear bootstrap (zero-bias preintegration) ----
    zero3 = jnp.zeros(3, dtype)
    cpis = jax.vmap(lambda t, w, a: preintegrate(t, w, a, zero3, zero3))(
        imu_t, imu_w, imu_a
    )
    # pose coefficients p_p = Ap v0 + Bp g + cp (recursion in closed form)
    P1 = imu_t.shape[0]

    def coeff_body(carry, i):
        R0p, Ap, Bp, cp, Av, Bv, cv = carry
        dt = cpis["dt"][i]
        Ral = R0p.T @ cpis["alpha"][i]
        Rbe = R0p.T @ cpis["beta"][i]
        eye = jnp.eye(3, dtype=dtype)
        Ap2 = Ap + Av * dt
        Bp2 = Bp + Bv * dt - 0.5 * dt * dt * eye
        cp2 = cp + cv * dt + Ral
        Av2 = Av
        Bv2 = Bv - dt * eye
        cv2 = cv + Rbe
        R_new = cpis["R_k2tau"][i] @ R0p
        return (R_new, Ap2, Bp2, cp2, Av2, Bv2, cv2), (R_new, Ap2, Bp2, cp2)

    eye = jnp.eye(3, dtype=dtype)
    z33 = jnp.zeros((3, 3), dtype)
    (_, _, _, _, _, _, _), (Rs, Aps, Bps, cps) = jax.lax.scan(
        coeff_body, (eye, z33, z33, jnp.zeros(3, dtype), eye, z33, jnp.zeros(3, dtype)),
        jnp.arange(P1),
    )
    R_all = jnp.concatenate([eye[None], Rs])
    A_all = jnp.concatenate([z33[None], Aps])
    B_all = jnp.concatenate([z33[None], Bps])
    c_all = jnp.concatenate([jnp.zeros((1, 3), dtype), cps])

    # bearing constraints: [b]_x (R_ItoC R_0p x_f - R_ItoC R_0p p_p + p_IinC) = 0
    P = R_all.shape[0]
    n_unk = 6 + 3 * F

    def obs_rows(f, p):
        b = jnp.concatenate([obs_uvn[f, p], jnp.ones((1,), dtype)])
        Bx = skew(b)[:2]  # 2 independent rows
        RC = R_ItoC @ R_all[p]
        row_f = Bx @ RC  # coeff of x_f
        row_v0 = -Bx @ RC @ A_all[p]
        row_g = -Bx @ RC @ B_all[p]
        rhs = -Bx @ (p_IinC - RC @ c_all[p])
        m = obs_mask[f, p]
        rows = jnp.zeros((2, n_unk), dtype)
        rows = rows.at[:, 0:3].set(row_v0)
        rows = rows.at[:, 3:6].set(row_g)
        rows = jax.lax.dynamic_update_slice(rows, row_f, (0, 6 + 3 * f))
        return rows * m, rhs * m

    ff, pp = jnp.meshgrid(jnp.arange(F), jnp.arange(P), indexing="ij")
    rows, rhs = jax.vmap(jax.vmap(obs_rows))(ff, pp)
    Amat = rows.reshape(-1, n_unk)
    bvec = rhs.reshape(-1)
    AtA = Amat.T @ Amat + 1e-10 * jnp.eye(n_unk, dtype=dtype)
    Atb = Amat.T @ bvec
    chol = jax.scipy.linalg.cho_factor(AtA, lower=True)
    x_lin = jax.scipy.linalg.cho_solve(chol, Atb)

    g_lin = x_lin[3:6]
    g_scale = opts.gravity_mag / jnp.maximum(jnp.linalg.norm(g_lin), 1e-3)
    params = {
        "v0": x_lin[0:3],
        "g": g_lin * g_scale,
        "bg": jnp.asarray(opts.init_bias_g, dtype),  # init_dyn_bias_g seed
        "ba": jnp.asarray(opts.init_bias_a, dtype),
        "feats": x_lin[6:].reshape(F, 3),
    }

    # ---- damped Gauss-Newton MLE ----
    x0 = _flatten(params)

    def res_fn(x):
        return _reproj_residuals(
            _unflatten(x, F), cpi_inputs, obs_uvn, obs_mask, R_ItoC, p_IinC, opts
        )

    def gn_body(_, carry):
        x, lam = carry
        r = res_fn(x)
        J = jax.jacfwd(res_fn)(x)
        H = J.T @ J
        H = H + lam * jnp.diag(jnp.diagonal(H) + 1e-6)
        cholH = jax.scipy.linalg.cho_factor(H, lower=True)
        dx = jax.scipy.linalg.cho_solve(cholH, J.T @ r)
        x_new = x - dx
        better = jnp.sum(res_fn(x_new) ** 2) < jnp.sum(r**2)
        x = jnp.where(better, x_new, x)
        lam = jnp.where(better, lam * 0.5, lam * 4.0)
        return x, lam

    x_opt, _ = jax.lax.fori_loop(0, opts.gn_iters, gn_body, (x0, jnp.asarray(1e-3, dtype)))
    p_opt = _unflatten(x_opt, F)

    # final diagnostics + covariance (Laplace at the optimum)
    r = res_fn(x_opt)
    J = jax.jacfwd(res_fn)(x_opt)
    H = J.T @ J + 1e-6 * jnp.eye(x_opt.shape[0], dtype=dtype)
    n_obs = jnp.sum(obs_mask)
    rmse = jnp.sqrt(jnp.sum(r[: -7] ** 2) * opts.sigma_pix_norm**2 / jnp.maximum(2 * n_obs, 1))
    # reciprocal condition number of the information over the IMU-state
    # block (v0,g,bg,ba) — the reference gates covariance recovery on
    # rcond (init_dyn_min_rec_cond, `DynamicInitializer.cpp:~960-1010`)
    eigs = jnp.linalg.eigvalsh(H[:12, :12])
    rcond = jnp.abs(eigs[0]) / jnp.maximum(jnp.abs(eigs[-1]), 1e-30)
    return {
        "params": p_opt,
        "hessian": H,
        "rmse_norm": rmse,
        "rcond": rcond,
        "n_obs": n_obs,
        "R_0P_all": None,
    }


def result_to_state_first(p_opt, opts):
    """Initial filter state at the FIRST pose time: gravity-aligned
    global frame with origin at p0 (the reference initializes at the
    oldest pose then fast-forwards, VioManagerHelper.cpp:111-166)."""
    g_I0 = np.asarray(p_opt["g"])
    q_GtoI0 = gravity_aligned_quat(g_I0)
    from ..math import quat_to_rot

    R_GtoI0 = np.asarray(quat_to_rot(jnp.asarray(q_GtoI0)))
    return {
        "q_GtoI": q_GtoI0,
        "p": np.zeros(3),
        "v": R_GtoI0.T @ np.asarray(p_opt["v0"]),
        "bg": np.asarray(p_opt["bg"]),
        "ba": np.asarray(p_opt["ba"]),
    }


def result_to_state(p_opt, imu_t, imu_w, imu_a, opts):
    """Map the solved window onto an initial filter state at the LAST
    pose time: gravity-aligned global frame anchored at p0 = 0."""
    cpis = jax.vmap(
        lambda t, w, a: preintegrate(t, w, a, p_opt["bg"], p_opt["ba"])
    )(imu_t, imu_w, imu_a)
    R0p, p0p, v0p = _shoot_poses(cpis, p_opt["v0"], p_opt["g"])
    g_I0 = p_opt["g"]
    q_GtoI0 = gravity_aligned_quat(np.asarray(g_I0))
    from ..math import quat_to_rot

    R_GtoI0 = np.asarray(quat_to_rot(jnp.asarray(q_GtoI0)))
    R_0P = np.asarray(R0p[-1])
    R_GtoIP = R_0P @ R_GtoI0
    p_P = R_GtoI0.T @ np.asarray(p0p[-1])
    v_P = R_GtoI0.T @ np.asarray(v0p[-1])
    q_P = np.asarray(rot_to_quat(jnp.asarray(R_GtoIP)))
    return {
        "time": float(imu_t[-1, -1]),
        "q_GtoI": q_P,
        "p": p_P,
        "v": v_P,
        "bg": np.asarray(p_opt["bg"]),
        "ba": np.asarray(p_opt["ba"]),
    }
