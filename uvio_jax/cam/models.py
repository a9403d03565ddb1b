"""Camera projection/distortion models.

JAX equivalent of the reference camera layer
(`ov_core/src/cam/CamBase.h`, `CamRadtan.h`, `CamEqui.h`): pinhole
projection with either radial-tangential ("radtan") or equidistant
fisheye ("equi") distortion.

Intrinsics are a flat `(8,)` vector `[fx, fy, cx, cy, d0, d1, d2, d3]`
(radtan: k1 k2 p1 p2; equi: k1 k2 k3 k4) exactly as the reference packs
its `Vec(8)` calib state. All functions are batched over leading dims
and differentiable; undistortion is a fixed-iteration solver (jit-safe,
replaces cv::undistortPoints).

Model selection is *static* (Python ints) so each camera's pipeline
compiles to straight-line code.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

RADTAN = 0
EQUI = 1

_UNDISTORT_ITERS = 20


def _distort_radtan_norm(d, xy):
    """Normalized-plane radtan warp (before K). d = [k1, k2, p1, p2]."""
    k1, k2, p1, p2 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def _distort_equi_norm(d, xy):
    """Normalized-plane equidistant warp. d = [k1, k2, k3, k4]."""
    k1, k2, k3, k4 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    x, y = xy[..., 0], xy[..., 1]
    r = jnp.sqrt(x * x + y * y)
    safe_r = jnp.where(r < 1e-12, 1.0, r)
    theta = jnp.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = jnp.where(r < 1e-12, 1.0, theta_d / safe_r)
    return xy * scale[..., None]


def distort(params, model, uv_norm):
    """Normalized coords (...,2) -> raw pixel coords (...,2).

    Mirrors `CamRadtan::distort_f` / `CamEqui::distort_f`.
    """
    fxy = params[..., 0:2]
    cxy = params[..., 2:4]
    d = params[..., 4:8]
    if model == RADTAN:
        warped = _distort_radtan_norm(d, uv_norm)
    elif model == EQUI:
        warped = _distort_equi_norm(d, uv_norm)
    else:
        raise ValueError(f"unknown camera model {model}")
    return warped * fxy + cxy


def undistort(params, model, uv):
    """Raw pixel coords (...,2) -> normalized coords (...,2).

    Fixed-point/Newton iterations replacing the reference's OpenCV
    `undistortPoints` call (`CamRadtan.h:60-76`, `CamEqui.h:62-79`).
    """
    fxy = params[..., 0:2]
    cxy = params[..., 2:4]
    d = params[..., 4:8]
    pt = (uv - cxy) / fxy
    if model == RADTAN:
        def body(_, xy):
            k1, k2, p1, p2 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
            x, y = xy[..., 0], xy[..., 1]
            r2 = x * x + y * y
            radial = 1.0 + k1 * r2 + k2 * r2 * r2
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            tang = jnp.stack([dx, dy], axis=-1)
            return (pt - tang) / radial[..., None]

        return jax.lax.fori_loop(0, _UNDISTORT_ITERS, body, pt)
    elif model == EQUI:
        k1, k2, k3, k4 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
        theta_d = jnp.linalg.norm(pt, axis=-1)

        def body(_, theta):
            t2 = theta * theta
            f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - theta_d
            fp = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3 + t2 * 9.0 * k4)))
            return theta - f / fp

        theta = jax.lax.fori_loop(0, _UNDISTORT_ITERS, body, theta_d)
        safe = jnp.where(theta_d < 1e-12, 1.0, theta_d)
        scale = jnp.where(theta_d < 1e-12, 1.0, jnp.tan(theta) / safe)
        return pt * scale[..., None]
    raise ValueError(f"unknown camera model {model}")


def distort_jacobian(params, model, uv_norm):
    """(d uv / d uv_norm (...,2,2), d uv / d intrinsics (...,2,8)).

    Equivalent of `compute_distort_jacobian` (`CamRadtan.h:84-130`,
    `CamEqui.h:87-158`) — here derived by autodiff of `distort`, which
    keeps the Jacobians exactly consistent with the forward model for
    any distortion (the property the hand-derived reference versions
    must maintain by hand).
    """

    def f_norm(xy, p):
        return distort(p, model, xy)

    J_norm = _batched_jac(lambda xy: f_norm(xy, params), uv_norm, 2)
    J_calib = _batched_jac(lambda p: f_norm(uv_norm, p), params, 2, wrt_shape=(8,))
    return J_norm, J_calib


def _batched_jac(f, x, out_dim, wrt_shape=None):
    """jacfwd batched over x's leading dims (wrt last-axis vector)."""
    if wrt_shape is None:
        wrt_shape = x.shape[-1:]
    flat_batch = x.shape[:-1] if x.ndim > 1 else ()

    jac = jax.jacfwd(f)
    for _ in flat_batch:
        jac = jax.vmap(jac)
    return jac(x)


def project(params, model, p_cam):
    """3D point in camera frame (...,3) -> raw pixel coords (...,2).

    Perspective division then distortion (`CamBase` project + distort).
    """
    z = p_cam[..., 2:3]
    uv_norm = p_cam[..., 0:2] / z
    return distort(params, model, uv_norm)
