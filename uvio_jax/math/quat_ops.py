"""JPL quaternion / SO(3) / SE(3) math core.

Conventions follow Trawny & Roumeliotis, "Indirect Kalman Filter for 3D
Attitude Estimation" (TR-2005-002), as used by the reference
(`ov_core/src/utils/quat_ops.h`):

  * quaternions are JPL, stored `[x, y, z, w]` with `w >= 0` enforced;
  * `q_GtoI` maps global to local: `R(q_GtoI) @ v_G = v_I`;
  * `R(q) = (2 w^2 - 1) I - 2 w [qv]_x + 2 qv qv^T`;
  * `quat_multiply(q, p) = L(q) p`, `L(q) = [[w I - [qv]_x, qv], [-qv^T, w]]`.

Everything here is written against `jnp` on the *last* axes so the ops
batch transparently under `vmap`/leading batch dimensions, and every
branch is a `jnp.where` with safe denominators so the functions are
jit- and grad-safe at the identity.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12


def skew(v):
    """[v]_x such that [v]_x @ u = v x u. Batched over leading dims."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def quat_norm(q):
    """Normalize and enforce the JPL w>=0 sign convention."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    return jnp.where(q[..., 3:4] < 0, -q, q)


def quat_multiply(q, p):
    """JPL product q ⊗ p (rotation composition: R(q⊗p) = R(q) R(p))."""
    qv, qw = q[..., :3], q[..., 3:4]
    pv, pw = p[..., :3], p[..., 3:4]
    cross = jnp.cross(qv, pv)
    vec = qw * pv + pw * qv - cross
    w = qw[..., 0] * pw[..., 0] - jnp.sum(qv * pv, axis=-1)
    out = jnp.concatenate([vec, w[..., None]], axis=-1)
    return quat_norm(out)


def quat_inv(q):
    """Inverse (conjugate for unit quaternions): [-qv, w]."""
    return jnp.concatenate([-q[..., :3], q[..., 3:4]], axis=-1)


def quat_to_rot(q):
    """JPL quaternion -> SO(3): R = (2w^2-1) I - 2w [qv]_x + 2 qv qv^T."""
    qv, w = q[..., :3], q[..., 3]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=q.dtype), q.shape[:-1] + (3, 3))
    outer = qv[..., :, None] * qv[..., None, :]
    return (
        (2.0 * w**2 - 1.0)[..., None, None] * eye
        - 2.0 * w[..., None, None] * skew(qv)
        + 2.0 * outer
    )


def rot_to_quat(R):
    """SO(3) -> JPL quaternion, branchless largest-pivot selection.

    Mirrors the 4-branch pivoting of the reference's `rot_2_quat`
    (`ov_core/src/utils/quat_ops.h:88-127`) but computes all four
    candidates and selects by maximum pivot so it vectorizes.
    """
    T = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    r00, r11, r22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, _EPS))

    # candidate 0: pivot q_x
    q0x = safe_sqrt((1.0 + 2.0 * r00 - T) / 4.0)
    c0 = jnp.stack(
        [
            q0x,
            (R[..., 0, 1] + R[..., 1, 0]) / (4.0 * q0x),
            (R[..., 0, 2] + R[..., 2, 0]) / (4.0 * q0x),
            (R[..., 1, 2] - R[..., 2, 1]) / (4.0 * q0x),
        ],
        axis=-1,
    )
    # candidate 1: pivot q_y
    q1y = safe_sqrt((1.0 + 2.0 * r11 - T) / 4.0)
    c1 = jnp.stack(
        [
            (R[..., 0, 1] + R[..., 1, 0]) / (4.0 * q1y),
            q1y,
            (R[..., 1, 2] + R[..., 2, 1]) / (4.0 * q1y),
            (R[..., 2, 0] - R[..., 0, 2]) / (4.0 * q1y),
        ],
        axis=-1,
    )
    # candidate 2: pivot q_z
    q2z = safe_sqrt((1.0 + 2.0 * r22 - T) / 4.0)
    c2 = jnp.stack(
        [
            (R[..., 0, 2] + R[..., 2, 0]) / (4.0 * q2z),
            (R[..., 1, 2] + R[..., 2, 1]) / (4.0 * q2z),
            q2z,
            (R[..., 0, 1] - R[..., 1, 0]) / (4.0 * q2z),
        ],
        axis=-1,
    )
    # candidate 3: pivot w
    q3w = safe_sqrt((1.0 + T) / 4.0)
    c3 = jnp.stack(
        [
            (R[..., 1, 2] - R[..., 2, 1]) / (4.0 * q3w),
            (R[..., 2, 0] - R[..., 0, 2]) / (4.0 * q3w),
            (R[..., 0, 1] - R[..., 1, 0]) / (4.0 * q3w),
            q3w,
        ],
        axis=-1,
    )
    pivots = jnp.stack([r00, r11, r22, T], axis=-1)
    best = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([c0, c1, c2, c3], axis=-2)  # (..., 4, 4)
    q = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    return quat_norm(q)


def _sinc_ratios_sq(t2):
    """(sin θ/θ, (1-cos θ)/θ², (θ - sin θ)/θ³) from θ² with Taylor guards.

    Autodiff-safe at θ=0: the Taylor branch is a polynomial in θ² (no
    sqrt), and the exact branch's sqrt argument is clamped away from 0,
    so neither branch produces NaN primals *or tangents* (the classic
    `jnp.where` + `norm(0)` gradient trap).
    """
    # wide Taylor region (theta < 1e-3): the exact branch's SECOND
    # derivatives carry 1/t2^(3/2) factors that overflow to NaN near the
    # switch under emulated f64 (observed at t2 ~ 1e-11 inside
    # jacfwd(jacfwd(exp_se3))); the two extra Taylor terms keep the
    # polynomial branch accurate to ~1e-22 at the boundary.
    small = t2 < 1e-6
    t2s = jnp.where(small, t2, 0.0)  # guards higher-order term overflow
    safe = jnp.sqrt(jnp.where(small, 1.0, t2))
    a = jnp.where(small, 1.0 - t2s / 6.0 + t2s * t2s / 120.0, jnp.sin(safe) / safe)
    b = jnp.where(
        small,
        0.5 - t2s / 24.0 + t2s * t2s / 720.0,
        (1.0 - jnp.cos(safe)) / jnp.where(small, 1.0, t2),
    )
    c = jnp.where(
        small,
        1.0 / 6.0 - t2s / 120.0 + t2s * t2s / 5040.0,
        (safe - jnp.sin(safe)) / jnp.where(small, 1.0, t2 * safe),
    )
    return a, b, c


def exp_so3(w):
    """SO(3) exponential map: axis-angle (3,) -> rotation matrix (3,3)."""
    t2 = jnp.sum(w * w, axis=-1)
    a, b, _ = _sinc_ratios_sq(t2)
    W = skew(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log_so3(R):
    """SO(3) logarithm: rotation matrix -> axis-angle vector.

    Behavior mirrors the reference `log_so3` (`quat_ops.h`): clamped
    acos of (tr-1)/2, vee of the skew part scaled by θ/(2 sin θ).
    """
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    vee = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_t = jnp.sin(theta)
    small = jnp.abs(sin_t) < 1e-7
    near_pi = jnp.logical_and(small, cos_t < 0.0)
    scale = jnp.where(small, 0.5, theta / jnp.where(small, 1.0, 2.0 * sin_t))
    w_generic = scale[..., None] * vee
    # θ ≈ π: vee ≈ 0; recover axis from diagonal of (R + I)/2 = aa^T
    diag = jnp.stack(
        [R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1
    )
    axis2 = jnp.maximum((diag + 1.0) / 2.0, 0.0)
    axis = jnp.sqrt(axis2)
    # fix signs using off-diagonal sums: sign(a_i a_j) = sign(R_ij + R_ji)
    sx = jnp.ones_like(axis[..., 0])
    sy = jnp.sign(R[..., 0, 1] + R[..., 1, 0] + _EPS)
    sz = jnp.sign(R[..., 0, 2] + R[..., 2, 0] + _EPS)
    axis = axis * jnp.stack([sx, sy, sz], axis=-1)
    nrm = jnp.linalg.norm(axis, axis=-1, keepdims=True)
    axis = axis / jnp.where(nrm < _EPS, 1.0, nrm)
    w_pi = theta[..., None] * axis
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def quat_to_axis_angle(q):
    """JPL quaternion -> rotation vector of R(q)."""
    return log_so3(quat_to_rot(q))


def axis_angle_to_quat(w):
    """Rotation vector -> JPL quaternion with R(q) = exp_so3(w)."""
    return rot_to_quat(exp_so3(w))


def jl_so3(w):
    """Left Jacobian of SO(3): Jl(w) = I + (1-cosθ)/θ² W + (θ-sinθ)/θ³ W²...

    Using the series Jl = Σ W^n/(n+1)! = I + b W + c W² with
    b=(1-cosθ)/θ², c=(θ-sinθ)/θ³ (reference `Jl_so3`, quat_ops.h).
    """
    t2 = jnp.sum(w * w, axis=-1)
    _, b, c = _sinc_ratios_sq(t2)
    W = skew(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * (W @ W)


def jr_so3(w):
    """Right Jacobian: Jr(w) = Jl(-w)."""
    return jl_so3(-w)


def jl_so3_inv(w):
    """Inverse left Jacobian (closed form with cot guard)."""
    t2 = jnp.sum(w * w, axis=-1)
    small = t2 < 1e-12
    safe = jnp.sqrt(jnp.where(small, 1.0, t2))
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + t2 / 720.0,
        1.0 / jnp.where(small, 1.0, t2)
        - (1.0 + jnp.cos(safe)) / (2.0 * safe * jnp.sin(safe)),
    )
    W = skew(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + cot_term[..., None, None] * (W @ W)


def omega(w):
    """Ω(ω) = [[-[ω]_x, ω], [-ω^T, 0]] for JPL q̇ = ½ Ω(ω) q."""
    batch = w.shape[:-1]
    out = jnp.zeros(batch + (4, 4), dtype=w.dtype)
    out = out.at[..., :3, :3].set(-skew(w))
    out = out.at[..., :3, 3].set(w)
    out = out.at[..., 3, :3].set(-w)
    return out


def exp_se3(xi):
    """SE(3) exponential: twist [ω, v] (6,) -> 4x4 homogeneous matrix.

    Matches the reference `exp_se3` (`quat_ops.h`): T = [[exp(ω), Jl(ω) v],
    [0, 1]].
    """
    w, v = xi[..., :3], xi[..., 3:]
    R = exp_so3(w)
    p = (jl_so3(w) @ v[..., None])[..., 0]
    batch = xi.shape[:-1]
    T = jnp.zeros(batch + (4, 4), dtype=xi.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(p)
    T = T.at[..., 3, 3].set(1.0)
    return T


def log_se3(T):
    """SE(3) logarithm: 4x4 -> twist [ω, v]."""
    R = T[..., :3, :3]
    p = T[..., :3, 3]
    w = log_so3(R)
    v = (jl_so3_inv(w) @ p[..., None])[..., 0]
    return jnp.concatenate([w, v], axis=-1)


def hat_se3(xi):
    """se(3) hat: [ω, v] -> 4x4 [[ [ω]_x, v], [0, 0]]."""
    batch = xi.shape[:-1]
    out = jnp.zeros(batch + (4, 4), dtype=xi.dtype)
    out = out.at[..., :3, :3].set(skew(xi[..., :3]))
    out = out.at[..., :3, 3].set(xi[..., 3:])
    return out


def inv_se3(T):
    """Inverse of a homogeneous transform."""
    R = T[..., :3, :3]
    p = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    out = jnp.zeros_like(T)
    out = out.at[..., :3, :3].set(Rt)
    out = out.at[..., :3, 3].set(-(Rt @ p[..., None])[..., 0])
    out = out.at[..., 3, 3].set(1.0)
    return out


def rot_to_rpy(R):
    """Rotation matrix -> roll/pitch/yaw (x-y-z convention, ref `rot2rpy`)."""
    yaw = jnp.arctan2(R[..., 0, 1], R[..., 0, 0])
    c = jnp.sqrt(R[..., 0, 0] ** 2 + R[..., 0, 1] ** 2)
    pitch = jnp.arctan2(-R[..., 0, 2], c)
    roll = jnp.arctan2(R[..., 1, 2], R[..., 2, 2])
    return jnp.stack([roll, pitch, yaw], axis=-1)


def rpy_to_rot(rpy):
    """roll/pitch/yaw -> rotation matrix R = Rz(yaw) ... matching rot2rpy.

    Inverse of `rot_to_rpy`: R = Rx(roll)ᵀ? — we use the same convention
    as the reference (`rot_x/rot_y/rot_z` composition R = Rz·Ry·Rx ...).
    Defined such that rot_to_rpy(rpy_to_rot(v)) == v.
    """
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    zero = jnp.zeros_like(r)
    one = jnp.ones_like(r)
    Rx = jnp.stack(
        [
            jnp.stack([one, zero, zero], -1),
            jnp.stack([zero, cr, sr], -1),
            jnp.stack([zero, -sr, cr], -1),
        ],
        -2,
    )
    Ry = jnp.stack(
        [
            jnp.stack([cp, zero, -sp], -1),
            jnp.stack([zero, one, zero], -1),
            jnp.stack([sp, zero, cp], -1),
        ],
        -2,
    )
    Rz = jnp.stack(
        [
            jnp.stack([cy, sy, zero], -1),
            jnp.stack([-sy, cy, zero], -1),
            jnp.stack([zero, zero, one], -1),
        ],
        -2,
    )
    return Rx @ Ry @ Rz
