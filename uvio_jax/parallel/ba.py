"""Sharded bundle adjustment / pose-graph backend.

The north-star extension beyond reference parity (BASELINE.json): a
keyframe + landmark batch optimizer sharded across a device mesh.
Each device computes its shard's contribution to the Schur-reduced
camera system

    S  = H_pp - H_pl H_ll^-1 H_pl^T      (6N x 6N)
    b  = b_p  - H_pl H_ll^-1 b_l

which is all-reduced over the mesh, solved replicated (tiny: 6N for N
keyframes), and back-substituted into the local landmark shard — the
classic distributed-BA decomposition, with XLA collectives (NCCL
between GPUs) instead of MPI.

Two sharding modes, selected by the mesh's axis names:

- 1D landmark sharding (a single mesh axis, any name): landmark blocks
  split over devices, the camera system `psum`-all-reduced.
- 2D keyframe x landmark sharding (axes named "kf" and "lm"): the
  observation block structure (L, N) is tiled over the mesh — the
  keyframe/time axis is the "sequence axis" of this workload
  (SURVEY §2.6) — per-landmark Hessians `psum` over "kf", per-landmark
  pose-block Jacobians `all_gather` over "kf", and the reduced camera
  system `psum` over "lm".

Geometry conventions match the filter: keyframe pose = (q_GtoC JPL,
p_CinG) treated directly as the camera pose (IMU-camera extrinsics are
folded in by the caller); observations are normalized image coordinates
with masks; landmark parameterization is global 3D.

Gauge: the first keyframe is held fixed (its update rows/cols are
masked); Levenberg damping handles the remaining weak directions
(e.g. monocular scale when only one pose is fixed).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..math import quat_multiply, quat_norm, quat_to_rot, skew


@dataclasses.dataclass
class BAOptions:
    iters: int = 15
    damping_init: float = 1e-4
    huber_norm: float = 5e-3  # robust threshold in normalized units
    fix_poses: int = 1  # number of leading keyframes held fixed


def _residual_jacobians(q, p, lm):
    """Per-(landmark, keyframe) residual pieces.

    q (N,4) JPL q_GtoC, p (N,3) p_CinG, lm (L,3).
    Returns pred (L,N,2), Jp (L,N,2,6) wrt [theta, p] of the pose,
    Jl (L,N,2,3) wrt the landmark, depth z (L,N).
    """
    R = quat_to_rot(q)  # (N,3,3)
    d = lm[:, None, :] - p[None, :, :]  # (L,N,3)
    pc = jnp.einsum("nij,lnj->lni", R, d)  # p in camera frame
    z = pc[..., 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-3, 1e-3, z)
    pred = pc[..., :2] / safe_z[..., None]
    # d pred / d pc
    one = jnp.ones_like(safe_z)
    zero = jnp.zeros_like(safe_z)
    Hproj = jnp.stack(
        [
            jnp.stack([one / safe_z, zero, -pc[..., 0] / safe_z**2], axis=-1),
            jnp.stack([zero, one / safe_z, -pc[..., 1] / safe_z**2], axis=-1),
        ],
        axis=-2,
    )  # (L,N,2,3)
    # d pc/d theta = [pc]_x (JPL left error), d pc/d p = -R, d pc/d lm = R
    sk = skew(pc)  # (L,N,3,3)
    Jp_th = jnp.einsum("lnab,lnbe->lnae", Hproj, sk)
    Jp_p = -jnp.einsum("lnab,nbe->lnae", Hproj, R)
    Jl = jnp.einsum("lnab,nbe->lnae", Hproj, R)
    Jp = jnp.concatenate([Jp_th, Jp_p], axis=-1)  # (L,N,2,6)
    return pred, Jp, Jl, z


def _local_pieces(q, p, lm_shard, obs_shard, mask_shard, huber):
    """Raw Gauss-Newton pieces for one (landmark-shard x keyframe-shard)
    observation block. q/p may be a keyframe shard (Nk rows).

    Returns (A (Ls,3,3), b_l (Ls,3), Hpl (Ls,Nk,6,3), Hpp_diag (Nk,6,6),
    b_p (Nk,6), cost) — all *partial* sums over the local block.
    """
    pred, Jp, Jl, z = _residual_jacobians(q, p, lm_shard)
    r = (obs_shard - pred) * mask_shard[..., None]  # (Ls,Nk,2)
    # Huber weights (reference uses Cauchy loss in its ceres MLE;
    # Huber keeps the IRLS weights simple)
    rn = jnp.linalg.norm(r, axis=-1)
    w = jnp.where(rn > huber, huber / jnp.maximum(rn, 1e-12), 1.0)
    w = w * mask_shard * (z > 0.05)
    sw = jnp.sqrt(w)[..., None]
    r = r * sw
    Jp = Jp * sw[..., None]
    Jl = Jl * sw[..., None]

    A = jnp.einsum("lnai,lnaj->lij", Jl, Jl)  # (Ls,3,3)
    b_l = jnp.einsum("lnai,lna->li", Jl, r)  # (Ls,3)
    Hpl = jnp.einsum("lnai,lnaj->lnij", Jp, Jl)  # (Ls,Nk,6,3)
    Hpp_diag = jnp.einsum("lnai,lnaj->nij", Jp, Jp)  # (Nk,6,6)
    b_p = jnp.einsum("lnai,lna->ni", Jp, r)  # (Nk,6)
    cost = jnp.sum(r * r)
    return A, b_l, Hpl, Hpp_diag, b_p, cost


def _schur_combine(A, b_l, Hpl, Hpp_diag, b_p, cost):
    """Form the Schur-reduced camera system from (possibly collective-
    combined) full-keyframe pieces. Hpl (Ls,N,6,3), Hpp_diag (N,6,6)."""
    N = Hpp_diag.shape[0]
    A_reg = A + 1e-9 * jnp.eye(3, dtype=A.dtype)
    A_inv = _inv3(A_reg)
    # Schur: S -= B A^-1 B^T with B (6N,3) per landmark
    B = Hpl.reshape(Hpl.shape[0], N * 6, 3)
    BAinv = jnp.einsum("lpk,lkj->lpj", B, A_inv)  # (Ls,6N,3)
    S_red = jnp.einsum("lpk,lqk->pq", BAinv, B)  # (6N,6N)
    b_red = jnp.einsum("lpk,lk->p", BAinv, b_l)  # (6N,)

    S = jax.scipy.linalg.block_diag(*[Hpp_diag[i] for i in range(N)]) - S_red
    b = b_p.reshape(N * 6) - b_red
    return S, b, A_inv, B


def _schur_contrib(q, p, lm_shard, obs_shard, mask_shard, huber):
    """One landmark shard's Schur pieces (full keyframe axis).

    Returns (S (6N,6N), b (6N,), A_inv (Ls,3,3), B (Ls,6N,3),
    b_l (Ls,3), cost).
    """
    A, b_l, Hpl, Hpp_diag, b_p, cost = _local_pieces(
        q, p, lm_shard, obs_shard, mask_shard, huber
    )
    S, b, A_inv, B = _schur_combine(A, b_l, Hpl, Hpp_diag, b_p, cost)
    return S, b, A_inv, B, b_l, cost


def _inv3(A):
    """Batched closed-form 3x3 inverse (no LU call per landmark)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = -(d * i - f * g)
    co02 = d * h - e * g
    det = a * co00 + b * co01 + c * co02
    safe = jnp.where(jnp.abs(det) < 1e-18, 1.0, det)
    adj = jnp.stack(
        [
            jnp.stack([co00, -(b * i - c * h), b * f - c * e], -1),
            jnp.stack([co01, a * i - c * g, -(a * f - c * d)], -1),
            jnp.stack([co02, -(a * h - b * g), a * e - b * d], -1),
        ],
        -2,
    )
    return adj / safe[..., None, None]


def ba_solve(
    q0,
    p0,
    lm0,
    obs_uv,
    obs_mask,
    opts: BAOptions = BAOptions(),
    mesh=None,
    pose_valid=None,
):
    """Damped Gauss-Newton BA. obs_uv (L,N,2) normalized, obs_mask (L,N).

    With a 1-axis `mesh`, the landmark axis is sharded over that axis and
    the reduced camera system is psum-all-reduced. With a 2-axis mesh
    named ("kf", "lm"), the (L, N) observation block structure is tiled
    over the mesh: per-landmark Hessians are psum-reduced over "kf",
    pose-block Jacobians all-gathered over "kf", and the reduced camera
    system psum-reduced over "lm". Without a mesh: single-device,
    identical math.

    `pose_valid` (N,) bool marks live keyframe slots; invalid slots are
    held fixed (zero update, unit diagonal) so callers can pad the
    keyframe axis to a static size — landmark padding is already inert
    via all-zero `obs_mask` rows.
    Returns (q, p, lm, info).
    """
    N = q0.shape[0]
    dtype = p0.dtype
    fixmask = jnp.concatenate(
        [jnp.zeros(6 * opts.fix_poses, dtype), jnp.ones(6 * (N - opts.fix_poses), dtype)]
    )
    if pose_valid is not None:
        fixmask = fixmask * jnp.repeat(jnp.asarray(pose_valid, dtype), 6)

    def contrib(q, p, lm, uv, m):
        return _schur_contrib(q, p, lm, uv, m, opts.huber_norm)

    if mesh is not None and set(mesh.axis_names) >= {"kf", "lm"}:
        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        def sharded_contrib_2d(q, p, lm, uv, m):
            # q/p: local keyframe shard; lm/uv/m: local landmark shard
            # (uv/m also kf-sharded along axis 1)
            A, b_l, Hpl, Hpp_diag, b_p, cost = _local_pieces(
                q, p, lm, uv, m, opts.huber_norm
            )
            # per-landmark pieces: sum over the keyframe axis
            A = jax.lax.psum(A, "kf")
            b_l = jax.lax.psum(b_l, "kf")
            # pose-block pieces: concatenate the keyframe axis (tiled
            # all-gather; each kf row then holds full-N blocks)
            Hpl = jax.lax.all_gather(Hpl, "kf", axis=1, tiled=True)
            Hpp_diag = jax.lax.all_gather(Hpp_diag, "kf", axis=0, tiled=True)
            b_p = jax.lax.all_gather(b_p, "kf", axis=0, tiled=True)
            S, b, A_inv, B = _schur_combine(A, b_l, Hpl, Hpp_diag, b_p, cost)
            # reduced camera system: sum the landmark shards
            S = jax.lax.psum(S, "lm")
            b = jax.lax.psum(b, "lm")
            cost = jax.lax.psum(cost, ("kf", "lm"))
            return S, b, A_inv, B, b_l, cost

        contrib_fn = shard_map(
            sharded_contrib_2d,
            mesh=mesh,
            in_specs=(P("kf"), P("kf"), P("lm"), P("lm", "kf"), P("lm", "kf")),
            out_specs=(P(), P(), P("lm"), P("lm"), P("lm"), P()),
            check_vma=False,
        )
    elif mesh is not None:
        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        (ax,) = mesh.axis_names

        def sharded_contrib(q, p, lm, uv, m):
            S, b, A_inv, B, b_l, cost = contrib(q, p, lm, uv, m)
            S = jax.lax.psum(S, ax)
            b = jax.lax.psum(b, ax)
            cost = jax.lax.psum(cost, ax)
            return S, b, A_inv, B, b_l, cost

        contrib_fn = shard_map(
            sharded_contrib,
            mesh=mesh,
            in_specs=(P(), P(), P(ax), P(ax), P(ax)),
            out_specs=(P(), P(), P(ax), P(ax), P(ax), P()),
        )
    else:
        contrib_fn = contrib

    def step(carry, _):
        q, p, lm, lam = carry
        S, b, A_inv, B, b_l, cost = contrib_fn(q, p, lm, obs_uv, obs_mask)
        # gauge fixing + damping
        S = S * fixmask[:, None] * fixmask[None, :]
        S = S + jnp.diag((1.0 - fixmask) + lam * (jnp.diagonal(S) + 1e-6))
        b = b * fixmask
        chol = jax.scipy.linalg.cho_factor(S, lower=True)
        dx_p = jax.scipy.linalg.cho_solve(chol, b)  # (6N,)
        # landmark back-substitution: dx_l = A^-1 (b_l - B^T dx_p)
        dx_l = jnp.einsum("lij,lj->li", A_inv, b_l - jnp.einsum("lpk,p->lk", B, dx_p))

        dxp = dx_p.reshape(N, 6)
        dq = quat_norm(
            jnp.concatenate([0.5 * dxp[:, :3], jnp.ones((N, 1), dtype)], axis=1)
        )
        q_new = quat_multiply(dq, q)
        p_new = p + dxp[:, 3:]
        lm_new = lm + dx_l

        # accept-if-better (cost from NEXT linearization cheaply approximated
        # by monotone damping): evaluate new cost
        _, _, _, _, _, new_cost = contrib_fn(q_new, p_new, lm_new, obs_uv, obs_mask)
        better = new_cost < cost
        q = jnp.where(better, q_new, q)
        p = jnp.where(better, p_new, p)
        lm = jnp.where(better, lm_new, lm)
        lam = jnp.where(better, lam * 0.5, lam * 4.0)
        return (q, p, lm, lam), cost

    (q, p, lm, _), costs = jax.lax.scan(
        step, (q0, p0, lm0, jnp.asarray(opts.damping_init, dtype)), None, length=opts.iters
    )
    return q, p, lm, {"costs": costs}
