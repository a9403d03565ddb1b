"""Batched feature triangulation + Gauss-Newton refinement.

JAX equivalent of `ov_core/src/feat/FeatureInitializer.{h,cpp}`:

  * `single_triangulation` (linear A p = b accumulation of skew-bearing
    outer products with condition-number and depth gating,
    `FeatureInitializer.cpp:30-112`) -> `triangulate_linear`, vmapped
    over a padded feature batch;
  * `single_gaussnewton` (inverse-depth GN refine with fixed iteration
    count replacing the convergence loop) -> `refine_gauss_newton`.

All observations arrive as *normalized* image coordinates with masks;
camera clone poses are (R_GtoC (K*C,3,3), p_CinG (K*C,3)) flattened
over (clone slot, camera).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..math import skew

_GN_ITERS = 5


def _eigvals_sym3(A):
    """Ascending eigenvalues of a symmetric 3x3 (closed-form trig
    method; no iterative eig solver for a 3x3)."""
    q = (A[0, 0] + A[1, 1] + A[2, 2]) / 3.0
    B = A - q * jnp.eye(3, dtype=A.dtype)
    p2 = jnp.sum(B * B) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    detB = (
        B[0, 0] * (B[1, 1] * B[2, 2] - B[1, 2] * B[2, 1])
        - B[0, 1] * (B[1, 0] * B[2, 2] - B[1, 2] * B[2, 0])
        + B[0, 2] * (B[1, 0] * B[2, 1] - B[1, 1] * B[2, 0])
    )
    r = jnp.clip(detB / (2.0 * p**3), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e1 = q + 2.0 * p * jnp.cos(phi)
    e3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    return jnp.stack([e3, e2, e1])


def triangulate_linear(uvn, mask, R_GtoC, p_CinG, min_depth=0.1, max_depth=60.0, max_cond=10000.0):
    """Linear triangulation of one feature in the global frame.

    uvn (M,2) normalized obs, mask (M,), R_GtoC (M,3,3), p_CinG (M,3).
    Returns (p_FinG (3,), ok). The anchor frame of the reference version
    is immaterial to the LS solution; depth gating is evaluated in each
    observing camera like the reference's anchor-frame check.
    """
    ones = jnp.ones(uvn.shape[:-1] + (1,), uvn.dtype)
    b_C = jnp.concatenate([uvn, ones], axis=-1)
    b_G = jnp.einsum("mij,mj->mi", jnp.swapaxes(R_GtoC, -1, -2), b_C)
    b_G = b_G / jnp.linalg.norm(b_G, axis=-1, keepdims=True)
    N = skew(b_G)  # (M,3,3)
    NtN = jnp.einsum("mji,mjk->mik", N, N)  # skew^T skew
    w = mask[:, None, None].astype(uvn.dtype)
    A = jnp.sum(w * NtN, axis=0)
    bvec = jnp.einsum("mik,mk->mi", NtN, p_CinG)
    bsum = jnp.sum(mask[:, None] * bvec, axis=0)
    # solve with safeguard. A is SPD (sum of skew^T skew + reg), so use
    # Cholesky and closed-form symmetric-3x3 eigenvalues (better
    # conditioned than a general LU/eig at this size).
    evals = _eigvals_sym3(A)
    cond = evals[-1] / jnp.maximum(evals[0], 1e-18)
    A_safe = A + 1e-12 * jnp.eye(3, dtype=A.dtype)
    chol = jax.scipy.linalg.cho_factor(A_safe, lower=True)
    p = jax.scipy.linalg.cho_solve(chol, bsum)
    # depth in each observing camera
    p_inC = jnp.einsum("mij,mj->mi", R_GtoC, p - p_CinG)
    z = p_inC[:, 2]
    depth_ok = jnp.all(jnp.where(mask, (z > min_depth) & (z < max_depth), True))
    nobs = jnp.sum(mask)
    ok = (cond < max_cond) & depth_ok & (nobs >= 2) & jnp.all(jnp.isfinite(p))
    return jnp.where(ok, p, jnp.zeros(3, p.dtype)), ok


def triangulate_1d(uvn, mask, R_GtoC, p_CinG, min_depth=0.1, max_depth=60.0):
    """Depth-only (1D) triangulation along the anchor bearing.

    Mirrors `single_triangulation_1d` (`FeatureInitializer.cpp:114-195`):
    anchor = the newest valid observation; every other observation's
    bearing, rotated into the anchor frame, contributes a scalar
    least-squares row  ||skew(b_i) (d * b_A - p_CiinA)||^2  solved in
    closed form for the depth d. Returns (p_FinG (3,), ok).

    uvn (M,2) normalized obs, mask (M,), R_GtoC (M,3,3), p_CinG (M,3).
    """
    M = uvn.shape[0]
    # anchor = last valid observation (the reference uses the newest
    # timestamp of the most-observed camera; slots are time-ordered)
    rev = jnp.argmax(mask[::-1])
    a_idx = M - 1 - rev
    R_GtoA = R_GtoC[a_idx]
    p_AinG = p_CinG[a_idx]
    ones = jnp.ones(uvn.shape[:-1] + (1,), uvn.dtype)
    b_C = jnp.concatenate([uvn, ones], axis=-1)
    b_A_anchor = b_C[a_idx] / jnp.linalg.norm(b_C[a_idx])

    # all bearings into the anchor frame: b_i^A = R_AtoCi^T b_i
    R_AtoC = jnp.einsum("mij,kj->mik", R_GtoC, R_GtoA)
    b_inA = jnp.einsum("mji,mj->mi", R_AtoC, b_C)
    b_inA = b_inA / jnp.maximum(jnp.linalg.norm(b_inA, axis=-1, keepdims=True), 1e-12)
    p_CinA = jnp.einsum("ij,mj->mi", R_GtoA, p_CinG - p_AinG[None])

    Bperp = skew(b_inA)  # (M,3,3)
    Ba = jnp.einsum("mij,j->mi", Bperp, b_A_anchor)  # (M,3)
    use = mask & (jnp.arange(M) != a_idx)
    w = use.astype(uvn.dtype)
    A = jnp.sum(w * jnp.sum(Ba * Ba, axis=-1))
    b = jnp.sum(w * jnp.sum(Ba * jnp.einsum("mij,mj->mi", Bperp, p_CinA), axis=-1))
    depth = b / jnp.where(jnp.abs(A) < 1e-12, 1.0, A)
    p_inA = depth * b_A_anchor
    ok = (
        (p_inA[2] > min_depth)
        & (p_inA[2] < max_depth)
        & (jnp.sum(use) >= 1)
        & jnp.all(jnp.isfinite(p_inA))
    )
    p_G = R_GtoA.T @ p_inA + p_AinG
    return jnp.where(ok, p_G, jnp.zeros(3, p_G.dtype)), ok


def refine_gauss_newton(p0, uvn, mask, R_GtoC, p_CinG, max_baseline=40.0):
    """Fixed-iteration GN refinement over inverse-depth coords (alpha,
    beta, rho) in the first valid camera's (anchor) frame.

    Mirrors `single_gaussnewton` (`FeatureInitializer.cpp:197-375`) with
    a static iteration count and masked residuals instead of early exit,
    including the final acceptance gates: depth bounds and the
    depth/baseline ratio (`p_FinA.norm()/base_line_max > max_baseline`
    rejects weak-parallax geometry, FeatureInitializer.cpp:363-371).
    Returns (p_refined (3,), ok).
    """
    # anchor = first valid observation
    idx = jnp.argmax(mask)
    R_GtoA = R_GtoC[idx]
    p_AinG = p_CinG[idx]
    p_inA = R_GtoA @ (p0 - p_AinG)
    z = jnp.where(jnp.abs(p_inA[2]) < 1e-6, 1e-6, p_inA[2])
    x = jnp.stack([p_inA[0] / z, p_inA[1] / z, 1.0 / z])  # alpha beta rho

    # per-obs anchor->camera transforms
    R_AtoC = jnp.einsum("mij,kj->mik", R_GtoC, R_GtoA)  # R_GtoC @ R_GtoA^T
    p_AinC = jnp.einsum("mij,mj->mi", R_GtoC, p_AinG[None] - p_CinG)

    def residuals(x):
        alpha, beta, rho = x[0], x[1], x[2]
        h = jnp.einsum("mij,j->mi", R_AtoC, jnp.stack([alpha, beta, jnp.ones_like(alpha)])) + rho * p_AinC
        hz = jnp.where(jnp.abs(h[:, 2]) < 1e-9, 1e-9, h[:, 2])
        pred = h[:, :2] / hz[:, None]
        r = (pred - uvn) * mask[:, None]
        return r.reshape(-1)

    def body(_, x):
        r = residuals(x)
        J = jax.jacfwd(residuals)(x)
        JtJ = J.T @ J + 1e-9 * jnp.eye(3, dtype=x.dtype)
        chol = jax.scipy.linalg.cho_factor(JtJ, lower=True)
        dx = jax.scipy.linalg.cho_solve(chol, J.T @ r)
        return x - dx

    # static unroll: 5 tiny GN steps fuse into one kernel (a fori_loop
    # would lower to a sequential while-op per feature)
    for i in range(_GN_ITERS):
        x = body(i, x)
    alpha, beta, rho = x[0], x[1], x[2]
    ok = rho > 1e-4
    safe_rho = jnp.where(ok, rho, 1.0)
    p_inA_new = jnp.stack([alpha / safe_rho, beta / safe_rho, 1.0 / safe_rho])
    # baseline gate: max component of camera positions (anchor frame)
    # orthogonal to the feature direction, vs. feature distance
    dirn = p_inA_new / jnp.maximum(jnp.linalg.norm(p_inA_new), 1e-9)
    p_CinA = jnp.einsum("ij,mj->mi", R_GtoA, p_CinG - p_AinG[None])
    orth = p_CinA - jnp.outer(p_CinA @ dirn, dirn)
    base = jnp.where(mask, jnp.linalg.norm(orth, axis=-1), 0.0)
    base_max = jnp.max(base)
    ratio_ok = jnp.linalg.norm(p_inA_new) < max_baseline * jnp.maximum(base_max, 1e-12)
    ok = ok & ratio_ok & jnp.all(jnp.isfinite(p_inA_new))
    p_new = R_GtoA.T @ p_inA_new + p_AinG
    return jnp.where(ok, p_new, p0), ok


def triangulate_batch(uvn, mask, R_GtoC, p_CinG, refine=True, max_baseline=40.0, use_1d=False):
    """vmapped triangulate + refine over a feature batch.

    uvn (F,M,2), mask (F,M), R_GtoC (F,M,3,3) or (M,3,3) shared,
    p_CinG likewise. `use_1d` selects the depth-only anchor-ray solve
    (the reference's `triangulate_1d` option). Returns
    (p_FinG (F,3), ok (F,)).
    """
    if R_GtoC.ndim == 3:
        R_GtoC = jnp.broadcast_to(R_GtoC[None], (uvn.shape[0],) + R_GtoC.shape)
        p_CinG = jnp.broadcast_to(p_CinG[None], (uvn.shape[0],) + p_CinG.shape)

    def one(uvn_f, mask_f, R_f, p_f):
        if use_1d:
            p_lin, ok_lin = triangulate_1d(uvn_f, mask_f, R_f, p_f)
        else:
            p_lin, ok_lin = triangulate_linear(uvn_f, mask_f, R_f, p_f)
        if refine:
            p_ref, ok_ref = refine_gauss_newton(
                p_lin, uvn_f, mask_f, R_f, p_f, max_baseline=max_baseline
            )
        else:
            p_ref, ok_ref = p_lin, jnp.asarray(True)
        return jnp.where(ok_lin, p_ref, p_lin), ok_lin & ok_ref

    return jax.vmap(one)(uvn, mask, R_GtoC, p_CinG)
