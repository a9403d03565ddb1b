"""Synthetic bundle-adjustment problem: a ring of keyframes around a
landmark cloud (a decimated loop map), for the map backend's dry runs
and smoke checks."""

from __future__ import annotations

import numpy as np


def ring_map(n_kf: int, n_lm: int, seed: int = 0):
    """Keyframes on a loop of radius 3 m looking at the centre, landmarks
    uniform in a 3 m cube, 1e-3 normalized-unit observation noise and
    5 cm landmark perturbation as the initial guess.

    Returns (q (N,4) JPL q_GtoC, p (N,3), lm0 (L,3), obs (L,N,2),
    mask (L,N)) as float64 numpy arrays (mask bool), ready for
    `parallel.ba.ba_solve`.
    """
    import jax
    import jax.numpy as jnp

    from ..math import rot_to_quat

    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n_kf, endpoint=False)
    ps = np.stack([3 * np.cos(th), 3 * np.sin(th), 0.1 * np.sin(2 * th)], 1)
    lms = rng.uniform(-1.5, 1.5, (n_lm, 3))
    z = -ps / np.linalg.norm(ps, axis=1, keepdims=True)
    x = np.cross([0, 0, 1.0], z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    Rs = np.stack([x, y, z], axis=1)  # (N,3,3) rows x, y, z: R_GtoC
    qs = np.asarray(jax.vmap(rot_to_quat)(jnp.asarray(Rs)))
    pc = np.einsum("nij,lnj->lni", Rs, lms[:, None, :] - ps[None, :, :])
    mask = pc[..., 2] > 0.5
    obs = (
        pc[..., :2] / np.where(np.abs(pc[..., 2:]) < 1e-3, 1e-3, pc[..., 2:])
        + 1e-3 * rng.standard_normal(pc[..., :2].shape)
    )
    lm0 = lms + 0.05 * rng.standard_normal((n_lm, 3))
    return qs, ps, lm0, obs, mask
