"""Triangulation tests against synthetic geometry."""

import jax.numpy as jnp
import numpy as np
from scipy.spatial.transform import Rotation as Rsp

from uvio_jax.update import refine_gauss_newton, triangulate_batch, triangulate_linear

RNG = np.random.default_rng(5)


def make_scene(n_obs=6, noise=0.0):
    p_true = np.array([1.0, -0.5, 4.0])
    R_GtoC = Rsp.random(n_obs, random_state=np.random.RandomState(2)).as_matrix() * 0
    # cameras looking roughly +z at the point from distinct positions
    R_list, p_list, uv_list = [], [], []
    for i in range(n_obs):
        p_C = np.array([0.6 * i - 1.5, 0.3 * (i % 3) - 0.3, 0.0])
        # build R_GtoC that looks from p_C toward p_true
        zax = p_true - p_C
        zax = zax / np.linalg.norm(zax)
        xax = np.cross([0, 1, 0], zax)
        xax /= np.linalg.norm(xax)
        yax = np.cross(zax, xax)
        R = np.stack([xax, yax, zax], axis=0)  # rows = camera axes in G
        R_list.append(R)
        p_list.append(p_C)
        pc = R @ (p_true - p_C)
        uv = pc[:2] / pc[2] + noise * RNG.standard_normal(2)
        uv_list.append(uv)
    return (
        p_true,
        jnp.asarray(np.stack(uv_list)),
        jnp.asarray(np.stack(R_list)),
        jnp.asarray(np.stack(p_list)),
    )


def test_triangulate_exact():
    p_true, uvn, R, p = make_scene()
    mask = jnp.ones(uvn.shape[0], bool)
    est, ok = triangulate_linear(uvn, mask, R, p)
    assert bool(ok)
    np.testing.assert_allclose(np.asarray(est), p_true, atol=1e-8)


def test_triangulate_masked_padding():
    p_true, uvn, R, p = make_scene()
    # append garbage padded rows
    uvn2 = jnp.concatenate([uvn, jnp.full((3, 2), 777.0)], axis=0)
    R2 = jnp.concatenate([R, jnp.tile(jnp.eye(3)[None], (3, 1, 1))], axis=0)
    p2 = jnp.concatenate([p, jnp.zeros((3, 3))], axis=0)
    mask = jnp.concatenate([jnp.ones(6, bool), jnp.zeros(3, bool)])
    est, ok = triangulate_linear(uvn2, mask, R2, p2)
    assert bool(ok)
    np.testing.assert_allclose(np.asarray(est), p_true, atol=1e-8)


def test_gauss_newton_improves_noisy():
    p_true, uvn, R, p = make_scene(noise=2e-3)
    mask = jnp.ones(uvn.shape[0], bool)
    est, ok = triangulate_linear(uvn, mask, R, p)
    ref, ok2 = refine_gauss_newton(est, uvn, mask, R, p)
    assert bool(ok) and bool(ok2)
    # GN should not be worse than linear (reprojection optimal)
    def cost(pt):
        pc = np.einsum("mij,mj->mi", np.asarray(R), np.asarray(pt)[None] - np.asarray(p))
        pred = pc[:, :2] / pc[:, 2:3]
        return np.sum((pred - np.asarray(uvn)) ** 2)

    assert cost(ref) <= cost(est) + 1e-12


def test_triangulate_batch():
    scenes = [make_scene(noise=1e-3) for _ in range(4)]
    uvn = jnp.stack([s[1] for s in scenes])
    R = jnp.stack([s[2] for s in scenes])
    p = jnp.stack([s[3] for s in scenes])
    mask = jnp.ones(uvn.shape[:2], bool)
    est, ok = triangulate_batch(uvn, mask, R, p)
    assert bool(jnp.all(ok))
    for i, s in enumerate(scenes):
        np.testing.assert_allclose(np.asarray(est[i]), s[0], atol=5e-2)


def test_degenerate_rejected():
    # all observations from the same position -> unobservable depth
    p_true = np.array([0.0, 0.0, 5.0])
    R = jnp.tile(jnp.eye(3)[None], (4, 1, 1))
    p = jnp.zeros((4, 3))
    uvn = jnp.tile(jnp.asarray(p_true[:2] / p_true[2])[None], (4, 1))
    est, ok = triangulate_linear(uvn, jnp.ones(4, bool), R, p)
    assert not bool(ok)
