"""Camera model tests against the OpenCV oracle.

The reference uses cv::undistortPoints / hand-derived Jacobians
(`ov_core/src/cam/`); we validate our jit-safe reimplementation against
OpenCV directly and against autodiff consistency.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np

from uvio_jax.cam import EQUI, RADTAN, distort, distort_jacobian, project, undistort

RNG = np.random.default_rng(3)

PARAMS_RADTAN = np.array([458.0, 457.0, 367.2, 248.4, -0.28, 0.07, 1.8e-4, 7.6e-5])
PARAMS_EQUI = np.array([190.1, 190.2, 254.9, 256.9, 0.0034, 0.0008, -0.0037, 0.0009])


def _norm_points(n):
    return RNG.uniform(-0.5, 0.5, size=(n, 2))


def test_distort_radtan_matches_opencv():
    xy = _norm_points(100)
    pts3d = np.concatenate([xy, np.ones((100, 1))], axis=1)
    K = np.array(
        [[PARAMS_RADTAN[0], 0, PARAMS_RADTAN[2]], [0, PARAMS_RADTAN[1], PARAMS_RADTAN[3]], [0, 0, 1]]
    )
    dist = PARAMS_RADTAN[4:8]
    uv_cv, _ = cv2.projectPoints(
        pts3d.reshape(-1, 1, 3), np.zeros(3), np.zeros(3), K, dist
    )
    uv = distort(jnp.asarray(PARAMS_RADTAN), RADTAN, jnp.asarray(xy))
    np.testing.assert_allclose(np.asarray(uv), uv_cv.reshape(-1, 2), atol=1e-8)


def test_distort_equi_matches_opencv():
    xy = _norm_points(100)
    K = np.array(
        [[PARAMS_EQUI[0], 0, PARAMS_EQUI[2]], [0, PARAMS_EQUI[1], PARAMS_EQUI[3]], [0, 0, 1]]
    )
    dist = PARAMS_EQUI[4:8].reshape(4, 1)
    uv_cv, _ = cv2.fisheye.distortPoints(xy.reshape(1, -1, 2), K, dist), None
    uv = distort(jnp.asarray(PARAMS_EQUI), EQUI, jnp.asarray(xy))
    np.testing.assert_allclose(np.asarray(uv), uv_cv[0].reshape(-1, 2), atol=1e-6)


def test_undistort_roundtrip_radtan():
    xy = _norm_points(200)
    uv = distort(jnp.asarray(PARAMS_RADTAN), RADTAN, jnp.asarray(xy))
    xy2 = undistort(jnp.asarray(PARAMS_RADTAN), RADTAN, uv)
    np.testing.assert_allclose(np.asarray(xy2), xy, atol=1e-8)


def test_undistort_roundtrip_equi():
    xy = _norm_points(200)
    uv = distort(jnp.asarray(PARAMS_EQUI), EQUI, jnp.asarray(xy))
    xy2 = undistort(jnp.asarray(PARAMS_EQUI), EQUI, uv)
    np.testing.assert_allclose(np.asarray(xy2), xy, atol=1e-8)


def test_distort_jacobian_finite_diff():
    for model, params in [(RADTAN, PARAMS_RADTAN), (EQUI, PARAMS_EQUI)]:
        xy = jnp.asarray(_norm_points(10))
        p = jnp.asarray(params)
        J_norm, J_calib = distort_jacobian(p, model, xy)
        assert J_norm.shape == (10, 2, 2)
        assert J_calib.shape == (10, 2, 8)
        eps = 1e-7
        for k in range(2):
            dxy = np.zeros(2)
            dxy[k] = eps
            fd = (distort(p, model, xy + dxy) - distort(p, model, xy - dxy)) / (2 * eps)
            np.testing.assert_allclose(np.asarray(J_norm[:, :, k]), np.asarray(fd), atol=1e-5)
        for k in range(8):
            dp = np.zeros(8)
            dp[k] = eps
            fd = (distort(p + dp, model, xy) - distort(p - dp, model, xy)) / (2 * eps)
            np.testing.assert_allclose(np.asarray(J_calib[:, :, k]), np.asarray(fd), atol=1e-4)


def test_project():
    pts = RNG.uniform(-1, 1, size=(50, 3))
    pts[:, 2] = RNG.uniform(1.0, 5.0, size=50)
    uv = project(jnp.asarray(PARAMS_RADTAN), RADTAN, jnp.asarray(pts))
    expect = distort(
        jnp.asarray(PARAMS_RADTAN), RADTAN, jnp.asarray(pts[:, :2] / pts[:, 2:3])
    )
    np.testing.assert_allclose(np.asarray(uv), np.asarray(expect), atol=1e-10)


def test_jit_compatible():
    xy = jnp.asarray(_norm_points(8))
    f = jax.jit(lambda p, x: distort(p, RADTAN, x))
    g = jax.jit(lambda p, x: undistort(p, RADTAN, x))
    uv = f(jnp.asarray(PARAMS_RADTAN), xy)
    xy2 = g(jnp.asarray(PARAMS_RADTAN), uv)
    np.testing.assert_allclose(np.asarray(xy2), np.asarray(xy), atol=1e-8)
