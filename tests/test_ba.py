"""Sharded bundle-adjustment tests: convergence to groundtruth and
single-device vs 8-device-mesh equivalence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation as Rsp

from uvio_jax.math import quat_to_rot, rot_to_quat
from uvio_jax.parallel.ba import BAOptions, ba_solve

RNG = np.random.default_rng(3)


def make_scene(N=12, L=64, noise_px=0.5, f=450.0):
    """Keyframes on an arc looking inward at a landmark cloud."""
    th = np.linspace(0, 1.2, N)
    p = np.stack([3 * np.cos(th), 3 * np.sin(th), 0.1 * th], axis=1)
    lm = RNG.uniform(-1.5, 1.5, (L, 3))
    lm[:, 2] += 0.0
    qs, preds, masks = [], np.zeros((L, N, 2)), np.zeros((L, N), bool)
    for k in range(N):
        # camera looks toward the origin
        z = -p[k] / np.linalg.norm(p[k])
        x = np.cross([0, 0, 1.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R_GtoC = np.stack([x, y, z], axis=0)
        qs.append(np.asarray(rot_to_quat(jnp.asarray(R_GtoC))))
        pc = (lm - p[k]) @ R_GtoC.T
        ok = pc[:, 2] > 0.5
        uv = pc[:, :2] / pc[:, 2:3]
        uv += (noise_px / f) * RNG.standard_normal(uv.shape)
        preds[:, k] = uv
        masks[:, k] = ok & (np.abs(uv) < 0.9).all(axis=1)
    return np.stack(qs), p, lm, preds, masks


def perturb(q, p, lm, s_rot=0.02, s_pos=0.05, s_lm=0.10, keep=1):
    qs = np.array(q)
    ps = np.array(p)
    for k in range(keep, len(q)):
        dR = Rsp.from_rotvec(s_rot * RNG.standard_normal(3)).as_matrix()
        R = dR @ np.asarray(quat_to_rot(jnp.asarray(q[k])))
        qs[k] = np.asarray(rot_to_quat(jnp.asarray(R)))
        ps[k] = p[k] + s_pos * RNG.standard_normal(3)
    lms = lm + s_lm * RNG.standard_normal(lm.shape)
    return qs, ps, lms


def reproj_rmse(q, p, lm, obs, mask):
    R = np.asarray(quat_to_rot(jnp.asarray(q)))
    pc = np.einsum("nij,lnj->lni", R, lm[:, None, :] - p[None, :, :])
    uv = pc[..., :2] / pc[..., 2:3]
    e = (uv - obs) * mask[..., None]
    return np.sqrt((e**2).sum() / max(mask.sum(), 1))


def test_ba_converges():
    q, p, lm, obs, mask = make_scene()
    q0, p0, lm0 = perturb(q, p, lm)
    rmse_before = reproj_rmse(q0, p0, lm0, obs, mask)
    qs, ps, lms, info = ba_solve(
        jnp.asarray(q0), jnp.asarray(p0), jnp.asarray(lm0),
        jnp.asarray(obs), jnp.asarray(mask), BAOptions(iters=15),
    )
    rmse_after = reproj_rmse(np.asarray(qs), np.asarray(ps), np.asarray(lms), obs, mask)
    assert rmse_after < rmse_before * 0.05, (rmse_before, rmse_after)
    # absolute pose error (first pose gauge-fixed): should approach gt
    err_p = np.linalg.norm(np.asarray(ps) - p, axis=1)
    assert err_p.max() < 0.02, err_p.max()


def test_ba_sharded_matches_single():
    q, p, lm, obs, mask = make_scene(L=64)
    q0, p0, lm0 = perturb(q, p, lm)
    args = (jnp.asarray(q0), jnp.asarray(p0), jnp.asarray(lm0),
            jnp.asarray(obs), jnp.asarray(mask))
    qs1, ps1, lms1, _ = ba_solve(*args, BAOptions(iters=8))

    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:8])
    mesh = Mesh(devs, ("dp",))
    qs2, ps2, lms2, _ = ba_solve(*args, BAOptions(iters=8), mesh=mesh)
    np.testing.assert_allclose(np.asarray(ps1), np.asarray(ps2), atol=1e-8)
    np.testing.assert_allclose(np.asarray(lms1), np.asarray(lms2), atol=1e-8)


def test_ba_2d_kf_lm_sharded_matches_single():
    """Keyframe x landmark 2D mesh (2x4) reproduces the unsharded solve."""
    q, p, lm, obs, mask = make_scene(N=12, L=64)
    q0, p0, lm0 = perturb(q, p, lm)
    args = (jnp.asarray(q0), jnp.asarray(p0), jnp.asarray(lm0),
            jnp.asarray(obs), jnp.asarray(mask))
    qs1, ps1, lms1, i1 = ba_solve(*args, BAOptions(iters=8))

    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("kf", "lm"))
    qs2, ps2, lms2, i2 = ba_solve(*args, BAOptions(iters=8), mesh=mesh)
    np.testing.assert_allclose(np.asarray(ps1), np.asarray(ps2), atol=1e-8)
    np.testing.assert_allclose(np.asarray(lms1), np.asarray(lms2), atol=1e-8)
    np.testing.assert_allclose(
        np.asarray(i1["costs"]), np.asarray(i2["costs"]), rtol=1e-8
    )


def test_ba_masked_padding_inert():
    q, p, lm, obs, mask = make_scene(L=48)
    # append pure-padding landmarks
    L_pad = 16
    lm_p = np.concatenate([lm, np.zeros((L_pad, 3))])
    obs_p = np.concatenate([obs, np.zeros((L_pad,) + obs.shape[1:])])
    mask_p = np.concatenate([mask, np.zeros((L_pad,) + mask.shape[1:], bool)])
    q0, p0, lm0 = perturb(q, p, lm)
    lm0_p = np.concatenate([lm0, np.zeros((L_pad, 3))])
    qs1, ps1, _, _ = ba_solve(
        jnp.asarray(q0), jnp.asarray(p0), jnp.asarray(lm0),
        jnp.asarray(obs), jnp.asarray(mask), BAOptions(iters=6),
    )
    qs2, ps2, _, _ = ba_solve(
        jnp.asarray(q0), jnp.asarray(p0), jnp.asarray(lm0_p),
        jnp.asarray(obs_p), jnp.asarray(mask_p), BAOptions(iters=6),
    )
    np.testing.assert_allclose(np.asarray(ps1), np.asarray(ps2), atol=1e-9)


@pytest.mark.slow
def test_map_backend_refine_realistic_on_mesh():
    """`MapBackend.refine` at a realistic map size (256 kf x 4096 lm)
    through the 8-device 2D kf x lm mesh."""
    from jax.sharding import Mesh

    from uvio_jax.parallel.ba import BAOptions
    from uvio_jax.parallel.map_backend import MapBackend, MapBackendOptions

    rng = np.random.default_rng(11)
    N, L = 256, 4096
    th = np.linspace(0, 4 * np.pi, N)
    p = np.stack([6 * np.cos(th), 6 * np.sin(th), 0.5 * np.sin(3 * th)], 1)
    lm = rng.uniform(-3, 3, (L, 3))
    qs, Rs = [], []
    for k in range(N):
        z = -p[k] / np.linalg.norm(p[k])
        x = np.cross([0, 0, 1.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        Rs.append(np.stack([x, y, z]))
        qs.append(np.asarray(rot_to_quat(jnp.asarray(Rs[-1]))))
    q, R = np.stack(qs), np.stack(Rs)
    pc = np.einsum("nij,lnj->lni", R, lm[:, None, :] - p[None, :, :])
    vis = pc[..., 2] > 1.0
    obs = pc[..., :2] / np.where(np.abs(pc[..., 2:]) < 1e-3, 1e-3, pc[..., 2:])
    obs = obs + 1e-3 * rng.standard_normal(obs.shape)

    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    backend = MapBackend(
        MapBackendOptions(
            max_keyframes=N, lm_bucket=512, min_obs=3,
            ba=BAOptions(iters=3),
        ),
        mesh=Mesh(devs, ("kf", "lm")),
    )
    # fill directly (ingest() is exercised by test_map_backend; here the
    # point is the realistic-shape sharded solve)
    backend.kf_t = list(np.arange(N, dtype=float))
    backend.kf_q = [q[k] for k in range(N)]
    backend.kf_p = [p[k] for k in range(N)]
    for i in range(L):
        ks = np.nonzero(vis[i])[0]
        if len(ks) >= 3:
            backend.obs[i] = {int(k): obs[i, k] for k in ks}

    res = backend.refine()
    assert res is not None
    costs = res["costs"]
    assert costs[-1] < costs[0], costs
    # refined landmarks should sit near their true positions
    errs = [np.linalg.norm(res["points"][i] - lm[i]) for i in res["points"]]
    assert len(errs) > 3000
    assert np.median(errs) < 0.05, np.median(errs)
