"""Simulator determinism + measurement validity — the reference's
`test_sim_repeat.cpp` (fixed seed => identical streams) and
`test_sim_meas.cpp` (measurements match direct reprojection)."""

import numpy as np

import jax.numpy as jnp

from uvio_jax.cam import distort
from uvio_jax.math import quat_to_rot
from uvio_jax.sim import SimParams, Simulator, circle_trajectory


def _collect(seed, n_imu=200, n_cam=10):
    sim = Simulator(SimParams(seed=seed), trajectory=circle_trajectory(duration=8.0))
    imu, cams = [], []
    for _ in range(n_imu):
        r = sim.get_next_imu()
        if r is None:
            break
        imu.append(np.concatenate([[r[0]], r[1], r[2]]))
        if sim.cur_cam_t + 0.1 <= r[0] and len(cams) < n_cam:
            rc = sim.get_next_cam()
            if rc is not None:
                t, obs = rc
                ids, uvs = obs[0]
                cams.append((t, ids.copy(), uvs.copy()))
    return np.asarray(imu), cams


def test_sim_repeat():
    """Same seed => bit-identical IMU and uv streams (test_sim_repeat)."""
    imu1, cams1 = _collect(42)
    imu2, cams2 = _collect(42)
    np.testing.assert_array_equal(imu1, imu2)
    assert len(cams1) == len(cams2) > 3
    for (t1, i1, u1), (t2, i2, u2) in zip(cams1, cams2):
        assert t1 == t2
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(u1, u2)
    # different seed => different noise
    imu3, _ = _collect(43)
    assert not np.allclose(imu1[:, 1:], imu3[: len(imu1), 1:])


def test_sim_meas_match_reprojection():
    """Noise-free simulated uv == direct projection of the map through
    the groundtruth pose (test_sim_meas)."""
    params = SimParams(seed=7, sigma_pix=0.0, num_pts=30)
    sim = Simulator(params, trajectory=circle_trajectory(duration=6.0))
    cam = params.cameras[0]
    for _ in range(40):
        r = sim.get_next_imu()
        if r is None:
            break
        if sim.cur_cam_t + 0.1 <= r[0]:
            rc = sim.get_next_cam()
            if rc is None:
                break
            t, obs = rc
            ids, uvs = obs[0]
            g = sim.get_gt_state(t)
            R_GtoI = quat_to_rot(jnp.asarray(g["q_GtoI"]))
            R_ItoC = quat_to_rot(jnp.asarray(cam.q_ItoC))
            for fid, uv in zip(ids[:10], uvs[:10]):
                p_G = sim.map_pts[int(fid)]
                p_I = np.asarray(R_GtoI) @ (p_G - g["p_IinG"])
                p_C = np.asarray(R_ItoC) @ p_I + cam.p_IinC
                uvn = p_C[:2] / p_C[2]
                uv_pred = np.asarray(
                    distort(jnp.asarray(cam.intrinsics), cam.model, jnp.asarray(uvn))
                )
                assert p_C[2] > 0
                np.testing.assert_allclose(uv, uv_pred, atol=1e-5)
