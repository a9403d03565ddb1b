"""MapBackend: VIO -> sharded-BA integration (the reference's
loop-closure export consumer analog, `VioManagerHelper.cpp:190-387`,
extended with an actual map refiner the reference lacks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uvio_jax.manager import CameraConfig, VioConfig, VioManager
from uvio_jax.math import quat_to_rot
from uvio_jax.parallel import BAOptions, MapBackend, MapBackendOptions, ba_solve
from uvio_jax.sim import SimParams, Simulator, circle_trajectory


def test_ba_pose_valid_padding_inert():
    """Padding the keyframe axis with pose_valid=False slots reproduces
    the unpadded solve on the live slots."""
    from tests.test_ba import make_scene, perturb

    q, p, lm, obs, mask = make_scene(N=10, L=48)
    q0, p0, lm0 = perturb(q, p, lm)
    qs1, ps1, lms1, _ = ba_solve(
        jnp.asarray(q0), jnp.asarray(p0), jnp.asarray(lm0),
        jnp.asarray(obs), jnp.asarray(mask), BAOptions(iters=6),
    )
    pad = 6
    qp = np.concatenate([q0, np.tile([0.0, 0, 0, 1], (pad, 1))])
    pp = np.concatenate([p0, np.zeros((pad, 3))])
    obs_p = np.concatenate([obs, np.zeros(obs.shape[:1] + (pad, 2))], axis=1)
    mask_p = np.concatenate([mask, np.zeros(mask.shape[:1] + (pad,), bool)], axis=1)
    valid = np.concatenate([np.ones(len(q0), bool), np.zeros(pad, bool)])
    qs2, ps2, lms2, _ = ba_solve(
        jnp.asarray(qp), jnp.asarray(pp), jnp.asarray(lm0),
        jnp.asarray(obs_p), jnp.asarray(mask_p), BAOptions(iters=6),
        pose_valid=jnp.asarray(valid),
    )
    np.testing.assert_allclose(np.asarray(ps1), np.asarray(ps2)[: len(q0)], atol=1e-9)
    np.testing.assert_allclose(np.asarray(lms1), np.asarray(lms2), atol=1e-9)
    # padded slots untouched
    np.testing.assert_allclose(np.asarray(ps2)[len(q0):], 0.0, atol=0)


@pytest.mark.slow
def test_map_backend_e2e_refines_map():
    """Live VIO feeds the backend; the sharded BA refine must produce
    keyframe poses and landmarks close to simulation groundtruth."""
    sim = Simulator(
        SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=50, seed=11),
        trajectory=circle_trajectory(duration=16.0),
    )
    cam = sim.params.cameras[0]
    cfg = VioConfig(
        max_clones=11,
        max_msckf_in_update=40,
        sigma_pix=sim.params.sigma_pix,
        cameras=[CameraConfig(model=cam.model, intrinsics=cam.intrinsics,
                              q_ItoC=cam.q_ItoC, p_IinC=cam.p_IinC)],
    )
    mgr = VioManager(cfg)
    g0 = sim.get_gt_state(sim.t_start)
    mgr.initialize_with_gt(
        sim.t_start, g0["q_GtoI"], g0["p_IinG"], g0["v_IinG"], g0["bg"], g0["ba"]
    )

    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("kf", "lm"))
    backend = MapBackend(
        MapBackendOptions(every_n_frames=3, max_keyframes=48, lm_bucket=64),
        mesh=mesh,
    )

    gt_cam_p = {}
    while sim.ok():
        r = sim.get_next_imu()
        if r is None:
            break
        t, wm, am = r
        mgr.feed_imu(t, wm, am)
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= t:
            rc = sim.get_next_cam()
            if rc is None:
                break
            tc, obs = rc
            mgr.feed_features(tc, obs)
            if backend.ingest(mgr):
                g = sim.get_gt_state(tc)
                R_GtoI = np.asarray(quat_to_rot(jnp.asarray(g["q_GtoI"])))
                R_ItoC = np.asarray(quat_to_rot(jnp.asarray(cam.q_ItoC)))
                p_CinG = g["p_IinG"] - R_GtoI.T @ (R_ItoC.T @ cam.p_IinC)
                gt_cam_p[tc] = p_CinG

    assert backend.num_keyframes >= 20
    res = backend.refine()
    assert res is not None
    costs = res["costs"]
    assert costs[-1] <= costs[0]

    # keyframe positions close to groundtruth camera centers (keyed by
    # timestamp: eviction may have dropped some ingested keyframes)
    gt_p = np.asarray([gt_cam_p[t] for t in res["kf_t"]])
    kf_err = np.linalg.norm(res["kf_p"] - gt_p, axis=1)
    assert np.median(kf_err) < 0.05, (np.median(kf_err), kf_err.max())

    # refined landmarks close to the gt map (ids are map indices)
    pts = res["points"]
    assert len(pts) >= 20
    errs = np.asarray(
        [np.linalg.norm(p - sim.map_pts[fid]) for fid, p in pts.items()]
    )
    assert np.median(errs) < 0.05, (np.median(errs), errs.max())


def test_map_backend_eviction():
    """Past max_keyframes, ingest evicts by temporal decimation: the
    span endpoints survive, capacity holds, indices stay consistent."""
    be = MapBackend(MapBackendOptions(max_keyframes=8, every_n_frames=1))
    # populate directly (bypassing ingest's manager plumbing)
    for i in range(8):
        be.kf_t.append(float(i))
        be.kf_q.append(np.array([0.0, 0, 0, 1]))
        be.kf_p.append(np.array([float(i), 0, 0]))
    # a landmark observed in every keyframe + one only in kf 2
    be.obs[100] = {k: np.array([0.1, 0.1]) for k in range(8)}
    be.obs[200] = {2: np.array([0.2, 0.2])}

    t_first, t_last = be.kf_t[0], be.kf_t[-1]
    be._evict()
    assert be.num_keyframes == 7
    assert be.kf_t[0] == t_first and be.kf_t[-1] == t_last
    # the dense landmark lost exactly one obs; indices remap contiguously
    assert len(be.obs[100]) == 7
    assert sorted(be.obs[100]) == list(range(7))
    # obs uv follow their keyframe: kf at time t has obs index == position
    for k in range(7):
        assert be.kf_t[k] == float(be.kf_t[k])
    # evict until the single-obs landmark's keyframe dies -> landmark dies
    for _ in range(5):
        be._evict()
    assert be.num_keyframes == 2
    assert 200 not in be.obs or len(be.obs[200]) > 0
    # the survivor still spans the full time range
    assert be.kf_t[0] == t_first and be.kf_t[-1] == t_last
