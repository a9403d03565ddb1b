"""Integration method options: discrete / rk4 / analytical
(StateOptions::IntegrationMethod; `Propagator.cpp:435-459, 482-829`)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from uvio_jax.filter.propagator import (
    NoiseManager,
    _analytic_mean,
    _discrete_mean,
    _rk4_mean,
    _xi_sum,
    propagate_mean_cov,
)
from uvio_jax.math import quat_multiply, quat_to_rot
from uvio_jax.types.layout import StateLayout
from uvio_jax.types.state import init_state

GRAVITY = 9.81


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    layout = StateLayout(max_clones=3, max_imu_batch=8)
    s = init_state(layout)
    qv = rng.standard_normal(4)
    qv /= np.linalg.norm(qv)
    s = s.replace(
        q=jnp.asarray(qv), q_fej=jnp.asarray(qv),
        p=jnp.asarray(rng.standard_normal(3)), v=jnp.asarray(rng.standard_normal(3)),
        p_fej=s.p, v_fej=s.v,
        bg=jnp.asarray(0.01 * rng.standard_normal(3)),
        ba=jnp.asarray(0.05 * rng.standard_normal(3)),
        cov=jnp.asarray(np.eye(layout.dim) * 1e-4),
        time=jnp.asarray(0.0, jnp.float64),
    )
    s = s.replace(p_fej=s.p, v_fej=s.v)
    M = layout.max_imu_batch
    t = jnp.asarray(np.arange(M) * 0.005)
    w = jnp.asarray(0.4 * rng.standard_normal(3) + 0.05 * rng.standard_normal((M, 3)))
    a = jnp.asarray(
        np.asarray(quat_to_rot(s.q)) @ np.array([0, 0, GRAVITY])
        + 0.5 * rng.standard_normal(3)
        + 0.05 * rng.standard_normal((M, 3))
    )
    return layout, s, t, w, a


def test_xi_small_w_continuity():
    """Xi integrals must be continuous across the small-w switch."""
    a = jnp.asarray([0.3, -0.2, 9.7])
    dt = 0.005
    thr = np.pi / 360.0
    for eps in (-1e-6, 1e-6):
        w1 = jnp.asarray([1.0, 0.2, -0.3])
        w1 = w1 / jnp.linalg.norm(w1) * (thr + eps)
        out = _xi_sum(w1, a, dt, jnp.float64)
        out2 = _xi_sum(w1 * (1 + 2e-6 / thr), a, dt, jnp.float64)
        # the two series forms agree to O(w*dt^2) at the switch (the
        # reference's branches have the same mismatch)
        for m1, m2 in zip(out, out2):
            np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), atol=1e-6)


def test_analytic_mean_matches_rk4_constant_inputs():
    """With constant w/a the ACI2 closed form is exact, so RK4 and
    analytic must agree to integration error."""
    rng = np.random.default_rng(3)
    qv = rng.standard_normal(4)
    qv /= np.linalg.norm(qv)
    q = jnp.asarray(qv)
    p = jnp.asarray(rng.standard_normal(3))
    v = jnp.asarray(rng.standard_normal(3))
    w = jnp.asarray([0.3, -0.5, 0.8])
    a = jnp.asarray([0.4, 0.1, 9.9])
    g = jnp.asarray([0.0, 0.0, GRAVITY])
    dt = 0.01
    xi = _xi_sum(w, a, dt, jnp.float64)
    qa, pa, va = _analytic_mean(q, p, v, a, dt, g, xi)
    qr, pr, vr = _rk4_mean(q, p, v, w, a, w, a, dt, g)
    dq = quat_multiply(qa, jnp.concatenate([-qr[:3], qr[3:4]]))
    assert np.linalg.norm(np.asarray(2 * dq[:3])) < 1e-9
    np.testing.assert_allclose(np.asarray(pa), np.asarray(pr), atol=1e-9)
    np.testing.assert_allclose(np.asarray(va), np.asarray(vr), atol=1e-9)
    # discrete is only first-order: close but not equal
    qd, pd, vd = _discrete_mean(q, p, v, w, a, dt, g)
    assert 1e-12 < np.linalg.norm(np.asarray(pd) - np.asarray(pa)) < 1e-3


@pytest.mark.parametrize("method", ["discrete", "rk4", "analytical"])
def test_phi_matches_autodiff_all_methods(method):
    """Accumulated Phi must be the Jacobian of each method's own mean
    map (first-order self-consistency)."""
    layout, s, t, w, a = _setup()
    noises = NoiseManager()
    D = layout.dim

    from uvio_jax.filter.ekf import inject

    def mean_map(dx15):
        dx = jnp.zeros(D).at[:15].set(dx15)
        sp = inject(s, layout, dx)
        sp = sp.replace(q_fej=sp.q, p_fej=sp.p, v_fej=sp.v)
        ns, _ = propagate_mean_cov(sp, layout, t, w, a, noises, GRAVITY, integration=method)
        ns0, _ = propagate_mean_cov(s, layout, t, w, a, noises, GRAVITY, integration=method)
        dq = quat_multiply(ns.q, jnp.concatenate([-ns0.q[:3], ns0.q[3:4]]))
        dtheta = 2.0 * dq[:3] / dq[3]
        return jnp.concatenate(
            [dtheta, ns.p - ns0.p, ns.v - ns0.v, ns.bg - ns0.bg, ns.ba - ns0.ba]
        )

    Phi_num = np.asarray(jax.jacfwd(mean_map)(jnp.zeros(15)))
    zero_noise = NoiseManager(sigma_w=0.0, sigma_wb=0.0, sigma_a=0.0, sigma_ab=0.0)
    s_eye = s.replace(cov=jnp.eye(D))
    ns_zn, _ = propagate_mean_cov(
        s_eye, layout, t, w, a, zero_noise, GRAVITY, integration=method
    )
    PhiPhiT = np.asarray(ns_zn.cov)[:15, :15]
    np.testing.assert_allclose(PhiPhiT, Phi_num @ Phi_num.T, rtol=2e-3, atol=5e-4)


@pytest.mark.parametrize("method", ["discrete", "analytical"])
def test_methods_agree_with_rk4(method):
    """All three integrators propagate the same trajectory to within
    their truncation error on smooth inputs."""
    layout, s, t, w, a = _setup(seed=5)
    noises = NoiseManager()
    ref, _ = propagate_mean_cov(s, layout, t, w, a, noises, GRAVITY, integration="rk4")
    out, _ = propagate_mean_cov(s, layout, t, w, a, noises, GRAVITY, integration=method)
    tol = 5e-4 if method == "discrete" else 5e-5
    assert np.linalg.norm(np.asarray(out.p) - np.asarray(ref.p)) < tol
    assert np.linalg.norm(np.asarray(out.v) - np.asarray(ref.v)) < tol
    # covariances stay symmetric positive and close
    P = np.asarray(out.cov)
    assert np.allclose(P, P.T)
    assert np.all(np.linalg.eigvalsh(P[:15, :15]) > 0)


@pytest.mark.slow
@pytest.mark.parametrize("method", ["discrete", "analytical"])
def test_sim_tracks_all_methods(method):
    """End-to-end: each integration option must track the sim."""
    from uvio_jax.manager import CameraConfig, VioConfig, VioManager
    from uvio_jax.sim import SimParams, Simulator, circle_trajectory

    sim = Simulator(SimParams(seed=11), trajectory=circle_trajectory(duration=14.0))
    cam = sim.params.cameras[0]
    cfg = VioConfig(
        max_clones=11, sigma_pix=sim.params.sigma_pix, integration=method,
        cameras=[CameraConfig(model=cam.model, intrinsics=cam.intrinsics,
                              q_ItoC=cam.q_ItoC, p_IinC=cam.p_IinC)],
    )
    mgr = VioManager(cfg)
    g0 = sim.get_gt_state(sim.t_start)
    mgr.initialize_with_gt(
        sim.t_start, g0["q_GtoI"], g0["p_IinG"], g0["v_IinG"], g0["bg"], g0["ba"]
    )
    err = None
    frames = 0
    while sim.ok() and frames < 100:
        r = sim.get_next_imu()
        if r is None:
            break
        tt, wm, am = r
        mgr.feed_imu(tt, wm, am)
        if sim.cur_cam_t + 0.1 <= tt:
            rc = sim.get_next_cam()
            if rc is None:
                break
            mgr.feed_features(*rc)
            frames += 1
            g = sim.get_gt_state(rc[0])
            err = np.linalg.norm(np.asarray(mgr.state.p) - g["p_IinG"])
    assert err is not None and err < 0.2, (method, err)
