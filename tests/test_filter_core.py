"""Filter-core tests: propagation Jacobian consistency, cloning,
marginalization, EKF update sanity.

The reference validates these only implicitly through simulation NEES;
we additionally verify the error-state transition matrix against
autodiff of the nonlinear mean map (a check the reference cannot do).
"""

import jax
import jax.numpy as jnp
import numpy as np

from uvio_jax.filter import (
    NoiseManager,
    augment_clone,
    ekf_update,
    inject,
    marginalize_clone,
    propagate_mean_cov,
    select_imu_readings_np,
)
from uvio_jax.math import quat_multiply, quat_norm, quat_to_rot, rot_to_quat
from uvio_jax.types import StateLayout, init_state

GRAVITY = 9.81
RNG = np.random.default_rng(0)


def make_layout(**kw):
    kw.setdefault("max_clones", 4)
    kw.setdefault("max_imu_batch", 8)
    return StateLayout(**kw)


def random_state(layout, dtype=jnp.float64):
    s = init_state(layout, dtype)
    from scipy.spatial.transform import Rotation as Rsp

    q = rot_to_quat(jnp.asarray(Rsp.random(random_state=1).as_matrix()))
    s = s.replace(
        q=q,
        q_fej=q,
        p=jnp.asarray(RNG.normal(size=3)),
        v=jnp.asarray(RNG.normal(size=3)),
        bg=jnp.asarray(0.01 * RNG.normal(size=3)),
        ba=jnp.asarray(0.05 * RNG.normal(size=3)),
        time=jnp.asarray(0.0),
    )
    s = s.replace(p_fej=s.p, v_fej=s.v)
    # random SPD covariance
    D = layout.dim
    Arand = RNG.normal(size=(D, D)) * 0.01
    s = s.replace(cov=jnp.asarray(Arand @ Arand.T + 0.01 * np.eye(D)))
    return s


def imu_batch(layout, n_real, dt=0.005, w_mag=0.6, a_mag=1.5):
    t = np.arange(n_real) * dt
    w = w_mag * RNG.normal(size=(n_real, 3))
    a = a_mag * RNG.normal(size=(n_real, 3)) + np.array([0, 0, GRAVITY])
    M = layout.max_imu_batch
    pad = M - n_real
    t = np.concatenate([t, np.full(pad, t[-1])])
    w = np.concatenate([w, np.tile(w[-1], (pad, 1))])
    a = np.concatenate([a, np.tile(a[-1], (pad, 1))])
    return jnp.asarray(t), jnp.asarray(w), jnp.asarray(a)


def test_propagate_stationary():
    layout = make_layout()
    s = init_state(layout)
    s = s.replace(time=jnp.asarray(0.0))
    t, w, a = imu_batch(layout, 6, w_mag=0.0, a_mag=0.0)
    ns, _ = propagate_mean_cov(s, layout, t, w, a, NoiseManager(), GRAVITY)
    np.testing.assert_allclose(np.asarray(ns.p), 0.0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ns.v), 0.0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ns.q), [0, 0, 0, 1], atol=1e-12)
    assert float(ns.time) == float(t[-1])


def test_padding_is_identity():
    layout = make_layout()
    s = random_state(layout)
    t, w, a = imu_batch(layout, 5)
    ns1, _ = propagate_mean_cov(s, layout, t, w, a, NoiseManager(), GRAVITY)
    # extend padding: same result
    layout2 = make_layout(max_imu_batch=16)
    M2 = 16
    t2 = jnp.concatenate([t, jnp.full((M2 - 8,), t[-1])])
    w2 = jnp.concatenate([w, jnp.tile(w[-1:], (M2 - 8, 1))])
    a2 = jnp.concatenate([a, jnp.tile(a[-1:], (M2 - 8, 1))])
    ns2, _ = propagate_mean_cov(s, layout2, t2, w2, a2, NoiseManager(), GRAVITY)
    np.testing.assert_allclose(np.asarray(ns1.q), np.asarray(ns2.q), atol=1e-12)
    np.testing.assert_allclose(np.asarray(ns1.cov), np.asarray(ns2.cov), atol=1e-12)


def _boxplus(s, layout, dx):
    return inject(s, layout, dx)


def test_phi_matches_autodiff():
    """The accumulated Phi must equal the Jacobian of the mean map in
    error coordinates (first-order consistency of compute_F_and_G)."""
    layout = make_layout()
    s = random_state(layout)
    t, w, a = imu_batch(layout, 4, dt=0.004)
    noises = NoiseManager()

    D = layout.dim

    def mean_map(dx15):
        dx = jnp.zeros(D).at[:15].set(dx15)
        sp = _boxplus(s, layout, dx)
        sp = sp.replace(q_fej=sp.q, p_fej=sp.p, v_fej=sp.v)
        ns, _ = propagate_mean_cov(sp, layout, t, w, a, noises, GRAVITY)
        # boxminus against unperturbed propagation
        ns0, _ = propagate_mean_cov(s, layout, t, w, a, noises, GRAVITY)
        dq = quat_multiply(ns.q, jnp.concatenate([-ns0.q[:3], ns0.q[3:4]]))
        dtheta = 2.0 * dq[:3] / dq[3]
        return jnp.concatenate(
            [dtheta, ns.p - ns0.p, ns.v - ns0.v, ns.bg - ns0.bg, ns.ba - ns0.ba]
        )

    Phi_num = np.asarray(jax.jacfwd(mean_map)(jnp.zeros(15)))
    # recover accumulated Phi from covariance propagation with identity cov
    s_eye = s.replace(cov=jnp.eye(D))
    ns_eye, _ = propagate_mean_cov(s_eye, layout, t, w, a, noises, GRAVITY)
    # P' = Phi Phi^T + Qd over imu block; instead use cross block with clones:
    # simpler: propagate with cov = I and zero noise -> P'[0:15,15:] = Phi @ I[...] = 0.
    # Use direct recompute: perturbation linearization should match to O(dt^2).
    zero_noise = NoiseManager(sigma_w=0.0, sigma_wb=0.0, sigma_a=0.0, sigma_ab=0.0)
    ns_zn, _ = propagate_mean_cov(s_eye, layout, t, w, a, zero_noise, GRAVITY)
    PhiPhiT = np.asarray(ns_zn.cov)[:15, :15]
    # the closed-form discrete F differs from the exact RK4 Jacobian at
    # O(dt^2) (same as the reference); tolerance sized accordingly
    np.testing.assert_allclose(PhiPhiT, Phi_num @ Phi_num.T, rtol=2e-3, atol=5e-4)


def test_clone_and_marginalize():
    layout = make_layout()
    s = random_state(layout)
    s = s.replace(time=jnp.asarray(1.5))
    s2 = augment_clone(s, layout, jnp.zeros(3))
    assert int(s2.clone_head) == 0
    assert bool(s2.clones_valid[0])
    np.testing.assert_allclose(np.asarray(s2.clones_q[0]), np.asarray(s.q))
    # clone covariance block == imu pose block
    off = layout.clone_off
    P = np.asarray(s2.cov)
    pose_idx = np.r_[0:6]
    np.testing.assert_allclose(
        P[np.ix_(pose_idx, pose_idx)], P[off : off + 6, off : off + 6], atol=1e-12
    )
    np.testing.assert_allclose(
        P[np.ix_(pose_idx, pose_idx)],
        np.asarray(s.cov)[np.ix_(pose_idx, pose_idx)],
        atol=1e-12,
    )
    # marginalize zeroes the slot
    s3 = marginalize_clone(s2, layout, jnp.int32(0))
    assert not bool(s3.clones_valid[0])
    P3 = np.asarray(s3.cov)
    np.testing.assert_allclose(P3[off : off + 6, :], 0.0, atol=0)
    np.testing.assert_allclose(P3[:, off : off + 6], 0.0, atol=0)


def test_ring_buffer_wraparound():
    layout = make_layout(max_clones=3)
    s = random_state(layout)
    for i in range(3):
        s = s.replace(time=jnp.asarray(float(i)))
        s = augment_clone(s, layout, jnp.zeros(3))
    assert int(s.clone_head) == 2
    assert np.all(np.asarray(s.clones_valid))
    # marginalize oldest (slot 0), clone again -> reuses slot 0
    s = marginalize_clone(s, layout, jnp.int32(0))
    s = s.replace(time=jnp.asarray(3.0))
    s = augment_clone(s, layout, jnp.zeros(3))
    assert int(s.clone_head) == 0
    np.testing.assert_allclose(float(s.clones_t[0]), 3.0)


def test_ekf_update_reduces_uncertainty():
    layout = make_layout()
    s = random_state(layout)
    D = layout.dim
    # direct measurement of imu position
    H = jnp.zeros((6, D))
    H = H.at[0:3, 3:6].set(jnp.eye(3))
    res = jnp.asarray([0.1, -0.05, 0.2, 0.0, 0.0, 0.0])
    r_diag = jnp.full((6,), 0.01)
    mask = jnp.asarray([True, True, True, False, False, False])
    ns, diag = ekf_update(s, layout, H, res, r_diag, mask)
    assert bool(diag["cov_ok"])
    P0 = np.asarray(s.cov)
    P1 = np.asarray(ns.cov)
    assert np.trace(P1) < np.trace(P0)
    # masked rows must not have any effect: compare with 3-row update
    ns2, _ = ekf_update(s, layout, H[:3], res[:3], r_diag[:3], mask[:3])
    np.testing.assert_allclose(P1, np.asarray(ns2.cov), atol=1e-12)
    np.testing.assert_allclose(np.asarray(ns.p), np.asarray(ns2.p), atol=1e-12)


def test_ekf_update_matches_kf_formula():
    layout = make_layout()
    s = random_state(layout)
    D = layout.dim
    Hnp = RNG.normal(size=(4, D)) * 0.5
    res = RNG.normal(size=4)
    r_diag = np.full(4, 0.04)
    ns, _ = ekf_update(
        s, layout, jnp.asarray(Hnp), jnp.asarray(res), jnp.asarray(r_diag), jnp.ones(4, bool)
    )
    P = np.asarray(s.cov)
    S = Hnp @ P @ Hnp.T + np.diag(r_diag)
    K = P @ Hnp.T @ np.linalg.inv(S)
    P_expect = P - K @ Hnp @ P
    np.testing.assert_allclose(np.asarray(ns.cov), 0.5 * (P_expect + P_expect.T), atol=1e-9)
    dx = K @ res
    np.testing.assert_allclose(np.asarray(ns.p), np.asarray(s.p) + dx[3:6], atol=1e-9)
    # quaternion boxplus
    dq = quat_norm(jnp.asarray([dx[0] / 2, dx[1] / 2, dx[2] / 2, 1.0]))
    q_expect = quat_multiply(dq, s.q)
    np.testing.assert_allclose(np.asarray(ns.q), np.asarray(q_expect), atol=1e-9)


def test_fej_freezes_linearization():
    """After an update, value != fej; the next propagation must linearize
    at fej. We verify fej stays untouched by inject."""
    layout = make_layout()
    s = random_state(layout)
    dx = jnp.asarray(RNG.normal(size=layout.dim) * 0.01)
    s2 = inject(s, layout, dx)
    np.testing.assert_allclose(np.asarray(s2.q_fej), np.asarray(s.q_fej))
    np.testing.assert_allclose(np.asarray(s2.p_fej), np.asarray(s.p_fej))
    assert not np.allclose(np.asarray(s2.q), np.asarray(s.q))


def test_select_imu_readings():
    times = np.arange(0, 1.0, 0.01)
    ws = RNG.normal(size=(100, 3))
    accs = RNG.normal(size=(100, 3))
    t, w, a = select_imu_readings_np(times, ws, accs, 0.123, 0.217, 16)
    assert t[0] == 0.123 and t.max() == 0.217
    real = np.sum(np.diff(t) > 0) + 1
    assert real == 2 + 9  # boundaries + interior samples
    # interpolation at boundary
    lam = (0.123 - 0.12) / 0.01
    np.testing.assert_allclose(w[0], (1 - lam) * ws[12] + lam * ws[13], atol=1e-12)


def test_native_select_imu_matches_numpy():
    """The C++ native IMU slicer must match the numpy specification
    bit-for-bit (same interpolation in f64)."""
    from uvio_jax.native import select_imu_readings as native_fn

    times = np.arange(0, 1.0, 0.01)
    ws = RNG.normal(size=(100, 3))
    accs = RNG.normal(size=(100, 3))
    out_n = native_fn(times, ws, accs, 0.123, 0.217, 16)
    if out_n is None:
        import pytest

        pytest.skip("native toolchain unavailable")
    # numpy reference (the fallback body)
    import uvio_jax.native as nat

    saved = nat.select_imu_readings
    nat.select_imu_readings = lambda *a, **k: None  # force fallback
    try:
        out_p = select_imu_readings_np(times, ws, accs, 0.123, 0.217, 16)
    finally:
        nat.select_imu_readings = saved
    for a, b in zip(out_n, out_p):
        np.testing.assert_array_equal(a, b)
    # error paths agree
    import pytest

    with pytest.raises(AssertionError):
        native_fn(times, ws, accs, 0.5, 0.4, 16)
    with pytest.raises(ValueError):
        native_fn(times, ws, accs, 0.0, 0.9, 8)
