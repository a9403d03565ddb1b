"""Static initializer and zero-velocity update tests."""

import jax.numpy as jnp
import numpy as np
from scipy.spatial.transform import Rotation as Rsp

from uvio_jax.filter import NoiseManager
from uvio_jax.init import StaticInitOptions, try_static_init
from uvio_jax.math import quat_to_rot, rot_to_quat
from uvio_jax.types import StateLayout, init_state
from uvio_jax.update.zupt import zupt_try_update

RNG = np.random.default_rng(11)
G = 9.81


def stationary_imu(n, R_GtoI, bg, ba, noise_w=1e-4, noise_a=1e-3, hz=200.0):
    t = np.arange(n) / hz
    gravity = np.array([0, 0, G])
    w = bg + noise_w * RNG.standard_normal((n, 3))
    a = (R_GtoI @ gravity) + ba + noise_a * RNG.standard_normal((n, 3))
    return t, w, a[None].repeat(1, axis=0).reshape(n, 3) if a.ndim == 1 else a


def test_static_init_recovers_gravity_and_biases():
    R_true = Rsp.from_euler("xyz", [12, -7, 33], degrees=True).as_matrix()
    R_GtoI = R_true
    bg = np.array([0.002, -0.001, 0.0015])
    ba = np.array([0.01, 0.02, -0.015])
    hz = 200.0
    n_still = int(4.2 * hz)
    t, w, a = stationary_imu(n_still, R_GtoI, bg, ba, hz=hz)
    # jerk at the end
    n_jerk = int(0.8 * hz)
    tj = t[-1] + (np.arange(1, n_jerk + 1)) / hz
    wj = bg + 0.5 * RNG.standard_normal((n_jerk, 3))
    aj = (R_GtoI @ np.array([0, 0, G])) + ba + 4.0 * RNG.standard_normal((n_jerk, 3))
    t = np.concatenate([t, tj])
    w = np.concatenate([w, wj])
    a = np.concatenate([a, aj])

    res = try_static_init(t, w, a, StaticInitOptions(window_time=2.0, imu_thresh=1.5))
    assert res is not None
    # gravity direction must match: R_est^T e3 should equal R_true^T e3
    R_est = np.asarray(quat_to_rot(jnp.asarray(res.q_GtoI)))
    g_est = R_est @ np.array([0, 0, 1.0])
    g_true = R_true @ np.array([0, 0, 1.0])
    np.testing.assert_allclose(g_est, g_true, atol=5e-3)
    np.testing.assert_allclose(res.bg, bg, atol=5e-4)
    # ba observable only in the gravity-orthogonal complement... the
    # reference recovers the full ba assuming perfect gravity alignment
    assert np.linalg.norm(res.ba - ba) < 0.05


def test_static_init_rejects_motion():
    t = np.arange(0, 5.0, 0.005)
    w = 0.5 * RNG.standard_normal((len(t), 3))
    a = np.array([0, 0, G]) + 3.0 * RNG.standard_normal((len(t), 3))
    res = try_static_init(t, w, a, StaticInitOptions())
    assert res is None


def test_static_init_waits_for_jerk():
    R = np.eye(3)
    t, w, a = stationary_imu(int(5 * 200), R, np.zeros(3), np.zeros(3))
    res = try_static_init(t, w, a, StaticInitOptions(wait_for_jerk=True))
    assert res is None  # still, but no jerk yet
    res2 = try_static_init(t, w, a, StaticInitOptions(wait_for_jerk=False))
    assert res2 is not None


def _make_state(layout, R_GtoI, bg, ba, v=None):
    s = init_state(layout)
    q = rot_to_quat(jnp.asarray(R_GtoI))
    s = s.replace(
        q=q, q_fej=q,
        bg=jnp.asarray(bg), ba=jnp.asarray(ba),
        v=jnp.asarray(v if v is not None else np.zeros(3)),
        time=jnp.asarray(0.0),
        cov=jnp.asarray(np.eye(layout.dim) * 1e-3),
    )
    return s


def test_zupt_accepts_stationary_rejects_moving():
    layout = StateLayout(max_clones=4, max_imu_batch=16)
    R = Rsp.from_euler("xyz", [5, 3, 0], degrees=True).as_matrix()
    bg = np.array([0.001, 0.0, -0.002])
    ba = np.zeros(3)
    t, w, a = stationary_imu(16, R, bg, ba)
    s = _make_state(layout, R, bg, ba)
    ns, acc, gamma = zupt_try_update(
        s, layout, jnp.asarray(t), jnp.asarray(w), jnp.asarray(a),
        NoiseManager(), G, noise_mult=10.0,
    )
    assert bool(acc), float(gamma)
    assert float(ns.time) == t[-1]

    # strong rotation -> reject
    w2 = w + np.array([1.5, 0, 0])
    ns2, acc2, _ = zupt_try_update(
        s, layout, jnp.asarray(t), jnp.asarray(w2), jnp.asarray(a),
        NoiseManager(), G, noise_mult=10.0,
    )
    assert not bool(acc2)
    assert float(ns2.time) == 0.0  # untouched

    # fast velocity estimate -> reject even if IMU still
    s3 = _make_state(layout, R, bg, ba, v=np.array([1.0, 0, 0]))
    _, acc3, _ = zupt_try_update(
        s3, layout, jnp.asarray(t), jnp.asarray(w), jnp.asarray(a),
        NoiseManager(), G, noise_mult=10.0,
    )
    assert not bool(acc3)


def test_zupt_reduces_bias_uncertainty():
    layout = StateLayout(max_clones=4, max_imu_batch=16)
    R = np.eye(3)
    t, w, a = stationary_imu(16, R, np.zeros(3), np.zeros(3))
    s = _make_state(layout, R, np.zeros(3), np.zeros(3))
    ns, acc, _ = zupt_try_update(
        s, layout, jnp.asarray(t), jnp.asarray(w), jnp.asarray(a),
        NoiseManager(), G,
    )
    assert bool(acc)
    P0 = np.asarray(s.cov)
    P1 = np.asarray(ns.cov)
    assert np.trace(P1[9:15, 9:15]) < np.trace(P0[9:15, 9:15])
    # position cols untouched (no position info in ZUPT)
    np.testing.assert_allclose(P1[3:6, 3:6], P0[3:6, 3:6], atol=1e-12)


def test_zupt_explicit_constrains_to_clone():
    """Explicit zero-motion variant (`UpdaterZeroVelocity.cpp:283-330`):
    on accept, the propagated IMU pose is pulled toward the newest clone
    and the velocity toward zero."""
    from uvio_jax.update.zupt import zupt_explicit_update

    layout = StateLayout(max_clones=4, max_imu_batch=16)
    R = Rsp.from_euler("xyz", [5, 3, 0], degrees=True).as_matrix()
    bg = np.zeros(3)
    ba = np.zeros(3)
    t, w, a = stationary_imu(16, R, bg, ba)
    s = _make_state(layout, R, bg, ba, v=np.array([0.02, -0.01, 0.0]))
    # uncertain pose/velocity prior so the (soft, sigma_pos=0.1 m)
    # constraint dominates; biases stay tight so the chi2 gate still
    # rejects a gyro offset as motion rather than absorbing it as bias
    diag = np.full(layout.dim, 1e-3)
    diag[0:9] = 0.04  # theta, p, v
    diag[layout.clone_slot_off(0):layout.clone_slot_off(0) + 6] = 0.04
    diag[9:15] = 1e-5  # bg, ba
    s = s.replace(cov=jnp.asarray(np.diag(diag)))
    # a clone at the true stationary pose; the IMU mean has drifted 5 cm
    q = rot_to_quat(jnp.asarray(R))
    p_clone = np.array([1.0, 2.0, 0.5])
    s = s.replace(
        p=jnp.asarray(p_clone + np.array([0.05, -0.04, 0.03])),
        clones_q=s.clones_q.at[0].set(q),
        clones_p=s.clones_p.at[0].set(jnp.asarray(p_clone)),
        clones_q_fej=s.clones_q_fej.at[0].set(q),
        clones_p_fej=s.clones_p_fej.at[0].set(jnp.asarray(p_clone)),
        clones_t=s.clones_t.at[0].set(0.0),
        clones_valid=s.clones_valid.at[0].set(True),
        clone_head=jnp.asarray(0, jnp.int32),
    )
    gap0 = np.linalg.norm(np.asarray(s.p) - p_clone)
    ns, acc, gamma = zupt_explicit_update(
        s, layout, jnp.asarray(t), jnp.asarray(w), jnp.asarray(a),
        NoiseManager(), G, noise_mult=10.0,
        stamp_time=jnp.asarray(t[-1], jnp.float64),
    )
    assert bool(acc), float(gamma)
    assert float(ns.time) == t[-1]
    gap1 = np.linalg.norm(np.asarray(ns.p) - np.asarray(ns.clones_p[0]))
    assert gap1 < 0.3 * gap0, (gap0, gap1)
    assert np.linalg.norm(np.asarray(ns.v)) < 0.5 * np.linalg.norm(np.asarray(s.v))

    # moving IMU -> rejected, state untouched
    ns2, acc2, _ = zupt_explicit_update(
        s, layout, jnp.asarray(t), jnp.asarray(w + np.array([1.5, 0, 0])),
        jnp.asarray(a), NoiseManager(), G, noise_mult=10.0,
    )
    assert not bool(acc2)
    np.testing.assert_allclose(np.asarray(ns2.p), np.asarray(s.p))


def test_zupt_explicit_falls_back_without_clone():
    """No clone in the state yet -> the explicit variant applies the
    plain inertial update instead."""
    from uvio_jax.update.zupt import zupt_explicit_update

    layout = StateLayout(max_clones=4, max_imu_batch=16)
    R = np.eye(3)
    t, w, a = stationary_imu(16, R, np.zeros(3), np.zeros(3))
    s = _make_state(layout, R, np.zeros(3), np.zeros(3))
    ns, acc, _ = zupt_explicit_update(
        s, layout, jnp.asarray(t), jnp.asarray(w), jnp.asarray(a),
        NoiseManager(), G,
    )
    assert bool(acc)
    # inertial semantics: position block untouched
    np.testing.assert_allclose(
        np.asarray(ns.cov)[3:6, 3:6], np.asarray(s.cov)[3:6, 3:6], atol=1e-12
    )
    assert float(ns.time) == t[-1]
