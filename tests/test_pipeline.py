"""Host pipeline: double-buffered device staging."""

import numpy as np

import jax.numpy as jnp

from uvio_jax.pipeline import HostPipeline


def test_host_pipeline_order_and_content():
    chunks = [
        {"a": np.full((4,), i, np.float32), "b": np.arange(i, i + 3)} for i in range(7)
    ]
    out = list(HostPipeline(iter(chunks), depth=2))
    assert len(out) == 7
    for i, c in enumerate(out):
        assert isinstance(c["a"], jnp.ndarray)
        np.testing.assert_array_equal(np.asarray(c["a"]), np.full((4,), i, np.float32))
        np.testing.assert_array_equal(np.asarray(c["b"]), np.arange(i, i + 3))


def test_host_pipeline_overlaps_consumer():
    """Producer keeps staging while the consumer is slow."""
    import time

    def slow_chunks():
        for i in range(4):
            yield np.full((2,), i, np.float32)

    pipe = HostPipeline(slow_chunks(), depth=2)
    it = iter(pipe)
    first = next(it)
    time.sleep(0.05)  # producer should have prefetched the next chunks
    assert pipe._q.qsize() >= 1
    rest = list(it)
    assert len(rest) == 3
    np.testing.assert_array_equal(np.asarray(first), [0, 0])


def _tiny_vio(on_cov_fail):
    from uvio_jax.manager import CameraConfig, VioConfig, VioManager
    from uvio_jax.sim import SimParams, Simulator, circle_trajectory

    sim = Simulator(
        SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=30, seed=3),
        trajectory=circle_trajectory(duration=6.0),
    )
    cam = sim.params.cameras[0]
    cfg = VioConfig(
        max_clones=6,
        sigma_pix=sim.params.sigma_pix,
        on_cov_fail=on_cov_fail,
        cameras=[CameraConfig(model=cam.model, intrinsics=cam.intrinsics,
                              q_ItoC=cam.q_ItoC, p_IinC=cam.p_IinC)],
    )
    mgr = VioManager(cfg)
    g0 = sim.get_gt_state(sim.t_start)
    mgr.initialize_with_gt(
        sim.t_start, g0["q_GtoI"], g0["p_IinG"], g0["v_IinG"], g0["bg"], g0["ba"]
    )
    return sim, mgr


def _run_frames(sim, mgr, n):
    done = 0
    while sim.ok() and done < n:
        r = sim.get_next_imu()
        if r is None:
            break
        t, wm, am = r
        mgr.feed_imu(t, wm, am)
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= t:
            rc = sim.get_next_cam()
            if rc is None:
                break
            mgr.feed_features(*rc)
            done += 1
    return done


def test_cov_fail_raises_on_injected_nan():
    """A NaN covariance must be detected by the device-side cov_ok flag
    and raise (reference exits the process, `StateHelper.cpp:102-113`)."""
    import pytest

    from uvio_jax.manager import CovarianceError

    sim, mgr = _tiny_vio("raise")
    assert _run_frames(sim, mgr, 5) == 5
    bad = np.asarray(mgr.state.cov).copy()
    bad[0, 0] = np.nan
    mgr.state = mgr.state.replace(cov=jnp.asarray(bad))
    with pytest.raises(CovarianceError):
        _run_frames(sim, mgr, 3)


def test_cov_fail_warn_keeps_filtering():
    import warnings

    sim, mgr = _tiny_vio("warn")
    assert _run_frames(sim, mgr, 5) == 5
    bad = np.asarray(mgr.state.cov).copy()
    bad[0, 0] = -1.0
    mgr.state = mgr.state.replace(cov=jnp.asarray(bad))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _run_frames(sim, mgr, 2)
    assert any("covariance" in str(x.message) for x in w)
