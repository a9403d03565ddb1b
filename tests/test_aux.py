"""Auxiliary subsystems: leveled logging, calibration perturbation,
1D triangulation, checkpoint/resume."""

import numpy as np
import pytest

import jax.numpy as jnp


def test_logger_levels(capsys):
    from uvio_jax.utils import logger

    old = logger.get_verbosity()
    try:
        logger.set_verbosity("WARNING")
        logger.print_info("hidden %d", 1)
        logger.print_warning("shown %d", 2)
        out = capsys.readouterr()
        assert "hidden" not in out.out + out.err
        assert "shown 2" in out.err
        logger.set_verbosity("DEBUG")
        logger.print_debug("dbg")
        out = capsys.readouterr()
        assert "test_aux.py" in out.out  # file:line prefix at DEBUG
        with pytest.raises(ValueError):
            logger.set_verbosity("BOGUS")
    finally:
        logger.set_verbosity(old)


def test_perturb_calibration():
    from uvio_jax.manager import CameraConfig, VioConfig
    from uvio_jax.sim import perturb_calibration

    cfg = VioConfig(
        cameras=[CameraConfig()], calib_imu_intrinsics=True, calib_imu_g_sensitivity=True
    )
    pert = perturb_calibration(cfg, seed=3)
    assert pert is not cfg
    # reference std-devs: focal ~1 px, extrinsic pos ~0.01 m, dt ~0.01 s
    d_intr = np.abs(pert.cameras[0].intrinsics - cfg.cameras[0].intrinsics)
    assert 0 < d_intr[:4].max() < 6.0
    assert 0 < d_intr[4:].max() < 0.05
    assert 0 < np.abs(pert.cameras[0].p_IinC).max() < 0.06
    assert 0 < abs(pert.camimu_dt) < 0.06
    assert pert.imu_dw is not None and 0 < np.abs(
        pert.imu_dw - [1, 0, 0, 1, 0, 1]
    ).max() < 0.03
    assert pert.imu_tg is not None and 0 < np.abs(pert.imu_tg).max() < 0.03
    # quaternion stays unit
    assert abs(np.linalg.norm(pert.cameras[0].q_ItoC) - 1) < 1e-9
    # original untouched
    assert np.all(cfg.cameras[0].p_IinC == 0)


def test_triangulate_1d():
    """Depth-only solve recovers a point when bearings are exact."""
    from uvio_jax.math import quat_to_rot
    from uvio_jax.update.triangulation import triangulate_1d, triangulate_linear

    rng = np.random.default_rng(1)
    p_true = np.array([0.5, -0.3, 4.0])
    M = 6
    p_C = np.concatenate([rng.uniform(-1, 1, (M, 2)), np.zeros((M, 1))], axis=1)
    R = np.tile(np.eye(3), (M, 1, 1))
    rel = p_true[None] - p_C
    uvn = rel[:, :2] / rel[:, 2:3]
    mask = np.ones(M, bool)
    p_est, ok = triangulate_1d(
        jnp.asarray(uvn), jnp.asarray(mask), jnp.asarray(R), jnp.asarray(p_C)
    )
    assert bool(ok)
    # the anchor-ray constraint recovers the point exactly here because
    # the last camera's bearing passes through p_true
    assert np.linalg.norm(np.asarray(p_est) - p_true) < 1e-6
    # masked/degenerate: single obs -> not ok
    m1 = np.zeros(M, bool)
    m1[0] = True
    _, ok1 = triangulate_1d(
        jnp.asarray(uvn), jnp.asarray(m1), jnp.asarray(R), jnp.asarray(p_C)
    )
    assert not bool(ok1)


def test_checkpoint_roundtrip(tmp_path):
    from uvio_jax.manager import CameraConfig, VioConfig, VioManager
    from uvio_jax.sim import SimParams, Simulator, circle_trajectory

    sim = Simulator(SimParams(seed=2), trajectory=circle_trajectory(duration=10.0))
    cam = sim.params.cameras[0]
    cfg = VioConfig(
        max_clones=5,
        cameras=[CameraConfig(model=cam.model, intrinsics=cam.intrinsics,
                              q_ItoC=cam.q_ItoC, p_IinC=cam.p_IinC)],
    )
    mgr = VioManager(cfg)
    g0 = sim.get_gt_state(sim.t_start)
    mgr.initialize_with_gt(
        sim.t_start, g0["q_GtoI"], g0["p_IinG"], g0["v_IinG"], g0["bg"], g0["ba"]
    )
    frames = 0
    while sim.ok() and frames < 12:
        r = sim.get_next_imu()
        if r is None:
            break
        t, wm, am = r
        mgr.feed_imu(t, wm, am)
        if sim.cur_cam_t + 0.1 <= t:
            rc = sim.get_next_cam()
            if rc is None:
                break
            mgr.feed_features(*rc)
            frames += 1

    path = str(tmp_path / "ckpt.npz")
    mgr.save_checkpoint(path)

    mgr2 = VioManager(cfg)
    mgr2.load_checkpoint(path)
    assert np.allclose(np.asarray(mgr2.state.q), np.asarray(mgr.state.q))
    assert np.allclose(np.asarray(mgr2.state.cov), np.asarray(mgr.state.cov))
    assert mgr2.slot_times == mgr.slot_times
    assert mgr2.is_initialized

    # both managers must evolve identically on the same future inputs
    for _ in range(2):
        while True:
            r = sim.get_next_imu()
            if r is None:
                break
            t, wm, am = r
            mgr.feed_imu(t, wm, am)
            mgr2.feed_imu(t, wm, am)
            if sim.cur_cam_t + 0.1 <= t:
                rc = sim.get_next_cam()
                if rc is None:
                    break
                mgr.feed_features(*rc)
                mgr2.feed_features(*rc)
                break
    assert np.allclose(np.asarray(mgr2.state.p), np.asarray(mgr.state.p), atol=1e-9)


def test_native_csv_loader(tmp_path):
    """Native CSV parser matches the python reader on numeric files."""
    from uvio_jax.native import load_csv

    p = tmp_path / "data.csv"
    p.write_text(
        "#timestamp [ns],w_x,w_y,w_z\n"
        "1403636579758555392,0.1,-0.2,0.3\n"
        "1403636579763555584, 0.4, 0.5, -0.6\n"
        "\n"
        "1403636579768555776,0.7,0.8,0.9\n"
    )
    arr = load_csv(str(p))
    if arr is None:
        pytest.skip("native toolchain unavailable")
    assert arr.shape == (3, 4)
    np.testing.assert_allclose(arr[1, 1:], [0.4, 0.5, -0.6])
    # TUM-style whitespace-separated file
    p2 = tmp_path / "gt.txt"
    p2.write_text("# ts x y z\n1.5 0.1 0.2 0.3\n2.5 0.4 0.5 0.6\n")
    arr2 = load_csv(str(p2))
    assert arr2.shape == (2, 4)
    np.testing.assert_allclose(arr2[0], [1.5, 0.1, 0.2, 0.3])
    with pytest.raises(FileNotFoundError):
        load_csv(str(tmp_path / "missing.csv"))


@pytest.mark.slow
def test_get_active_tracks():
    """retriangulate_active_tracks equivalent: active features map near
    their true 3D positions."""
    from uvio_jax.manager import CameraConfig, VioConfig, VioManager
    from uvio_jax.sim import SimParams, Simulator, circle_trajectory

    sim = Simulator(SimParams(seed=4, num_pts=40), trajectory=circle_trajectory(duration=10.0))
    cam = sim.params.cameras[0]
    cfg = VioConfig(
        max_clones=8, max_slam=6, sigma_pix=sim.params.sigma_pix,
        cameras=[CameraConfig(model=cam.model, intrinsics=cam.intrinsics,
                              q_ItoC=cam.q_ItoC, p_IinC=cam.p_IinC)],
    )
    mgr = VioManager(cfg)
    g0 = sim.get_gt_state(sim.t_start)
    mgr.initialize_with_gt(
        sim.t_start, g0["q_GtoI"], g0["p_IinG"], g0["v_IinG"], g0["bg"], g0["ba"]
    )
    frames = 0
    while sim.ok() and frames < 25:
        r = sim.get_next_imu()
        if r is None:
            break
        t, wm, am = r
        mgr.feed_imu(t, wm, am)
        if sim.cur_cam_t + 0.1 <= t:
            rc = sim.get_next_cam()
            if rc is None:
                break
            mgr.feed_features(*rc)
            frames += 1
    ids, pts = mgr.get_active_tracks()
    assert len(ids) >= 5
    errs = [np.linalg.norm(pts[i] - sim.map_pts[int(ids[i])]) for i in range(len(ids))
            if int(ids[i]) < len(sim.map_pts)]
    assert np.median(errs) < 0.6, np.median(errs)  # viz-grade accuracy incl. drift


def test_matmul_precision_contract():
    """The EKF covariance algebra requires full-precision f32 matmuls. On
    an NVIDIA GPU an f32 matmul may run in TF32 (about three decimal
    digits), which breaks positive definiteness of P within seconds of
    filtering. uvio_jax/__init__.py pins the global default to 'highest';
    this guards the pin (the failure itself needs a GPU to reproduce)."""
    import jax

    import uvio_jax  # noqa: F401

    assert jax.config.jax_default_matmul_precision == "highest"
    assert jax.config.jax_enable_x64 is True


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_dir_rule(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX; otherwise the
    cache sits at <checkout>/.jax_cache (fresh interpreter: the rule runs
    at import)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo
    want = os.path.join(repo, ".jax_cache")
    if env_dir is not None:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, uvio_jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == want


def test_filter_state_pytree():
    """FilterState: one leaf per field, a jit round trip keeps values and
    dtypes, `.replace` copies without mutating."""
    import dataclasses

    import jax

    from uvio_jax.types import StateLayout, init_state

    layout = StateLayout(max_clones=3, max_imu_batch=8, max_slam=2, max_anchors=1)
    st = init_state(layout, dtype=jnp.float32)
    leaves, treedef = jax.tree.flatten(st)
    assert len(leaves) == len(dataclasses.fields(st))
    back = jax.jit(lambda s: s)(st)
    assert jax.tree.structure(back) == treedef
    for a, b in zip(leaves, jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))
    assert st.time.dtype == jnp.float64 and st.p.dtype == jnp.float32

    st2 = jax.jit(lambda s: s.replace(p=s.p + 1.0))(st)
    np.testing.assert_array_equal(np.asarray(st2.p), np.ones(3))
    np.testing.assert_array_equal(np.asarray(st.p), np.zeros(3))
    with pytest.raises(dataclasses.FrozenInstanceError):
        st.p = st2.p
