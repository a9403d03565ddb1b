"""Config loader tests against the reference's shipped config dirs."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from uvio_jax.math import quat_to_rot
from uvio_jax.utils import load_config

REF = "/root/reference/config"


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference configs not mounted")
def test_load_euroc():
    cfg, extras = load_config(os.path.join(REF, "euroc_mav"))
    assert cfg.max_clones == 11
    assert cfg.max_slam == 50
    assert cfg.calib_cam_pose and cfg.calib_cam_intrinsics and cfg.calib_cam_timeoffset
    assert len(cfg.cameras) == 2
    cam0 = cfg.cameras[0]
    np.testing.assert_allclose(cam0.intrinsics[:4], [458.654, 457.296, 367.215, 248.375])
    # T_imu_cam round trip: R_ItoC R_CtoI = I and p math consistent
    R_ItoC = np.asarray(quat_to_rot(jnp.asarray(cam0.q_ItoC)))
    T = np.array(
        [
            [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
            [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
            [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
        ]
    )
    np.testing.assert_allclose(R_ItoC, T[:3, :3].T, atol=1e-6)
    np.testing.assert_allclose(cam0.p_IinC, -T[:3, :3].T @ T[:3, 3], atol=1e-9)
    assert cfg.noises.sigma_w == pytest.approx(1.6968e-4)
    assert extras["num_pts"] == 200
    assert extras["use_stereo"] is True


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference configs not mounted")
def test_load_uvio():
    from uvio_jax.uwb_manager import UVioConfig

    cfg, extras = load_config(os.path.join(REF, "iros_2023_uvio"))
    assert isinstance(cfg, UVioConfig)
    np.testing.assert_allclose(cfg.p_IinU, [-0.01, 0.01, 0.05])  # -p_UinI
    assert cfg.sigma_range == pytest.approx(0.5)
    assert cfg.min_dist_to_use_uwb == pytest.approx(0.5)


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference configs not mounted")
def test_load_tumvi_fisheye():
    from uvio_jax.cam import EQUI

    cfg, extras = load_config(os.path.join(REF, "tum_vi"))
    assert cfg.cameras[0].model == EQUI


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference configs not mounted")
def test_manager_builds_from_each_config():
    from uvio_jax.manager import VioManager
    from uvio_jax.uwb_manager import UVioConfig, UVioManager

    for name in ["euroc_mav", "iros_2023_uvio"]:
        cfg, _ = load_config(os.path.join(REF, name))
        # cap state sizes for test speed
        import dataclasses

        cfg = dataclasses.replace(cfg, max_slam=min(cfg.max_slam, 5), max_clones=5)
        mgr = UVioManager(cfg) if isinstance(cfg, UVioConfig) else VioManager(cfg)
        assert mgr.layout.dim > 15


@pytest.mark.slow
@pytest.mark.skipif(not os.path.isdir(REF), reason="reference configs not mounted")
def test_euroc_config_end_to_end_sim():
    """Integration: the real EuRoC stereo calibration (radtan distortion,
    11 cm baseline, noise densities) loaded from the reference's config
    directory drives the full estimator on simulated data."""
    import dataclasses

    import jax.numpy as jnp

    from uvio_jax.eval import ate
    from uvio_jax.manager import VioManager
    from uvio_jax.sim import SimCamera, SimParams, Simulator, circle_trajectory

    cfg, extras = load_config(os.path.join(REF, "euroc_mav"))
    # shrink state sizes for test runtime; keep the real calibration
    cfg = dataclasses.replace(
        cfg, max_clones=8, max_slam=0, max_msckf_in_update=30,
        calib_cam_pose=False, calib_cam_intrinsics=False, calib_cam_timeoffset=False,
    )
    sim_cams = [
        SimCamera(
            model=c.model, intrinsics=np.asarray(c.intrinsics),
            q_ItoC=np.asarray(c.q_ItoC), p_IinC=np.asarray(c.p_IinC),
        )
        for c in cfg.cameras
    ]
    sim = Simulator(
        SimParams(seed=17, cameras=sim_cams, sigma_pix=1.0,
                  sigma_w=cfg.noises.sigma_w, sigma_wb=cfg.noises.sigma_wb,
                  sigma_a=cfg.noises.sigma_a, sigma_ab=cfg.noises.sigma_ab),
        trajectory=circle_trajectory(duration=14.0),
    )
    mgr = VioManager(cfg)
    g0 = sim.get_gt_state(sim.t_start)
    mgr.initialize_with_gt(
        sim.t_start, g0["q_GtoI"], g0["p_IinG"], g0["v_IinG"], g0["bg"], g0["ba"]
    )
    est = {"t": [], "q": [], "p": []}
    gts = {"q": [], "p": []}
    while sim.ok():
        r = sim.get_next_imu()
        if r is None:
            break
        t, wm, am = r
        mgr.feed_imu(t, wm, am)
        if sim.cur_cam_t + 0.1 <= t:
            rc = sim.get_next_cam()
            if rc is None:
                break
            tc, obs = rc
            mgr.feed_features(tc, obs)
            est["t"].append(tc)
            est["q"].append(np.asarray(mgr.state.q))
            est["p"].append(np.asarray(mgr.state.p))
            g = sim.get_gt_state(tc)
            gts["q"].append(g["q_GtoI"])
            gts["p"].append(g["p_IinG"])
        if est["t"] and est["t"][-1] - sim.t_start > 8:
            break
    res = ate(
        np.asarray(est["t"]), np.asarray(est["q"]), np.asarray(est["p"]),
        np.asarray(est["t"]), np.asarray(gts["q"]), np.asarray(gts["p"]),
        method="none",
    )
    # stereo with real calibration: metric scale observable
    assert res["rmse_pos"] < 0.10, res["rmse_pos"]


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference configs not mounted")
def test_dyn_init_options_parsed():
    """The init_dyn_* knob block (`InertialInitializerOptions.h:64-116`)
    must reach DynamicInitOptions (euroc_mav estimator_config.yaml sets
    mle_max_iter=50, inflation_vel=100, min_rec_cond=1e-12)."""
    cfg, _ = load_config(os.path.join(REF, "euroc_mav"))
    d = cfg.dyn_init_options
    assert d is not None
    assert d.gn_iters == 50
    assert d.num_pose == 6
    assert d.min_deg == pytest.approx(10.0)
    assert d.inflation_ori == pytest.approx(10.0)
    assert d.inflation_vel == pytest.approx(100.0)
    assert d.inflation_bg == pytest.approx(10.0)
    assert d.inflation_ba == pytest.approx(100.0)
    assert d.min_rec_cond == pytest.approx(1e-12)
    np.testing.assert_allclose(d.init_bias_g, 0.0)
    assert d.mle_opt_calib is False


_STREAM_CONFIGS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "streams"
)


@pytest.mark.parametrize(
    "rel",
    sorted(
        os.path.join(s, "config", f)
        for s in ("mono", "stereo", "uwb")
        for f in os.listdir(os.path.join(_STREAM_CONFIGS, s, "config"))
    ),
)
def test_yaml_subset_matches_pyyaml(rel):
    """Every vendored config file parses as PyYAML's safe loader reads
    it (after dropping the OpenCV `%YAML:1.0` directive, which PyYAML
    rejects); where PyYAML is absent, spot values are checked."""
    from uvio_jax.utils.config import parse_yaml

    with open(os.path.join(_STREAM_CONFIGS, rel)) as f:
        text = f.read()
    got = parse_yaml(text)
    assert isinstance(got, dict) and got
    try:
        import yaml
    except ImportError:
        yaml = None
    if yaml is not None:
        body = "\n".join(l for l in text.splitlines() if not l.startswith("%YAML"))
        assert got == yaml.safe_load(body)
    name = os.path.basename(rel)
    if name == "estimator_config.yaml":
        assert got["max_clones"] == 11 and got["use_fej"] is True
        assert got["init_dyn_min_rec_cond"] == "1e-15"  # YAML 1.1: no dot, a string
        assert got["init_dyn_bias_g"] == [0.0, 0.0, 0.0]
    elif name == "kalibr_imu_chain.yaml":
        assert got["imu0"]["Tw"] == [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
        assert got["imu0"]["gyroscope_noise_density"] == pytest.approx(1.6968e-4)
    elif name == "kalibr_imucam_chain.yaml":
        assert got["cam0"]["resolution"] == [752, 480]
        assert len(got["cam0"]["T_imu_cam"]) == 4
    elif name == "uwb_anchors.yaml":
        assert got["anchor1"]["p_AinG"] == [-12.62, 2.24, 2.62]
    elif name == "uwb_config.yaml":
        assert got["tag0"]["calib_uwb_extrinsics"] is True


def test_yaml_subset_constructs():
    from uvio_jax.utils.config import parse_yaml

    text = (
        "%YAML:1.0 # directive\n"
        "---\n"
        "a: 1 # int\n"
        "b: -2.5e+3\n"
        "c: 'it''s # not a comment'\n"
        'd: "x: y"\n'
        "e: [[1, 2], [3, 4.0], []]\n"
        "f:\n"
        "- 7\n"
        "-\n"
        "  k: v\n"
        "g:\n"
        "  h: ~\n"
        "  i: off\n"
        "  j:\n"
        "empty:\n"
    )
    assert parse_yaml(text) == {
        "a": 1, "b": -2500.0, "c": "it's # not a comment", "d": "x: y",
        "e": [[1, 2], [3, 4.0], []], "f": [7, {"k": "v"}],
        "g": {"h": None, "i": False, "j": None}, "empty": None,
    }
    assert parse_yaml("# only a comment\n") is None
    for bad in ("a: [1, 2\n", "a: 1\n  b: 2\n", "- x: 1\n", "a: 1\nfoo\n"):
        with pytest.raises(ValueError):
            parse_yaml(bad)
