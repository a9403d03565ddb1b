"""EuRoC folder reader test on a synthetic fixture."""

import os

import numpy as np
import pytest

from uvio_jax.utils.euroc import EurocDataset


def make_fixture(tmp_path):
    base = tmp_path / "seq" / "mav0"
    (base / "imu0").mkdir(parents=True)
    (base / "cam0" / "data").mkdir(parents=True)
    (base / "state_groundtruth_estimate0").mkdir(parents=True)
    with open(base / "imu0" / "data.csv", "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for i in range(10):
            f.write(f"{1403636579758555392 + i * 5_000_000},0.1,0.2,0.3,0.0,0.0,9.81\n")
    with open(base / "cam0" / "data.csv", "w") as f:
        f.write("#timestamp [ns],filename\n")
        f.write("1403636579763555584,1403636579763555584.png\n")
    with open(base / "state_groundtruth_estimate0" / "data.csv", "w") as f:
        f.write("#timestamp, p_RS_R_x ...\n")
        f.write(
            "1403636579758555392,4.68,-1.78,0.77,0.53,-0.15,-0.82,-0.16,"
            "-0.02,0.02,0.05,-0.002,0.021,0.076,-0.025,0.136,0.075\n"
        )
    return str(tmp_path / "seq")


def test_euroc_reader(tmp_path):
    root = make_fixture(tmp_path)
    ds = EurocDataset(root)
    imu = list(ds.imu())
    assert len(imu) == 10
    t0, w0, a0 = imu[0]
    np.testing.assert_allclose(t0, 1403636579.758555392, rtol=0, atol=1e-6)
    np.testing.assert_allclose(w0, [0.1, 0.2, 0.3])
    np.testing.assert_allclose(a0, [0.0, 0.0, 9.81])
    imgs = list(ds.images("cam0"))
    assert len(imgs) == 1 and imgs[0][1].endswith(".png")
    gt = ds.groundtruth()
    np.testing.assert_allclose(gt["p"][0], [4.68, -1.78, 0.77])
    # Hamilton (w,x,y,z) -> JPL (x,y,z,w)
    np.testing.assert_allclose(gt["q_GtoI"][0], [-0.15, -0.82, -0.16, 0.53])
    np.testing.assert_allclose(gt["bg"][0], [-0.002, 0.021, 0.076])


@pytest.mark.slow
def test_run_euroc_on_synthetic_dataset(tmp_path):
    """Execute the FULL `run_euroc` entrypoint (config dir -> ASL-format
    dataset -> KLT -> self-init filter -> TUM output) on a synthetic
    EuRoC-layout dataset rendered from the simulator — the committed
    stand-in for a real EuRoC download (none ships here)."""
    import shutil

    import cv2

    from uvio_jax.sim import SimParams, Simulator, circle_trajectory
    from uvio_jax.utils.euroc import EurocDataset, run_euroc

    # ---- render the dataset ------------------------------------------
    sim = Simulator(
        SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=90, seed=13),
        trajectory=circle_trajectory(duration=16.0, still_time=5.0),
    )
    cam = sim.params.cameras[0]
    base = tmp_path / "mav0"
    (base / "imu0").mkdir(parents=True)
    (base / "cam0" / "data").mkdir(parents=True)
    (base / "state_groundtruth_estimate0").mkdir(parents=True)

    imu_lines = ["#ts,wx,wy,wz,ax,ay,az"]
    gt_lines = ["#ts,px,py,pz,qw,qx,qy,qz,vx,vy,vz,bwx,bwy,bwz,bax,bay,baz"]
    cam_lines = ["#ts,filename"]
    while sim.ok():
        r = sim.get_next_imu()
        if r is None:
            break
        t, w, a = r
        ns = int(round(t * 1e9))
        imu_lines.append(
            f"{ns}," + ",".join(f"{x:.9f}" for x in np.concatenate([w, a]))
        )
        g = sim.get_gt_state(t)
        qj = g["q_GtoI"]  # JPL [x,y,z,w] -> Hamilton q_ItoG [w,x,y,z]
        row = np.concatenate(
            [g["p_IinG"], [qj[3], qj[0], qj[1], qj[2]], g["v_IinG"], g["bg"], g["ba"]]
        )
        gt_lines.append(f"{ns}," + ",".join(f"{x:.9f}" for x in row))
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= t:
            tc = sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam
            sim.cur_cam_t = tc
            ns_c = int(round(tc * 1e9))
            img = sim.render_image(tc)
            name = f"{ns_c}.png"
            cv2.imwrite(str(base / "cam0" / "data" / name), img.astype(np.uint8))
            cam_lines.append(f"{ns_c},{name}")
    (base / "imu0" / "data.csv").write_text("\n".join(imu_lines))
    (base / "cam0" / "data.csv").write_text("\n".join(cam_lines))
    (base / "state_groundtruth_estimate0" / "data.csv").write_text("\n".join(gt_lines))

    # ---- reference-style config dir ----------------------------------
    cfgdir = tmp_path / "config"
    cfgdir.mkdir()
    # vendored copy first; the reference mount is optional
    _vendor = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "data", "streams", "mono", "config",
    )
    for _src in (os.path.join(_vendor, "kalibr_imu_chain.yaml"),
                 "/root/reference/config/rpng_sim/kalibr_imu_chain.yaml"):
        if os.path.exists(_src):
            shutil.copy(_src, cfgdir)
            break
    if not (cfgdir / "kalibr_imu_chain.yaml").exists():
        pytest.skip("no kalibr chain available")
    fx, fy, cx, cy = cam.intrinsics[:4]
    (cfgdir / "kalibr_imucam_chain.yaml").write_text(f"""%YAML:1.0
cam0:
  T_imu_cam:
    - [1.0, 0.0, 0.0, 0.0]
    - [0.0, 1.0, 0.0, 0.0]
    - [0.0, 0.0, 1.0, 0.0]
    - [0.0, 0.0, 0.0, 1.0]
  camera_model: pinhole
  distortion_coeffs: [0.0, 0.0, 0.0, 0.0]
  distortion_model: radtan
  intrinsics: [{fx}, {fy}, {cx}, {cy}]
  resolution: [{cam.width}, {cam.height}]
  timeshift_cam_imu: 0.0
""")
    _est = os.path.join(_vendor, "estimator_config.yaml")
    if not os.path.exists(_est):
        _est = "/root/reference/config/rpng_sim/estimator_config.yaml"
    text = open(_est).read()
    import re as _re

    overrides = {
        "max_cameras": "1", "use_stereo": "false", "max_slam": "0",
        "max_msckf_in_update": "40",
        "calib_cam_extrinsics": "false", "calib_cam_intrinsics": "false",
        "calib_cam_timeoffset": "false", "calib_imu_intrinsics": "false",
        "calib_imu_g_sensitivity": "false", "try_zupt": "false",
        # the rendered trajectory ramps in smoothly: low jerk threshold
        "init_window_time": "2.0", "init_imu_thresh": "0.5",
        "init_wait_for_jerk": "false",
        "init_dyn_use": "false", "num_pts": "150",
        "up_msckf_sigma_px": "2.0",
        "feat_rep_msckf": '"GLOBAL_3D"',
    }
    for k, v in overrides.items():
        pat = _re.compile(rf"^{k}:.*$", _re.M)
        text = pat.sub(f"{k}: {v}", text) if pat.search(text) else text + f"\n{k}: {v}\n"
    (cfgdir / "estimator_config.yaml").write_text(text)

    # ---- run the entrypoint ------------------------------------------
    out = tmp_path / "est.txt"
    t, q, p = run_euroc(str(tmp_path), str(cfgdir), out_path=str(out))
    assert len(t) >= 25, len(t)
    assert out.exists()

    ds = EurocDataset(str(tmp_path))
    gt = ds.groundtruth()
    from uvio_jax.eval import ate

    res = ate(t, q, p, gt["t"], gt["q_GtoI"], gt["p"], method="posyaw")
    assert res["rmse_pos"] < 0.5, res
