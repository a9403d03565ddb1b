"""chip_smoke.py: its phases at tiny sizes on the CPU, its checks, the
contract line, and its refusal to run without a GPU. The `gpu`-marked
tests run P2 and P3 on the card."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


@pytest.fixture
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU, found {dev.platform}")
    return dev


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_main_refuses_without_gpu(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cs.main(argv)
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_contract_line_format():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = cs.contract_line(Dev(), 1)
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )
    assert json.loads(line)["device"]["count"] == 1


def test_run_live_replays_uwb_stream():
    m = cs.run_live()
    cs.check_live(m)
    assert m["frames"] > 400 and m["fps_steady"] > 0


def test_run_scan_tiny():
    m = cs.run_scan(n_warm=12, n_bench=4, max_slam=0)
    cs.check_scan(m)
    assert m["frames"] == 4 and m["msckf_rows_used"] == m["msckf_rows_used_ref"]


def test_compare_frontend_tiny():
    rng = np.random.default_rng(0)
    img_a = np.kron(rng.uniform(0, 255, (24, 32)), np.ones((4, 4))).astype(np.float32)
    img_b = np.roll(img_a, (1, 2), axis=(0, 1))
    uv = np.stack([rng.uniform(24, 104, 16), rng.uniform(24, 72, 16)], 1)
    m = cs.compare_frontend(img_a, img_b, uv, np.ones(16, bool), levels=2)
    assert m["lk_features"] == 16 and m["fast_corners"] > 0
    assert m["fast_max_abs"] == 0.0 and m["pyramid_max_abs"] == 0.0
    assert m["lk_kept_agreement"] == 1.0 and m["lk_p99_px"] == 0.0


def test_run_image_tiny():
    m = cs.run_image(n_frames=4)
    assert m["frames"] == 4 and m["resolution"] == "752x480"
    assert m["cov_ok"] and np.isfinite(m["pos_err_m"])
    assert m["lk_features"] > 0 and m["lk_kept_agreement"] == 1.0


def test_run_ba_tiny():
    m, (q, p, lm, costs) = cs.run_ba(n_kf=8, n_lm=64, iters=4)
    cs.check_ba(m)
    assert m["dtype"] == "float64" and lm.shape == (64, 3) and costs.shape == (4,)


def test_run_multi_step_on_virtual_devices():
    m = cs.run_multi_step(n_streams=4)
    cs.check_multi_step(m)
    assert m["devices"] == 4


def test_run_multi_ba_on_virtual_mesh():
    m = cs.run_multi_ba(n_kf=8, n_lm=64, iters=4)
    cs.check_multi_ba(m)


@pytest.mark.parametrize(
    "check,bad",
    [
        (cs.check_live, {"frames": 450, "cov_ok": True, "ate_pos_m": 0.2,
                         "ref_ate_pos_m": 0.1, "anchor_rms_m": 0.0, "ref_anchor_rms_m": 1.0}),
        (cs.check_scan, {"finite": True, "cov_diag_nonneg": True, "msckf_rows_used": 10,
                         "pos_m": 1.0, "ori_deg": 0.0, "cov_diag_rel": 0.0}),
        (cs.check_image, {"cov_ok": True, "num_tracks": 150, "used_total": 500,
                          "pos_err_m": 0.1, "fast_max_abs": 0.0, "pyramid_max_abs": 0.0,
                          "lk_kept_agreement": 0.5, "lk_p99_px": 0.0}),
        (cs.check_ba, {"cost_first": 1.0, "cost_last": 0.5}),
    ],
)
def test_checks_reject_out_of_limit(check, bad):
    with pytest.raises(cs.PhaseFailed):
        check(bad)


@pytest.mark.gpu
def test_scan_on_gpu(gpu):
    cs.check_scan(cs.run_scan())


@pytest.mark.gpu
def test_image_on_gpu(gpu):
    cs.check_image(cs.run_image(n_frames=50))
