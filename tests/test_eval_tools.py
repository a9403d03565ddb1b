"""Tests for the full eval toolkit: recorder round-trip, simulation
consistency report, timing analysis, and the CLI subcommands
(the reference's 12 `ov_eval` binaries, `ov_eval/cmake/ROS1.cmake`)."""

import numpy as np
import pytest

from uvio_jax.eval import (
    StateRecorder,
    error_simulation,
    load_state_file,
    load_std_file,
    save_tum,
    timing_comparison,
    timing_flamegraph,
    timing_histogram,
    timing_percentages,
)
from uvio_jax.eval.cli import main as cli_main


def _make_run(tmp_path, n=200, seed=0):
    """Synthesize a consistent estimator run: gt + est = gt + noise with
    matching reported std."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * 0.1
    q_gt = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    p_gt = np.stack([np.cos(t * 0.3), np.sin(t * 0.3), 0.1 * t], 1)
    v_gt = np.gradient(p_gt, 0.1, axis=0)
    bg = np.full((n, 3), 0.01)
    ba = np.full((n, 3), -0.02)

    s_ori, s_pos = 0.01, 0.05
    dth = rng.normal(0, s_ori, (n, 3))
    q_est = q_gt.copy()
    q_est[:, :3] += 0.5 * dth  # small-angle JPL perturbation
    q_est /= np.linalg.norm(q_est, axis=1, keepdims=True)
    p_est = p_gt + rng.normal(0, s_pos, (n, 3))
    v_est = v_gt + rng.normal(0, s_pos, (n, 3))
    dt_true, dt_est0 = 0.004, 0.02

    with StateRecorder(str(tmp_path)) as rec:
        for i in range(n):
            dt_i = dt_true + (dt_est0 - dt_true) * np.exp(-i / 20.0)
            rec.write_est(t[i], q_est[i], p_est[i], v_est[i], bg[i], ba[i], [dt_i])
            rec.write_std(
                t[i],
                np.full(3, s_ori),
                np.full(3, s_pos),
                np.full(3, s_pos),
                np.full(3, 1e-4),
                np.full(3, 1e-4),
                [1e-3],
            )
            rec.write_gt(t[i], q_gt[i], p_gt[i], v_gt[i], bg[i], ba[i], [dt_true])
    return t, q_est, p_est, q_gt, p_gt


def test_recorder_roundtrip(tmp_path):
    _make_run(tmp_path)
    t, q, p, v, bg, ba, extra = load_state_file(tmp_path / "state_est.txt")
    assert len(t) == 200 and q.shape == (200, 4) and extra.shape == (200, 1)
    ts, sq, *_ = load_std_file(tmp_path / "state_std.txt")
    assert np.allclose(sq, 0.01)


def test_error_simulation_consistent(tmp_path):
    _make_run(tmp_path)
    res = error_simulation(
        tmp_path / "state_est.txt",
        tmp_path / "state_std.txt",
        tmp_path / "state_gt.txt",
    )
    # noise was drawn at exactly the reported sigma -> NEES ~ 3, ~99.7% in 3sig
    assert 2.0 < res["ori_nees"] < 4.5
    assert 2.0 < res["pos_nees"] < 4.5
    assert res["pos_3sigma_frac"] > 0.98
    # bias errors are exactly zero -> inside bounds
    assert res["bg_3sigma_frac"] == 1.0
    # the recorded dt column converges toward truth
    assert res["calib"][0]["converged"]
    assert res["calib"][0]["final_abs_err"] < 1e-3


def _make_timing(path, n=300, seed=1):
    rng = np.random.default_rng(seed)
    cols = dict(
        tracking=rng.uniform(2e-3, 4e-3, n),
        propagation=rng.uniform(1e-4, 3e-4, n),
        msckf=rng.uniform(1e-3, 2e-3, n),
        slam=rng.uniform(5e-4, 1e-3, n),
        marg=rng.uniform(1e-4, 2e-4, n),
    )
    total = sum(cols.values())
    with open(path, "w") as f:
        f.write("# t," + ",".join(cols) + ",total\n")
        for i in range(n):
            row = [i * 0.1] + [cols[k][i] for k in cols] + [total[i]]
            f.write(",".join(f"{x:.9g}" for x in row) + "\n")


def test_timing_tools(tmp_path):
    csv = tmp_path / "timing.csv"
    _make_timing(csv)
    out = timing_histogram(str(csv))
    assert "mean" in out and "#" in out
    out = timing_percentages(str(csv))
    assert "tracking" in out and "100.0 %" in out
    out = timing_flamegraph(str(csv))
    assert "cumulative" in out
    out = timing_comparison([str(csv), str(csv)])
    assert out.count("fps") == 2
    with pytest.raises(ValueError):
        timing_histogram(str(csv), column="nope")


def test_cli_subcommands(tmp_path, capsys):
    t, q_est, p_est, q_gt, p_gt = _make_run(tmp_path)
    est = tmp_path / "est.txt"
    gt = tmp_path / "gt.txt"
    save_tum(est, t, q_est, p_est)
    save_tum(gt, t, q_gt, p_gt)
    csv = tmp_path / "timing.csv"
    _make_timing(csv)

    assert cli_main(["error_singlerun", "se3", str(est), str(gt)]) == 0
    assert cli_main(["error_dataset", "se3", str(gt), str(est), str(est)]) == 0
    assert (
        cli_main(
            [
                "error_simulation",
                str(tmp_path / "state_est.txt"),
                str(tmp_path / "state_std.txt"),
                str(tmp_path / "state_gt.txt"),
            ]
        )
        == 0
    )
    assert cli_main(["timing_percentages", str(csv)]) == 0
    assert cli_main(["timing_flamegraph", str(csv)]) == 0
    out_tum = tmp_path / "from_state.txt"
    assert cli_main(["pose_to_file", str(tmp_path / "state_est.txt"), str(out_tum)]) == 0
    t2, q2, p2 = np.loadtxt(out_tum).T[0:1], None, None  # file exists & parses
    assert cli_main(["format_converter", str(out_tum), str(tmp_path / "conv.txt")]) == 0
    assert cli_main(["live_align_trajectory", "se3", str(est), str(gt)]) == 0
    captured = capsys.readouterr().out
    assert "ATE" in captured and "NEES" in captured and "rmse" in captured


def test_format_converter_euroc(tmp_path):
    # EuRoC-style csv: t[ns], p(3), q_wxyz(4)
    n = 50
    t = (1.4e18 + np.arange(n) * 5e7).astype(np.int64)
    rows = []
    for i in range(n):
        rows.append(
            f"{t[i]},{0.1 * i},{0.2 * i},{0.0},1.0,0.0,0.0,0.0"
        )
    src = tmp_path / "data.csv"
    src.write_text("#timestamp [ns],...\n" + "\n".join(rows) + "\n")
    dst = tmp_path / "out.txt"
    assert cli_main(["format_converter", str(src), str(dst)]) == 0
    data = np.loadtxt(dst)
    assert data.shape == (n, 8)
    assert abs(data[0, 0] - 1.4e9) < 1.0  # ns -> s
    # identity wxyz -> xyzw last element 1
    assert np.allclose(data[:, 7], 1.0)


def test_scope_of_instructions_resolves_fusions():
    """A fusion without a scope of its own takes the majority scope of
    the computation it calls; an instruction's own scope wins."""
    from uvio_jax.eval.device_trace import scope_of_instructions

    hlo = "\n".join([
        "HloModule jit_f, is_scheduled=true",
        "%fused_computation (p: f32[4]) -> f32[4] {",
        '  %mul.1 = f32[4]{0} multiply(%p, %p), metadata={op_name="jit(f)/beta/mul"}',
        '  ROOT %add.2 = f32[4]{0} add(%mul.1, %p), metadata={op_name="jit(f)/add"}',
        "}",
        "ENTRY %main (x: f32[4]) -> f32[4] {",
        '  %sine = f32[4]{0} sine(%x), metadata={op_name="jit(f)/alpha/sin"}',
        "  %fusion.7 = f32[4]{0} fusion(%sine), kind=kLoop, calls=%fused_computation,"
        ' metadata={op_name="jit(f)/add"}',
        "  ROOT %copy.3 = f32[4]{0} copy(%fusion.7)",
        "}",
    ])
    m = scope_of_instructions(hlo, ("alpha", "beta"))
    assert m["sine"] == "alpha"
    assert m["fusion.7"] == "beta"
    assert "copy.3" not in m


def test_time_by_scope_on_recorded_trace(tmp_path):
    """Reduce a small recorded CPU trace: per-scope times and the rest
    add up to the module's device time; busy <= window."""
    import jax
    import jax.numpy as jnp

    from uvio_jax.eval.device_trace import time_by_scope

    def f(x):
        with jax.named_scope("alpha"):
            y = jnp.sin(x) * jnp.cos(x)
        with jax.named_scope("beta"):
            z = jnp.exp(y) + 2.0 * y
        return z.sum()

    x = jnp.linspace(0.0, 1.0, 1 << 16)
    compiled = jax.jit(f).lower(x).compile()
    compiled(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(3):
            compiled(x).block_until_ready()
    red = time_by_scope(str(tmp_path), compiled.as_text(), "jit_f", ("alpha", "beta"))
    assert red["module_ns"] > 0
    assert sum(red["scopes"].values()) + red["other_ns"] == red["module_ns"]
    assert sum(red["scopes"].values()) > 0
    assert 0 < red["busy_ns"] <= red["window_ns"]
    assert 0.0 <= red["idle_share"] < 1.0
