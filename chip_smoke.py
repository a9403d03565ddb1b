#!/usr/bin/env python
"""Smoke test of the UWB-aided VIO estimator on an NVIDIA GPU.

Drives each main path once, through the entry points a user calls, at
its real size, and checks it against the repository's own references:

  P0 device  the first JAX device must be a GPU (no fallback). Prints the
             card (nvidia-smi name and power limit), the JAX version,
             x64, the matmul precision, the compile-cache directory and
             whether the native host library loaded.
  P1 live    the vendored UWB stream (`data/streams/uwb`: 200 Hz IMU,
             4 anchors with online calibration, the estimator settings
             of its config) replayed through `UVioManager` with
             groundtruth init; gated on the stream's regression limits
             (ATE and anchor RMS error no worse than the reference's).
  P2 scan    the fused full step under `lax.scan` (bench.py's program)
             over captured simulator bundles, f32 on the GPU, against
             the same scan at f64 on the host CPU.
  P3 image   raw 752x480 frames -> pose through `frontend/fused_vio.py`
             for 200 frames; then FAST scores, the pyramid and pyramidal
             LK compared between the GPU and the CPU on the same frames.
  P4 BA      the map backend's Schur-complement BA at 256 keyframes x
             4096 landmarks, f64, on one card.

`--multi` (four cards) runs only the sharded paths and what they are
compared with: the dp-sharded, vmapped full step over 4 streams against
the same 4 streams on one device, and the 2D ("kf", "lm") BA on a 2x2
mesh against the single-device solve.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}},
printed only when every phase passed; any failure exits non-zero.

Usage: python chip_smoke.py [--multi]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
UWB_STREAM = os.path.join(REPO, "data", "streams", "uwb")

# P2: f32 on the GPU against f64 on the CPU after a 100-frame scan. The
# f32 filter carries ~1e-7 relative rounding per op through hundreds of
# covariance updates per frame, and the GPU sums in another order than
# the CPU. The same comparison with f32 on the CPU gives 2.0e-5 m,
# 2.5e-4 deg and 1.7e-4 relative on the covariance diagonal, with the
# same MSCKF rows used; the limits leave ~100x for the GPU's own order.
SCAN_TOL = {"pos_m": 2e-3, "ori_deg": 2e-2, "cov_diag_rel": 2e-2}
# P3: f32 on both sides, identical math; only the order of sums differs.
# FAST scores sum up to 16 terms of |I_c - I_p| - t (values <= 4080,
# f32 ulp 4.9e-4 there); pyramid levels average 4 pixels (ulp ~1.5e-5 at
# 255); LK iterates 10 Gauss-Newton steps on 15x15 window sums.
IMAGE_TOL = {
    "fast_max_abs": 2e-3,
    "pyramid_max_abs": 1e-4,
    "lk_kept_agreement": 0.97,  # |kept by both| / |kept by either|
    "lk_p99_px": 1e-2,
}
# fused_vio limits of tests/test_fused_vio.py
IMAGE_GATES = {"min_tracks": 100, "min_used": 100, "max_pos_err_m": 0.5}
# --multi: the same f32 (step) and f64 (BA) programs split over devices;
# only batch size per device and the order of the collective sums change
MULTI_TOL = {"step_rel": 1e-4, "ba_cost_rel": 1e-6, "ba_lm_m": 1e-6}
# P4 / --multi BA: cost reduction __graft_entry__.dryrun_multichip asserts
BA_COST_FACTOR = 0.05


class PhaseFailed(Exception):
    """A phase's result is outside its limits."""


def _check(ok, msg):
    if not ok:
        raise PhaseFailed(msg)


def _say(tag, **fields):
    print(f"{tag}: " + json.dumps(fields, default=float), flush=True)


def _peak_bytes(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _to_f64_on(tree, dev):
    import jax
    import jax.numpy as jnp

    def cast(x):
        x = jnp.asarray(x)
        return x.astype(jnp.float64) if x.dtype == jnp.float32 else x

    return jax.device_put(jax.tree.map(cast, tree), dev)


# ---------------------------------------------------------------- P0
def phase_device():
    """Require a GPU; print what the run is on."""
    import jax

    import uvio_jax.native
    from bench import gpu_device_line

    dev, smi = gpu_device_line()
    info = {
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "nvidia_smi": smi,
        "jax": jax.__version__,
        "x64": bool(jax.config.jax_enable_x64),
        "matmul_precision": jax.config.jax_default_matmul_precision,
        "compile_cache": jax.config.jax_compilation_cache_dir,
        "native_lib": uvio_jax.native.get_lib() is not None,
    }
    print(f"card: {smi}", flush=True)
    _say("P0 device", **info)
    return dev, info


# ---------------------------------------------------------------- P1
def run_live(stream_dir=UWB_STREAM):
    """Replay the vendored UWB stream through UVioManager (gt init)."""
    from uvio_jax.eval.replay import anchor_rms_errors, ate_vs_reference, replay
    from uvio_jax.utils.config import load_config
    from uvio_jax.uwb_manager import UVioManager

    cfg, _ = load_config(os.path.join(stream_dir, "config"))
    cfg = dataclasses.replace(cfg, use_static_init=False, use_dynamic_init=False)
    mgr = UVioManager(cfg)
    # per-frame wall time of the served path (feed -> pose), first frame
    # includes compilation
    frame_s = []
    feed = mgr.feed_features

    def timed_feed(t, obs):
        s = time.perf_counter()
        feed(t, obs)
        frame_s.append(time.perf_counter() - s)

    mgr.feed_features = timed_feed
    t0 = time.perf_counter()
    est_t, est_q, est_p = replay(stream_dir, cfg, mgr, feed_uwb=True)
    wall = time.perf_counter() - t0
    ours, ref = ate_vs_reference(stream_dir, est_t, est_q, est_p)
    our_anchor, ref_anchor = anchor_rms_errors(stream_dir, mgr)
    diag = np.diagonal(np.asarray(mgr.state.cov))
    steady = np.asarray(frame_s[10:]) if len(frame_s) > 20 else np.asarray(frame_s)
    return {
        "frames": len(est_t),
        "wall_s": wall,
        "first_frame_s": frame_s[0] if frame_s else None,
        "fps_incl_compile": len(est_t) / wall,
        "fps_steady": len(steady) / float(steady.sum()),
        "p50_frame_ms": 1e3 * float(np.median(steady)),
        "p99_frame_ms": 1e3 * float(np.percentile(steady, 99)),
        "ate_pos_m": float(ours["rmse_pos"]),
        "ref_ate_pos_m": float(ref["rmse_pos"]),
        "ate_ori_deg": float(ours["rmse_ori_deg"]),
        "anchor_rms_m": our_anchor,
        "ref_anchor_rms_m": ref_anchor,
        # the manager raises on a bad covariance (on_cov_fail="raise"),
        # so reaching here means every frame passed; the final state too
        "cov_ok": bool(np.all(np.isfinite(diag)) and np.all(diag >= 0.0)),
        "dtype": cfg.dtype,
    }


def check_live(m):
    _check(m["frames"] > 400, f"only {m['frames']} frames replayed")
    _check(m["cov_ok"], "covariance not finite / negative diagonal")
    _check(m["ate_pos_m"] <= m["ref_ate_pos_m"],
           f"ATE {m['ate_pos_m']} > reference {m['ref_ate_pos_m']}")
    _check(m["anchor_rms_m"] <= m["ref_anchor_rms_m"],
           f"anchor RMS {m['anchor_rms_m']} > reference {m['ref_anchor_rms_m']}")


# ---------------------------------------------------------------- P2
def _quat_angle_deg(q1, q2):
    d = abs(float(np.dot(q1 / np.linalg.norm(q1), q2 / np.linalg.norm(q2))))
    return float(np.degrees(2.0 * np.arccos(min(1.0, d))))


def run_scan(n_warm=20, n_bench=100, seed=7, max_slam=25):
    """bench.py's scan, f32 on the default device vs f64 on the CPU."""
    import jax
    import jax.numpy as jnp

    from bench import make_scan
    from uvio_jax.eval.capture import capture_sim_bundles

    t0 = time.perf_counter()
    full_cfg, state0, bundles = capture_sim_bundles(
        n_warm=n_warm, n_bench=n_bench, seed=seed, max_slam=max_slam, dtype="float32"
    )
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *bundles)
    t_capture = time.perf_counter() - t0
    run = make_scan(full_cfg)
    dev = jax.devices()[0]

    t0 = time.perf_counter()
    compiled = run.lower(state0, stacked).compile()
    t_compile = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    out, used = compiled(state0, stacked)
    jax.block_until_ready(out.cov)
    t0 = time.perf_counter()
    out, used = compiled(state0, stacked)
    jax.block_until_ready(out.cov)
    t_scan = time.perf_counter() - t0

    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    ref, used_ref = run(_to_f64_on(state0, cpu), _to_f64_on(stacked, cpu))
    jax.block_until_ready(ref.cov)
    t_ref = time.perf_counter() - t0

    d_dev = np.diagonal(np.asarray(out.cov, np.float64))
    d_ref = np.diagonal(np.asarray(ref.cov))
    live = d_ref > 1e-12  # slots in use (free slots carry zero variance)
    return {
        "frames": n_bench,
        "capture_s": t_capture,
        "compile_s": t_compile,
        "scan_s": t_scan,
        "frames_per_s": n_bench / t_scan,
        "cpu_f64_s_incl_compile": t_ref,
        "memory_analysis": str(mem),
        "peak_bytes_in_use": _peak_bytes(dev),
        "msckf_rows_used": int(np.sum(np.asarray(used))),
        "msckf_rows_used_ref": int(np.sum(np.asarray(used_ref))),
        "finite": bool(np.all(np.isfinite(d_dev)) and np.all(np.isfinite(np.asarray(out.p)))),
        "cov_diag_nonneg": bool(np.all(d_dev >= 0.0)),
        "pos_m": float(np.linalg.norm(np.asarray(out.p, np.float64) - np.asarray(ref.p))),
        "ori_deg": _quat_angle_deg(np.asarray(out.q, np.float64), np.asarray(ref.q)),
        "cov_diag_rel": float(np.max(np.abs(d_dev[live] - d_ref[live]) / d_ref[live])),
    }


def check_scan(m):
    _check(m["finite"] and m["cov_diag_nonneg"], "scan state not finite / negative variance")
    _check(m["msckf_rows_used"] > 0, "no MSCKF rows used in the scan")
    for k, tol in SCAN_TOL.items():
        _check(m[k] <= tol, f"GPU f32 vs CPU f64 {k} = {m[k]} > {tol}")


# ---------------------------------------------------------------- P3
def run_image(n_frames=200):
    """fused_vio image -> pose over `n_frames` rendered frames."""
    import jax
    import jax.numpy as jnp

    from uvio_jax.eval.capture import gt_initial_state, render_image_stream
    from uvio_jax.filter.propagator import select_imu_readings_np
    from uvio_jax.frontend.fused_vio import make_fused_vio_step
    from uvio_jax.types import StateLayout

    t0 = time.perf_counter()
    sim, imgs, stamps, imu = render_image_stream(n_frames + 1)
    t_render = time.perf_counter() - t0
    _check(len(imgs) == n_frames + 1, f"rendered {len(imgs)} of {n_frames + 1} frames")
    cam = sim.params.cameras[0]
    layout = StateLayout(max_clones=11, max_imu_batch=32, max_slam=0)
    step, make_carry = make_fused_vio_step(layout, cam.intrinsics, cam.model, sigma_pix=2.0)
    jstep = jax.jit(step)

    st = gt_initial_state(sim, layout, stamps[0])
    carry = make_carry(imgs[0])
    key = jax.random.PRNGKey(0)
    cur = stamps[0]
    used_total, cov_ok, frame_s = 0, True, []
    for i in range(1, len(imgs)):
        s = time.perf_counter()
        tt, ww, aa = select_imu_readings_np(
            imu[:, 0], imu[:, 1:4], imu[:, 4:7], cur, stamps[i], layout.max_imu_batch
        )
        cur = stamps[i]
        key, sub = jax.random.split(key)
        st, carry, info = jstep(
            st, carry, jnp.asarray(imgs[i]), jnp.asarray(tt), jnp.asarray(ww),
            jnp.asarray(aa), jnp.asarray(stamps[i], jnp.float64), sub,
        )
        used_total += int(info["num_used"])
        cov_ok = cov_ok and bool(info["cov_ok"])
        frame_s.append(time.perf_counter() - s)
    g = sim.get_gt_state(stamps[-1])
    steady = np.asarray(frame_s[5:]) if len(frame_s) > 10 else np.asarray(frame_s)
    m = {
        "frames": len(imgs) - 1,
        "resolution": f"{imgs.shape[2]}x{imgs.shape[1]}",
        "render_s": t_render,
        "first_frame_s": frame_s[0],
        "fps_steady": len(steady) / float(steady.sum()),
        "p50_frame_ms": 1e3 * float(np.median(steady)),
        "cov_ok": cov_ok,
        "num_tracks": int(info["num_tracks"]),
        "used_total": used_total,
        "pos_err_m": float(np.linalg.norm(np.asarray(st.p) - g["p_IinG"])),
    }
    # kernel agreement on the last frame pair, with the tracker's final
    # tracks (positions in the last frame), tracked back to the one before
    _, uv_last, active_last, _, _ = carry
    m.update(compare_frontend(imgs[-1], imgs[-2], np.asarray(uv_last),
                              np.asarray(active_last)))
    return m


def compare_frontend(img_a, img_b, uv, valid, levels=4):
    """hist-eq + FAST, the pyramid and pyramidal LK of `uv` from `img_a`
    to `img_b`, on the default device vs the CPU: each device computes
    the whole chain from the same raw frames."""
    import jax
    import jax.numpy as jnp

    from uvio_jax.frontend import klt

    cpu = jax.devices("cpu")[0]

    def chain(a, b, uv, valid):
        ea, eb = klt.hist_equalize(a), klt.hist_equalize(b)
        pa, pb = klt.build_pyramid(ea, levels), klt.build_pyramid(eb, levels)
        uv_new, ok = klt.lk_track(pa, pb, uv, valid)
        return klt.fast_score(ea), pa, uv_new, ok

    args = (np.asarray(img_a, np.float32), np.asarray(img_b, np.float32),
            np.asarray(uv, np.float32), np.asarray(valid, bool))

    f = jax.jit(chain)
    out_dev = jax.device_get(f(*[jax.device_put(jnp.asarray(a)) for a in args]))
    out_cpu = jax.device_get(f(*[jax.device_put(jnp.asarray(a), cpu) for a in args]))
    s_d, p_d, uv_d, ok_d = out_dev
    s_c, p_c, uv_c, ok_c = out_cpu
    both, either = ok_d & ok_c, ok_d | ok_c
    dist = np.linalg.norm(uv_d[both] - uv_c[both], axis=-1)
    return {
        "lk_features": int(valid.sum()),
        "fast_max_abs": float(np.max(np.abs(s_d - s_c))),
        "fast_corners": int((s_c > 0).sum()),
        "pyramid_max_abs": float(max(np.max(np.abs(a - b)) for a, b in zip(p_d, p_c))),
        "lk_kept_dev": int(ok_d.sum()),
        "lk_kept_cpu": int(ok_c.sum()),
        "lk_kept_agreement": float(both.sum() / max(either.sum(), 1)),
        "lk_p99_px": float(np.percentile(dist, 99)) if dist.size else 0.0,
    }


def check_image(m):
    _check(m["cov_ok"], "fused step reported a bad covariance")
    _check(m["num_tracks"] > IMAGE_GATES["min_tracks"], f"tracks {m['num_tracks']}")
    _check(m["used_total"] > IMAGE_GATES["min_used"], f"features used {m['used_total']}")
    _check(m["pos_err_m"] < IMAGE_GATES["max_pos_err_m"], f"position error {m['pos_err_m']} m")
    _check(m["fast_max_abs"] <= IMAGE_TOL["fast_max_abs"], f"FAST diff {m['fast_max_abs']}")
    _check(m["pyramid_max_abs"] <= IMAGE_TOL["pyramid_max_abs"],
           f"pyramid diff {m['pyramid_max_abs']}")
    _check(m["lk_kept_agreement"] >= IMAGE_TOL["lk_kept_agreement"],
           f"LK kept agreement {m['lk_kept_agreement']}")
    _check(m["lk_p99_px"] <= IMAGE_TOL["lk_p99_px"], f"LK p99 {m['lk_p99_px']} px")


# ---------------------------------------------------------------- P4
def _ba_problem(n_kf, n_lm):
    import jax.numpy as jnp

    from uvio_jax.sim.ba_problem import ring_map

    return tuple(jnp.asarray(a) for a in ring_map(n_kf, n_lm, seed=0))


def run_ba(n_kf=256, n_lm=4096, iters=4, mesh=None):
    """Schur BA on the ring map, f64; on `mesh` when given."""
    import jax

    from uvio_jax.parallel.ba import BAOptions, ba_solve

    prob = _ba_problem(n_kf, n_lm)
    opts = BAOptions(iters=iters)
    solve = jax.jit(lambda *a: ba_solve(*a, opts, mesh=mesh))
    t0 = time.perf_counter()
    compiled = solve.lower(*prob).compile()
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    q, p, lm, info = compiled(*prob)
    jax.block_until_ready(lm)
    t_solve = time.perf_counter() - t0
    costs = np.asarray(info["costs"])
    return {
        "keyframes": n_kf,
        "landmarks": n_lm,
        "iters": iters,
        "dtype": str(prob[1].dtype),
        "compile_s": t_compile,
        "solve_s": t_solve,
        "cost_first": float(costs[0]),
        "cost_last": float(costs[-1]),
        "memory_analysis": str(compiled.memory_analysis()),
        "peak_bytes_in_use": _peak_bytes(jax.devices()[0]),
    }, (np.asarray(q), np.asarray(p), np.asarray(lm), costs)


def check_ba(m):
    _check(np.isfinite(m["cost_last"]), "BA cost not finite")
    _check(m["cost_last"] < BA_COST_FACTOR * m["cost_first"],
           f"BA cost {m['cost_first']} -> {m['cost_last']}: less than a "
           f"{1 / BA_COST_FACTOR:.0f}x reduction")


# ---------------------------------------------------------------- --multi
def run_multi_step(n_streams=4):
    """dp-sharded vmapped full step over `n_streams` streams vs the same
    batch on one device."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from __graft_entry__ import _example
    from uvio_jax.pipeline import full_filter_step

    cfg, one_state, fb = _example()
    states = [one_state(i) for i in range(n_streams)]
    states = [s.replace(cov=s.cov * (1.0 + 0.5 * i)) for i, s in enumerate(states)]
    fbs = [fb._replace(imu_w=fb.imu_w * (1.0 + 0.25 * i)) for i in range(n_streams)]
    states = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    fbs = jax.tree.map(lambda *xs: jnp.stack(xs), *fbs)
    devs = jax.devices()[:n_streams]
    shard = NamedSharding(Mesh(np.asarray(devs), ("dp",)), P("dp"))
    vstep = jax.vmap(partial(full_filter_step, cfg=cfg))
    sharded = jax.jit(vstep, in_shardings=shard, out_shardings=shard)
    out, infos = sharded(jax.device_put(states, shard), jax.device_put(fbs, shard))
    jax.block_until_ready(out.cov)
    ref, infos_ref = jax.jit(vstep)(jax.device_put(states, devs[0]), jax.device_put(fbs, devs[0]))

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))

    return {
        "streams": n_streams,
        "devices": len(devs),
        "out_sharding": str(out.cov.sharding),
        "cov_ok": bool(np.all(np.asarray(infos["cov_ok"]))),
        "p_rel": rel(out.p, ref.p),
        "q_rel": rel(out.q, ref.q),
        "cov_rel": rel(out.cov, ref.cov),
    }


def check_multi_step(m):
    _check(m["cov_ok"], "sharded step reported a bad covariance")
    for k in ("p_rel", "q_rel", "cov_rel"):
        _check(m[k] <= MULTI_TOL["step_rel"], f"sharded vs one device {k} = {m[k]}")


def run_multi_ba(n_kf=256, n_lm=4096, iters=4):
    """2D ("kf","lm") BA on a 2x2 mesh vs the single-device solve."""
    import jax
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("kf", "lm"))
    m_one, (q1, p1, lm1, c1) = run_ba(n_kf, n_lm, iters)
    m_mesh, (q2, p2, lm2, c2) = run_ba(n_kf, n_lm, iters, mesh=mesh)
    return {
        "keyframes": n_kf,
        "landmarks": n_lm,
        "one_device": {k: m_one[k] for k in ("compile_s", "solve_s", "cost_first", "cost_last")},
        "mesh_2x2": {k: m_mesh[k] for k in ("compile_s", "solve_s", "cost_first", "cost_last")},
        "cost_first": m_mesh["cost_first"],
        "cost_last": m_mesh["cost_last"],
        "cost_rel": float(np.max(np.abs(c2 - c1) / np.abs(c1))),
        "lm_max_m": float(np.max(np.abs(lm2 - lm1))),
        "p_max_m": float(np.max(np.abs(p2 - p1))),
    }


def check_multi_ba(m):
    check_ba(m)
    _check(m["cost_rel"] <= MULTI_TOL["ba_cost_rel"], f"BA cost rel diff {m['cost_rel']}")
    _check(m["lm_max_m"] <= MULTI_TOL["ba_lm_m"], f"BA landmark diff {m['lm_max_m']} m")
    _check(m["p_max_m"] <= MULTI_TOL["ba_lm_m"], f"BA pose diff {m['p_max_m']} m")


# ---------------------------------------------------------------- main
def contract_line(dev, count):
    """The last line: the device as JAX reports it."""
    return json.dumps(
        {"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind, "count": count}}
    )


def _phase(tag, run, check, **kw):
    t0 = time.perf_counter()
    out = run(**kw)
    m = out[0] if isinstance(out, tuple) else out
    m = dict(m, phase_wall_s=time.perf_counter() - t0)
    _say(tag, **m)
    check(m)
    return m


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card sharded paths and their references")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    # the references of P2 and P3 run on the host CPU: keep its backend
    # next to the GPU's when the platform list is pinned
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import uvio_jax  # noqa: F401  (x64, matmul precision, compile cache)
    import jax

    dev, _ = phase_device()
    if args.multi:
        n = len(jax.devices())
        _check(n >= 4, f"--multi needs 4 GPUs, found {n}")
        _phase("M1 dp-sharded full step", run_multi_step, check_multi_step)
        _phase("M2 2D BA on 2x2 mesh", run_multi_ba, check_multi_ba)
        count = 4
    else:
        _phase("P1 live UVIO (uwb stream)", run_live, check_live)
        _phase("P2 offline full-step scan", run_scan, check_scan)
        _phase("P3 raw image -> pose", run_image, check_image)
        _phase("P4 map backend BA", run_ba, check_ba)
        count = len(jax.devices())
    print(contract_line(dev, count), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
