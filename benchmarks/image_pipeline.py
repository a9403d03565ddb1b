#!/usr/bin/env python
"""Raw-image pipeline on one GPU.

Measures, at 752x480 mono (rendered simulator frames):

  1. frontend device step rate (hist-eq + 4-level pyramid + pyramidal LK
     + fundamental RANSAC + FAST-9 + grid top-N + a device-side slot
     refill), one dispatch per frame over device-resident frames;
  2. the XLA frontend kernels alone: `klt.fast_score` on one frame and
     one `klt.lk_level` (level 0, 150 features, 10 iterations);
  3. fused image -> pose (`frontend/fused_vio.py`, one dispatch per
     frame); with --trace DIR also a profiler trace of 20 steps, reduced
     to device time per stage (the step's named scopes) and the
     device's idle share. Kernels inside CUDA graphs cannot be split by
     stage (`cuda_graph_share`): for the full split run with
     XLA_FLAGS=--xla_gpu_enable_command_buffer= ;
  4. live image -> pose: per-frame tracker.feed + manager.feed_features
     (async dispatch), host in the loop.

Prints a device line, then one JSON line per measurement, each naming
the device. Needs a GPU: on any other device it exits without a result.

Usage: python benchmarks/image_pipeline.py [--frames 60] [--trace DIR]
"""

import argparse
import json
import os
import sys
import time

sys.setrecursionlimit(100000)  # deep traces: scan over pyramidal-LK steps

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--trace", default=None,
                    help="directory for a profiler trace of 20 fused steps")
    args = ap.parse_args()

    import uvio_jax  # noqa: F401  (x64, matmul precision, compile cache)
    import jax
    import jax.numpy as jnp

    from bench import gpu_device_line
    from uvio_jax.eval.capture import gt_initial_state, render_image_stream
    from uvio_jax.frontend.tracker import KLTTracker
    from uvio_jax.manager import CameraConfig, VioConfig, VioManager

    dev, smi = gpu_device_line()
    device = f"{dev.device_kind} ({smi})"
    print(f"device: {device}", flush=True)

    def emit(**fields):
        print(json.dumps(dict(fields, device=dev.device_kind)), flush=True)

    t0 = time.perf_counter()
    sim, imgs_np, stamps, imu_rows = render_image_stream(args.frames)
    cam = sim.params.cameras[0]
    H, W = cam.height, cam.width
    emit(metric="rendered_frames", value=len(imgs_np), resolution=f"{W}x{H}",
         render_s=round(time.perf_counter() - t0, 2))

    tracker = KLTTracker(cam.intrinsics, cam.model, num_features=150,
                         grid=(6, 8), histeq="HISTOGRAM")
    tracker._build_step((H, W))
    N = tracker.cap

    # ---- 1) frontend device step ------------------------------------
    from functools import partial

    from uvio_jax.frontend import klt

    dev_step = partial(
        KLTTracker._device_step, levels=tracker.levels, grid=tracker.grid,
        cam_model=tracker.cam_model, half=tracker.half,
        fast_thresh=tracker.fast_thresh, histeq="HISTOGRAM",
        per_cell=tracker.per_cell,
    )
    intr = tracker.intrinsics
    thresh = tracker.ransac_thresh

    def scan_fn(carry, inp):
        img_prev, uv, active, key = carry
        img = inp
        key, sub = jax.random.split(key)
        uv_new, tracked, det_uv, det_ok = dev_step(
            img_prev, img, uv, active, intr, sub, thresh
        )
        # device-side slot refill (the fused step's rank matching)
        tgt = klt.refill_targets(~tracked, det_ok)
        uv_out = uv_new.at[tgt].set(det_uv, mode="drop")
        active_out = tracked.at[tgt].set(True, mode="drop")
        return (img, uv_out, active_out, key), jnp.sum(tracked)

    # pipelined per-call dispatches over device-resident frames, one
    # block at the end: wall/frames = per-frame device step time
    step_jit = jax.jit(scan_fn)
    key = jax.random.PRNGKey(0)
    imgs_dev = [jax.device_put(jnp.asarray(im)) for im in imgs_np]
    uv0 = jnp.zeros((N, 2), jnp.float32)
    act0 = jnp.zeros((N,), bool)

    def run_all():
        carry = (imgs_dev[0], uv0, act0, key)
        counts = []
        for im in imgs_dev[1:]:
            carry, c = step_jit(carry, im)
            counts.append(c)
        jax.block_until_ready(carry[1])
        return counts

    counts = run_all()  # compile + warm
    n_rep = 3
    t0 = time.perf_counter()
    for _ in range(n_rep):
        counts = run_all()
    per_frame = (time.perf_counter() - t0) / (n_rep * (len(imgs_np) - 1))
    emit(metric="frontend_device_step_fps", value=round(1.0 / per_frame, 1),
         unit="frames/s", per_frame_ms=round(per_frame * 1e3, 3),
         mean_tracks=float(np.mean([np.asarray(c) for c in counts])))

    # ---- 2) XLA frontend kernels alone -------------------------------
    def time_ms(fn, *a, reps=50):
        jax.block_until_ready(fn(*a))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*a))
            ts.append(time.perf_counter() - t0)
        return 1e3 * float(np.median(ts))

    img_d = imgs_dev[0]
    fast = jax.jit(lambda x: klt.fast_score(x, 20.0))
    pyr = klt.build_pyramid(img_d, tracker.levels)
    pyr1 = klt.build_pyramid(imgs_dev[1], tracker.levels)
    uv = jnp.asarray(np.random.default_rng(0).uniform(
        [40, 40], [W - 40, H - 40], (150, 2)).astype(np.float32))
    v = jnp.ones((150,), bool)
    lk0 = jax.jit(lambda a, b, u: klt.lk_level(a, b, u, u, v, 7, 10, 25.0))
    emit(metric="xla_frontend_kernels_ms", resolution=f"{W}x{H}",
         fast_score_ms=round(time_ms(fast, img_d), 4),
         lk_level0_150f_10it_ms=round(time_ms(lk0, pyr[0], pyr1[0], uv), 4),
         note="median wall of one jitted call incl. dispatch, blocked")

    # ---- 3) fused image -> pose (ONE dispatch per frame) -------------
    from uvio_jax.filter.propagator import select_imu_readings_np
    from uvio_jax.frontend.fused_vio import STAGES, make_fused_vio_step
    from uvio_jax.types import StateLayout

    layout = StateLayout(max_clones=11, max_imu_batch=32, max_slam=0)
    fstep, make_carry = make_fused_vio_step(
        layout, cam.intrinsics, cam.model, sigma_pix=2.0
    )
    jstep = jax.jit(fstep)
    st0 = gt_initial_state(sim, layout, stamps[0])
    windows = []
    cur = stamps[0]
    for i in range(1, len(stamps)):
        tt, ww, aa = select_imu_readings_np(
            imu_rows[:, 0], imu_rows[:, 1:4], imu_rows[:, 4:7],
            cur, stamps[i], layout.max_imu_batch,
        )
        windows.append((jnp.asarray(tt), jnp.asarray(ww), jnp.asarray(aa),
                        jnp.asarray(stamps[i], jnp.float64)))
        cur = stamps[i]

    def run_fused(n=None, step=jstep):
        st, carry = st0, make_carry(imgs_dev[0])
        key = jax.random.PRNGKey(0)
        last = None
        for i, (tt, ww, aa, ts) in enumerate(windows[:n]):
            key, sub = jax.random.split(key)
            st, carry, last = step(st, carry, imgs_dev[i + 1], tt, ww, aa, ts, sub)
        jax.block_until_ready(st.cov)
        return st, last

    st_f, info_f = run_fused()  # compile + warm
    rep_fps = []
    for _ in range(6):
        t0 = time.perf_counter()
        st_f, info_f = run_fused()
        rep_fps.append(len(windows) / (time.perf_counter() - t0))
    fps = float(np.median(rep_fps))
    g_end = sim.get_gt_state(stamps[len(windows)])
    emit(metric="image_to_pose_fused_fps", value=round(fps, 1), unit="frames/s",
         per_frame_ms=round(1e3 / fps, 3), rep_fps=[round(f, 1) for f in rep_fps],
         final_p_err_m=round(float(np.linalg.norm(
             np.asarray(st_f.p) - g_end["p_IinG"])), 3),
         cov_ok=bool(info_f["cov_ok"]))

    if args.trace:
        from uvio_jax.eval.device_trace import time_by_scope

        n_tr = min(20, len(windows))
        tt, ww, aa, ts = windows[0]
        # trace the very executable whose text maps kernels to stages
        # (instruction names differ between two compilations). The
        # compile cache's key ignores op_name metadata: after renaming a
        # stage, clear the cache or the old names come back with it.
        compiled = jstep.lower(st0, make_carry(imgs_dev[0]), imgs_dev[1], tt, ww, aa,
                               ts, jax.random.PRNGKey(0)).compile()
        hlo = compiled.as_text()
        run_fused(n_tr, step=compiled)  # warm
        with jax.profiler.trace(args.trace):
            run_fused(n_tr, step=compiled)
        red = time_by_scope(args.trace, hlo, "jit_step", STAGES)
        mod = red["module_ns"]
        emit(metric="fused_step_device_time_by_stage", frames=n_tr,
             device_ms_per_frame=round(mod / n_tr / 1e6, 4),
             stage_ms_per_frame={k: round(v / n_tr / 1e6, 4) for k, v in red["scopes"].items()},
             stage_share={k: round(v / mod, 4) for k, v in red["scopes"].items()} if mod else None,
             unattributed_share=round(red["other_ns"] / mod, 4) if mod else None,
             cuda_graph_share=round(red["graph_ns"] / mod, 4) if mod else None,
             idle_share=red["idle_share"], window_ms=round(red["window_ns"] / 1e6, 3))

    # ---- 4) live image -> pose ---------------------------------------
    cfg = VioConfig(
        max_clones=11, max_msckf_in_update=40, sigma_pix=2.0,
        async_dispatch=True, dtype="float32",
        cameras=[CameraConfig(model=cam.model, intrinsics=cam.intrinsics,
                              q_ItoC=cam.q_ItoC, p_IinC=cam.p_IinC)],
    )
    mgr = VioManager(cfg)
    g0 = sim.get_gt_state(stamps[0])
    mgr.initialize_with_gt(stamps[0], g0["q_GtoI"], g0["p_IinG"],
                           g0["v_IinG"], g0["bg"], g0["ba"])
    tracker2 = KLTTracker(cam.intrinsics, cam.model, num_features=150,
                          grid=(6, 8), histeq="HISTOGRAM")
    fi = 0
    frame_s = []
    for k in range(imu_rows.shape[0]):
        t = float(imu_rows[k, 0])
        mgr.feed_imu(t, imu_rows[k, 1:4], imu_rows[k, 4:7])
        while fi < len(stamps) and stamps[fi] <= t:
            s0 = time.perf_counter()
            ids, uvs = tracker2.feed(stamps[fi], imgs_np[fi])
            mgr.feed_features(stamps[fi], [(ids.astype(np.int64), uvs)])
            frame_s.append(time.perf_counter() - s0)
            fi += 1
    jax.block_until_ready(mgr.state.cov)
    skip = min(20, len(frame_s) // 3)
    steady = np.asarray(frame_s[skip:])
    emit(metric="image_to_pose_live_fps", value=round(float(1.0 / steady.mean()), 1),
         unit="frames/s", median_ms=round(float(np.median(steady) * 1e3), 3),
         initialized=bool(mgr.is_initialized))


if __name__ == "__main__":
    main()
