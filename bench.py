"""Benchmark: FULL fused per-frame step throughput on one GPU.

Prints a device line, then ONE JSON line:
  {"metric": "full_frame_step_fps_per_chip", "value": N, "unit": "frames/s",
   "vs_baseline": N / 200.0, "device": {...}}

Baseline anchor: the reference is a real-time CPU system at ~20 camera
fps (EuRoC); the target is >=10x real-time per chip => 200 fps
(BASELINE.md). vs_baseline = achieved_fps / 200.

What is measured: the fused FULL frame step
(`pipeline.full_filter_step`) = the whole of the reference's per-frame
hot path `UVioManager::track_image_and_update` + `do_feature_propagate_
update` (UVioManager.cpp:114-205, VioManager.cpp:323-714) as one jitted
unit: UWB range drain (propagate-no-clone + per-range updates) ->
propagate+clone -> batched MSCKF update (40 feats) -> SLAM re-obs
update (25 landmarks) -> SLAM delayed init -> anchor change + clone
marginalization.

Inputs are REALISTIC, not random: a seeded B-spline simulator run
(circle trajectory, EuRoC-default noise, 200 Hz IMU / 10 Hz cam /
20 Hz UWB, 4 biased anchors) drives the UVioManager host loop once,
capturing the exact per-frame FrameBundles it dispatches; the bench
then replays those bundles through one `lax.scan` (the offline/batch
deployment shape, amortizing host dispatch). chi2 gates see real
residuals, SLAM slots fill and re-anchor, UWB ranges accept/reject as
in a real run.

Precision: f32 compute / f64 time axis (validated on the simulator
against f64: same ATE, consistent NEES).

The measurement needs a GPU: on any other device it exits non-zero
without a result.
"""

import json
import subprocess
import sys
import time


def gpu_device_line():
    """(jax device, nvidia-smi name and power limit) of the first
    device; raises SystemExit when it is not a GPU — no fallback."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"needs an NVIDIA GPU; JAX found platform {dev.platform!r} "
            f"({dev.device_kind}). No fallback."
        )
    # nvidia-smi in a child process: this process keeps the only JAX
    # client on the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return dev, smi


def make_scan(full_cfg):
    """The jitted offline replay: `full_filter_step` scanned over a
    stacked FrameBundle sequence. Returns (final state, MSCKF rows used
    per frame)."""
    import jax

    from uvio_jax.pipeline import full_filter_step

    def run_chunk(state, fbs):
        def body(st, fb):
            st, infos = full_filter_step(st, fb, cfg=full_cfg)
            return st, infos["msckf"]["num_used"]

        return jax.lax.scan(body, state, fbs)

    return jax.jit(run_chunk)


def main():
    import uvio_jax  # noqa: F401  (x64 + cache config)
    import jax
    import jax.numpy as jnp

    from uvio_jax.eval.capture import capture_sim_bundles

    dev, smi = gpu_device_line()
    print(f"device: {dev.device_kind} x{len(jax.devices())} | {smi}", flush=True)

    T_WARM, T_BENCH = 20, 100  # captured frames: warmup prefix + bench window

    full_cfg, state0, bench_bundles = capture_sim_bundles(
        n_warm=T_WARM, n_bench=T_BENCH, seed=7, max_slam=25, dtype="float32"
    )
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *bench_bundles)

    run = make_scan(full_cfg)
    out_state, used = run(state0, stacked)
    jax.block_until_ready(out_state.cov)  # compile + warm

    n_rep = 5
    t0 = time.time()
    for _ in range(n_rep):
        out_state, used = run(state0, stacked)
    jax.block_until_ready(out_state.cov)
    fps = n_rep * T_BENCH / (time.time() - t0)

    print(
        json.dumps(
            {
                "metric": "full_frame_step_fps_per_chip",
                "value": round(fps, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps / 200.0, 3),
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                    "nvidia_smi": smi,
                },
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
