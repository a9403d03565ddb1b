#!/usr/bin/env python
"""Live host-loop throughput on one GPU.

Unlike bench.py (which replays pre-built FrameBundles inside one
lax.scan), this drives the actual deployment path: per-frame host
ingestion -> feature triage -> ONE fused device dispatch per frame
(`VioManager.feed_features`). Needs a GPU: on any other device it exits
without a result; its output names the device.

Replays the head-to-head "mono" streams so the number is directly
comparable to the reference's single-threaded CPU fps on identical
data. Prints one JSON line.

Usage: python benchmarks/live_loop.py [--seconds 45] [--out results/h2h_mono]
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def ensure_streams(out, seconds):
    """Dump the mono scenario streams with the reference driver if
    absent; fall back to the vendored copy when the reference isn't
    mounted."""
    if os.path.exists(os.path.join(out, "imu.csv")):
        return
    if not os.path.isdir("/root/reference"):
        import gzip
        import shutil

        src = os.path.join(REPO, "data", "streams", "mono")
        os.makedirs(out, exist_ok=True)
        for f in ("imu.csv", "cam.csv"):
            with gzip.open(os.path.join(src, f + ".gz"), "rb") as fin, \
                    open(os.path.join(out, f), "wb") as fout:
                shutil.copyfileobj(fin, fout)
        for f in ("init.txt", "gt.txt", "ref_est.txt"):
            shutil.copy(os.path.join(src, f), out)
        shutil.copytree(os.path.join(src, "config"),
                        os.path.join(out, "config"), dirs_exist_ok=True)
        return
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    code = (
        "import sys; sys.path.insert(0, %r); import head2head as h;"
        "h.build_reference();"
        "cdir = h.make_config('mono', h.SCENARIOS['mono']);"
        "h.run_reference('mono', cdir, %r)" % (os.path.join(REPO, "benchmarks"), seconds)
    )
    subprocess.run([sys.executable, "-c", code], check=True, env=env)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--out", default=os.path.join(REPO, "results", "h2h_mono"))
    ap.add_argument("--frames", type=int, default=0, help="cap frames (0 = all)")
    ap.add_argument(
        "--sync", action="store_true",
        help="force per-frame device sync (async pipelined dispatch is "
        "the default deployment mode; sync measures round-trip latency)",
    )
    ap.add_argument(
        "--dtype", default="float32",
        help="compute dtype (float32 = the deployment precision, validated "
        "ATE/NEES-equivalent to f64 on sim)",
    )
    args = ap.parse_args()
    ensure_streams(args.out, args.seconds)

    import uvio_jax  # noqa: F401  (x64, matmul precision, compile cache)
    import jax

    from bench import gpu_device_line
    from uvio_jax.manager import VioManager
    from uvio_jax.utils.config import load_config

    dev, smi = gpu_device_line()
    print(f"device: {dev.device_kind} | {smi}", flush=True)
    cfg, extras = load_config(os.path.join(args.out, "config"))
    cfg = dataclasses.replace(
        cfg, use_static_init=False, use_dynamic_init=False,
        async_dispatch=not args.sync, dtype=args.dtype,
    )
    mgr = VioManager(cfg)
    init = np.loadtxt(os.path.join(args.out, "init.txt"))
    mgr.initialize_with_gt(init[0], init[1:5], init[5:8], init[8:11],
                           init[11:14], init[14:17])

    imu = np.loadtxt(os.path.join(args.out, "imu.csv"), delimiter=",")
    cam = np.loadtxt(os.path.join(args.out, "cam.csv"), delimiter=",")
    frames = []
    tv, idx = np.unique(cam[:, 0], return_index=True)
    for t in tv[np.argsort(idx)]:
        rc = cam[cam[:, 0] == t]
        per_cam = [(rc[rc[:, 1] == c][:, 2].astype(np.int64), rc[rc[:, 1] == c][:, 3:5])
                   for c in range(len(cfg.cameras))]
        frames.append((float(t), per_cam))
    frames.sort(key=lambda f: f[0])

    frame_s = []
    stage_s = []  # (host build, dispatch, host post) from the manager
    pose_handles = []  # device arrays; published/fetched asynchronously
    fi = 0
    n_done = 0
    wall0 = None
    for k in range(imu.shape[0]):
        t = float(imu[k, 0])
        mgr.feed_imu(t, imu[k, 1:4], imu[k, 4:7])
        while fi + 1 < len(frames) and frames[fi + 1][0] <= t:
            ti, obs = frames[fi]
            if ti > float(init[0]):
                s0 = time.perf_counter()
                if wall0 is None:
                    wall0 = s0
                mgr.feed_features(ti, obs)
                frame_s.append(time.perf_counter() - s0)
                if mgr.last_timing is not None:
                    stage_s.append(
                        (mgr.last_timing["uwb"], mgr.last_timing["propagation"],
                         mgr.last_timing["marginalization"])
                    )
                pose_handles.append((ti, mgr.state.q, mgr.state.p))
                n_done += 1
            fi += 1
        if args.frames and n_done >= args.frames:
            break
    # drain: wait for the last dispatch, then batch-fetch all poses (the
    # deployment analog: an async publisher thread pulling results)
    jax.block_until_ready(mgr.state.cov)
    wall = time.perf_counter() - wall0
    poses = jax.device_get([(q, p) for (_, q, p) in pose_handles[-5:]])
    assert np.isfinite(poses[-1][1]).all()

    skip = min(25, len(frame_s) // 4)
    steady = np.asarray(frame_s[skip:])
    # async mode: per-call time is just host build+dispatch; the honest
    # throughput number is frames/wall including the final drain
    fps_wall = float((len(frame_s)) / wall)
    fps_call = float(1.0 / steady.mean())
    stages = np.asarray(stage_s[skip:]) if stage_s else np.zeros((1, 3))
    print(json.dumps({
        "metric": "live_loop_fps" + ("_sync" if args.sync else ""),
        "device": dev.device_kind,
        "value": round(fps_wall, 2),
        "unit": "frames/s",
        "frames": len(frame_s),
        "per_call_fps": round(fps_call, 2),
        "median_call_ms": round(float(np.median(steady) * 1e3), 2),
        "p90_call_ms": round(float(np.percentile(steady, 90) * 1e3), 2),
        "median_build_ms": round(float(np.median(stages[:, 0]) * 1e3), 2),
        "median_dispatch_ms": round(float(np.median(stages[:, 1]) * 1e3), 2),
        "median_post_ms": round(float(np.median(stages[:, 2]) * 1e3), 2),
    }))


if __name__ == "__main__":
    main()
