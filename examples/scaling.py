"""Scaling of the framework over a device mesh, on REAL workloads.

Two axes, matching SURVEY §2.6:

1. **Data-parallel filter scaling** — B independent VIO sequences run
   the FULL fused frame step (UWB drain + propagate/clone + MSCKF +
   SLAM + marginalize) vmapped and sharded over mesh axis "dp". Inputs
   are FrameBundles captured from a real simulated host loop
   (`uvio_jax.eval.capture`), not random tensors. Weak scaling: B = n
   devices, report sequence-frames/s and efficiency.

2. **Sharded bundle-adjustment strong scaling** — one fixed keyframe
   x landmark map refined by `parallel/ba.py` on a 2D ("kf", "lm")
   mesh; report solve time vs devices.

The committed table (`benchmarks/scaling_results.json`) is measured on
a virtual N-device CPU mesh. IMPORTANT caveat on reading it: the N
virtual devices SHARE one host's physical cores (a 1-device XLA:CPU run
already uses every core via intra-op parallelism), so NO speedup is
achievable by construction — the table measures the *partitioning +
collective overhead* of the sharded programs (lower is better), and
validates that the sharded programs compile, execute, and match the
unsharded math (equality is asserted in tests/test_ba.py). Real
scaling numbers need several GPUs (`chip_smoke.py --multi` runs the
same two programs on four); one-GPU throughput is bench.py's number.

`--multiproc` is a CPU-only demo: its gloo-connected child processes
are pinned to the CPU backend, and no GPU path runs it.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/scaling.py --write benchmarks/scaling_results.json
"""

import argparse
import json
import os
import time

import numpy as np

_CAPTURED = {}


def _bundles(T):
    """Capture (once) T real FrameBundles + warm state from a sim run."""
    if "data" not in _CAPTURED:
        from uvio_jax.eval.capture import capture_sim_bundles

        _CAPTURED["data"] = capture_sim_bundles(
            n_warm=15, n_bench=T, seed=7, max_slam=25, dtype="float32"
        )
    return _CAPTURED["data"]


def run_filter_dp(n_devices: int, T=40, n_rep=3):
    """Weak-scaling fused-full-step throughput: B = n_devices sequences."""
    import jax
    import jax.numpy as jnp
    from functools import partial
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from uvio_jax.pipeline import full_filter_step

    full_cfg, state0, bundles = _bundles(T)
    B = n_devices
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *bundles)  # (T, ...)
    batched = jax.tree.map(lambda x: jnp.stack([x] * B), stacked)  # (B,T,...)
    states = jax.tree.map(lambda x: jnp.stack([x] * B), state0)

    devs = np.array(jax.devices()[:n_devices])
    mesh = Mesh(devs, ("dp",))
    shard = NamedSharding(mesh, P("dp"))

    def chunk(states, fbs):
        def per_seq(s, f):
            def body(st, fb):
                st, infos = full_filter_step(st, fb, cfg=full_cfg)
                return st, infos["msckf"]["num_used"]

            return jax.lax.scan(body, s, f)

        return jax.vmap(per_seq)(states, fbs)

    run_c = jax.jit(chunk, in_shardings=(shard, shard), out_shardings=(shard, shard))
    states = jax.device_put(states, shard)
    batched = jax.device_put(batched, shard)
    out, _ = run_c(states, batched)
    jax.block_until_ready(out.cov)  # compile + warm

    t0 = time.time()
    for _ in range(n_rep):
        out, _ = run_c(states, batched)
    jax.block_until_ready(out.cov)
    wall = time.time() - t0
    return B * T * n_rep / wall  # sequence-frames per second


def run_ba_strong(n_devices: int, N=32, L=2048, iters=8, n_rep=3):
    """Strong-scaling sharded BA: one fixed map, more devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from uvio_jax.parallel.ba import BAOptions, ba_solve

    rng = np.random.default_rng(0)
    th = np.linspace(0, 2 * np.pi, N, endpoint=False)
    p = np.stack([3 * np.cos(th), 3 * np.sin(th), 0.1 * np.sin(2 * th)], axis=1)
    lm = rng.uniform(-1.5, 1.5, (L, 3))
    # cameras look at the origin
    from uvio_jax.math import rot_to_quat

    qs, Rs = [], []
    for k in range(N):
        z = -p[k] / np.linalg.norm(p[k])
        x = np.cross([0, 0, 1.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        Rs.append(np.stack([x, y, z]))
        qs.append(np.asarray(rot_to_quat(jnp.asarray(Rs[-1]))))
    q = np.stack(qs)
    R = np.stack(Rs)
    pc = np.einsum("nij,lnj->lni", R, lm[:, None, :] - p[None, :, :])
    mask = pc[..., 2] > 0.5
    obs = pc[..., :2] / np.where(np.abs(pc[..., 2:]) < 1e-3, 1e-3, pc[..., 2:])
    obs += 1e-3 * rng.standard_normal(obs.shape)
    lm0 = lm + 0.1 * rng.standard_normal(lm.shape)

    # prefer the LANDMARK axis: L >> N so lm-sharding balances better,
    # and the kf axis adds an all-gather of pose-block Jacobians per
    # iteration (measured: (2,1) kf-mesh 1.6 s vs (1,2) lm-mesh 0.97 s
    # at N=32/L=2048 on the virtual mesh). Split onto kf only past 4.
    kf_ax = 1 if n_devices <= 4 else 2
    mesh = (
        Mesh(
            np.array(jax.devices()[:n_devices]).reshape(kf_ax, n_devices // kf_ax),
            ("kf", "lm"),
        )
        if n_devices > 1
        else None
    )
    args = (jnp.asarray(q), jnp.asarray(p), jnp.asarray(lm0),
            jnp.asarray(obs), jnp.asarray(mask))
    opts = BAOptions(iters=iters)
    _, _, lmr, _ = ba_solve(*args, opts, mesh=mesh)
    jax.block_until_ready(lmr)  # compile + warm
    t0 = time.time()
    for _ in range(n_rep):
        _, _, lmr, info = ba_solve(*args, opts, mesh=mesh)
    jax.block_until_ready(lmr)
    return (time.time() - t0) / n_rep


def _multiproc_worker():
    """One process of the multi-process CPU demo: init jax.distributed
    from env, build the ("kf","lm") mesh (kf axis = process axis),
    run the sharded BA, and check the final cost against the
    single-process value shipped via env."""
    import jax

    from uvio_jax.parallel.distributed import (
        init_from_env, make_ba_mesh, print_comm_table,
    )

    assert init_from_env(), "UVIO_* env vars must be set for --worker"
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from uvio_jax.parallel.ba import BAOptions, ba_solve

    pid = jax.process_count(), jax.process_index()
    q, p, lm0, obs, mask, lm_true = _ba_problem(N=8, L=64)
    mesh = make_ba_mesh()
    # distributed arrays: every process holds the same full numpy
    # values; make_array_from_callback slices out each device's shard
    def dist(x, spec):
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(
            x.shape, sh, lambda idx: np.asarray(x)[idx]
        )

    args = (
        dist(q, P("kf")), dist(p, P("kf")), dist(lm0, P("lm")),
        dist(obs, P("lm", "kf")), dist(mask, P("lm", "kf")),
    )
    _, _, lmr, info = ba_solve(*args, BAOptions(iters=6), mesh=mesh)
    cost0, cost1 = float(info["costs"][0]), float(info["costs"][-1])
    expect = float(os.environ.get("UVIO_EXPECT_COST", "nan"))
    # cost floor is set by the injected 1e-3 obs noise; the decisive
    # check is agreement with the single-process solve
    ok = cost1 < cost0 * 0.05 and (
        np.isnan(expect) or abs(cost1 - expect) < 1e-6 + 1e-3 * abs(expect)
    )
    if jax.process_index() == 0:
        print(f"[multiproc] mesh {dict(zip(mesh.axis_names, mesh.devices.shape))} "
              f"procs={pid[0]} cost {cost0:.3e} -> {cost1:.3e} "
              f"(single-proc {expect:.3e}) {'OK' if ok else 'MISMATCH'}")
        print_comm_table(8, 64, mesh.devices.shape[0], mesh.devices.shape[1])
    assert ok
    jax.distributed.shutdown()


def _ba_problem(N=8, L=64, seed=3):
    rng = np.random.default_rng(seed)
    import jax.numpy as jnp

    from uvio_jax.math import rot_to_quat

    th = np.linspace(0, 2 * np.pi, N, endpoint=False)
    p = np.stack([3 * np.cos(th), 3 * np.sin(th), 0.1 * np.sin(2 * th)], axis=1)
    lm = rng.uniform(-1.5, 1.5, (L, 3))
    qs, Rs = [], []
    for k in range(N):
        z = -p[k] / np.linalg.norm(p[k])
        x = np.cross([0, 0, 1.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        Rs.append(np.stack([x, y, z]))
        qs.append(np.asarray(rot_to_quat(jnp.asarray(Rs[-1]))))
    q, R = np.stack(qs), np.stack(Rs)
    pc = np.einsum("nij,lnj->lni", R, lm[:, None, :] - p[None, :, :])
    mask = pc[..., 2] > 0.5
    obs = pc[..., :2] / np.where(np.abs(pc[..., 2:]) < 1e-3, 1e-3, pc[..., 2:])
    obs += 1e-3 * rng.standard_normal(obs.shape)
    lm0 = lm + 0.1 * rng.standard_normal(lm.shape)
    return q, p, lm0, obs, mask, lm


def run_multiproc(n_procs=2, local_devices=4):
    """Spawn an n-process gloo cluster on this host (each with
    `local_devices` virtual CPU devices) and run the sharded BA across
    them — the 2-process x 4-device demonstration of the multi-process
    path (kf axis across processes, lm axis within one). CPU only."""
    import socket
    import subprocess
    import sys

    import jax
    import jax.numpy as jnp

    from uvio_jax.parallel.ba import BAOptions, ba_solve

    # single-process reference value for the workers to check against
    q, p, lm0, obs, mask, _ = _ba_problem(N=8, L=64)
    _, _, _, info = ba_solve(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(lm0),
        jnp.asarray(obs), jnp.asarray(mask), BAOptions(iters=6),
    )
    expect = float(info["costs"][-1])

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(n_procs):
        env = dict(os.environ)
        env.update(
            UVIO_COORDINATOR=f"127.0.0.1:{port}",
            UVIO_NUM_PROCESSES=str(n_procs),
            UVIO_PROCESS_ID=str(pid),
            UVIO_EXPECT_COST=str(expect),
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=f"--xla_force_host_platform_device_count={local_devices}",
        )
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker"],
            env=env,
        ))
    rc = [pr.wait(timeout=600) for pr in procs]
    assert all(r == 0 for r in rc), f"multiproc demo failed: rc={rc}"
    print(f"multiproc demo: {n_procs} processes x {local_devices} devices OK")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="*", default=None)
    ap.add_argument("--write", type=str, default=None)
    ap.add_argument("--multiproc", action="store_true",
                    help="run the 2-process x 4-device multi-host demo")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        _multiproc_worker()
        return
    if args.multiproc:
        run_multiproc()
        return
    import jax

    nd = len(jax.devices())
    device_counts = args.devices or [n for n in (1, 2, 4, 8) if n <= nd]

    platform = jax.devices()[0].platform
    results = {
        "platform": platform,
        "filter_dp_seq_frames_per_s": {},
        "ba_strong_solve_s": {},
    }
    if platform == "cpu":
        results["note"] = (
            "virtual CPU mesh: the N devices share one host's physical "
            "cores, so no speedup is achievable by construction; this "
            "table measures partitioning+collective overhead of the "
            "sharded programs and validates they execute. Real scaling "
            "needs several GPUs."
        )
    for n in device_counts:
        results["filter_dp_seq_frames_per_s"][n] = run_filter_dp(n)
        results["ba_strong_solve_s"][n] = run_ba_strong(n)

    base_fps = results["filter_dp_seq_frames_per_s"][device_counts[0]]
    base_t = results["ba_strong_solve_s"][device_counts[0]]
    hdr = "" if platform != "cpu" else "  (shared-core virtual mesh: overhead table, no speedup achievable)"
    print(f"\n== full fused step, weak scaling (B = devices) [{platform}]{hdr} ==")
    print(f"{'devices':>8} {'seq-frames/s':>14} {'vs 1-dev':>9}")
    for n in device_counts:
        fps = results["filter_dp_seq_frames_per_s"][n]
        print(f"{n:>8} {fps:>14.1f} {fps / base_fps:>8.2f}x")
    print(f"\n== sharded BA (32 kf x 2048 lm), strong scaling [{platform}]{hdr} ==")
    print(f"{'devices':>8} {'solve (s)':>11} {'vs 1-dev':>9}")
    for n in device_counts:
        t = results["ba_strong_solve_s"][n]
        print(f"{n:>8} {t:>11.3f} {base_t / t:>8.2f}x")

    if args.write:
        with open(args.write, "w") as f:
            json.dump(results, f, indent=1)
        print(f"\nwrote {args.write}")


if __name__ == "__main__":
    main()
