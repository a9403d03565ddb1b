"""Multi-process scaffolding: `jax.distributed` launch + BA meshes.

The reference's only inter-process transport is ROS pub-sub over TCP
(`ov_msckf/src/ros/ROS1Visualizer.cpp:151+`, SURVEY §2.6); the JAX
equivalent is `jax.distributed.initialize` + XLA collectives (NCCL
between GPUs, gloo between CPU processes). This module provides:

* `init_from_env()` — environment-driven distributed launch with a
  graceful single-process fallback (no env vars -> no-op), so every
  entry point can call it unconditionally.
* `make_ba_mesh(n_kf_shards)` — a ("kf", "lm") mesh for the Schur BA
  (`parallel/ba.py`). The **lm axis** carries the per-iteration `psum`
  of the 6Nx6N reduced camera system, the big collective; the **kf
  axis** only moves the per-landmark-shard 3x3/3x1 Hessian blocks and
  the pose-block all-gather, far smaller. Across processes the kf axis
  is the process axis, so the big psum stays inside a process.
* `comm_volume_table(...)` — the analytic per-phase bytes-moved /
  flops table for one BA iteration, so scaling claims are checkable
  against the mesh layout instead of asserted.

Multi-process demo (2 hosts x 4 virtual CPU devices each) lives in
`examples/scaling.py --multiproc`; CPU cross-process collectives use
the gloo backend (`jax_cpu_collectives_implementation`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional


_ENV_COORD = "UVIO_COORDINATOR"  # e.g. "127.0.0.1:6780"
_ENV_NPROC = "UVIO_NUM_PROCESSES"
_ENV_PID = "UVIO_PROCESS_ID"


def init_from_env() -> bool:
    """Initialize `jax.distributed` from env vars; return whether a
    multi-process runtime is active.

    Env contract (mirrors the standard JAX launch set, but namespaced
    so single-process tools never trip on leftover cluster vars):

        UVIO_COORDINATOR   = "<addr>:<port>" of process 0
        UVIO_NUM_PROCESSES = total process count
        UVIO_PROCESS_ID    = this process's index [0, N)

    Without all three set this is a no-op (single-process). On CPU
    backends the gloo collectives implementation is selected so
    cross-process `psum`/`all_gather` actually work.
    """
    coord = os.environ.get(_ENV_COORD)
    nproc = os.environ.get(_ENV_NPROC)
    pid = os.environ.get(_ENV_PID)
    if not (coord and nproc and pid):
        return False
    import jax

    # NOTE: no jax.devices()/process_count() before initialize — any
    # backend-touching call here would pin a single-process runtime.
    # CPU multi-process collectives need gloo (GPUs use NCCL)
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    from jax._src import distributed as _dist

    if getattr(_dist.global_state, "client", None) is not None:
        return True  # already initialized
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(nproc),
        process_id=int(pid),
    )
    return True


def make_ba_mesh(n_kf_shards: Optional[int] = None):
    """Build the ("kf", "lm") mesh for the sharded Schur BA.

    Axis roles (one GN iteration, see `comm_volume_table`): the "lm"
    axis all-reduces the dense 6Nx6N reduced camera system every
    iteration — the dominant collective. The "kf" axis moves only
    per-landmark 3x3 Hessian partial sums and the (L/pl, N/pk, 3, 6)
    pose-block gather, ~N/pk times smaller. On one host whose devices
    are joined all to all (four GPUs over NVLink) the split follows the
    algorithm alone; across processes the kf axis is laid over the
    processes, so the big psum stays within one.

    Single-process: a regular 2D mesh over local devices
    (kf = n_kf_shards or the smallest prime factor, lm = rest).
    Multi-process: kf = process axis, lm = local device axis.
    """
    import jax
    import numpy as np
    from jax.sharding import Mesh

    if jax.process_count() > 1:
        # one kf shard per process; each process's local devices form
        # the lm axis. jax.devices() is globally ordered by process id,
        # so a (nproc, local) reshape puts the process boundary on the
        # kf axis exactly.
        nproc = jax.process_count()
        local = jax.local_device_count()
        devs = np.asarray(jax.devices()).reshape(nproc, local)
        return Mesh(devs, ("kf", "lm"))

    devs = np.asarray(jax.devices())
    n = len(devs)
    if n_kf_shards is None:
        n_kf_shards = 2 if n % 2 == 0 else 1
    assert n % n_kf_shards == 0, (n, n_kf_shards)
    return Mesh(devs.reshape(n_kf_shards, n // n_kf_shards), ("kf", "lm"))


@dataclass
class CommRow:
    phase: str
    axis: str
    bytes_moved: float  # per device per iteration
    flops: float  # per device per iteration (0 for pure collectives)


def comm_volume_table(N: int, L: int, pk: int, pl: int, dtype_bytes: int = 8):
    """Per-iteration communication vs compute for the 2D Schur BA.

    N keyframes, L landmarks, mesh (kf=pk, lm=pl). Ring-collective cost
    model: all-reduce moves 2(p-1)/p of the payload per device;
    all-gather moves (p-1)/p of the GATHERED size per device.

    Returns a list of CommRow + a `summary()`-style dict. The point of
    this table: the virtual-CPU-mesh overhead numbers are only
    interpretable against the actual bytes each collective moves — e.g.
    at N=256, L=4096, pk=2, pl=4 the "lm" psum of the 6Nx6N system
    moves ~28 MB/device/iter while the per-landmark compute is ~0.5
    GFLOP/device/iter, so on shared-core virtual devices the psum is
    pure overhead; over NVLink (450 GB/s each way) it is tens of
    microseconds of transfer (not measured).
    """
    rows = []
    Nl = N / pk  # keyframes per kf shard
    Ll = L / pl  # landmarks per lm shard

    # local residual/Jacobian + per-landmark Hessian build: per (lm, kf)
    # observation ~ 300 flops (2x6 + 2x3 jacobians, Huber, products)
    rows.append(CommRow("jacobians+hessians (local)", "-", 0.0, Ll * Nl * 300.0))
    # psum over kf of per-landmark A (3x3) and b_l (3)
    vol = Ll * 12 * dtype_bytes * 2 * (pk - 1) / max(pk, 1)
    rows.append(CommRow("psum per-landmark A,b_l", "kf", vol, 0.0))
    # all-gather over kf of Hpl (Ll, N, 3, 6), Hpp_diag (N,6,6), b_p (N,6)
    gathered = (Ll * N * 18 + N * 36 + N * 6) * dtype_bytes
    rows.append(CommRow("all-gather pose blocks", "kf", gathered * (pk - 1) / max(pk, 1), 0.0))
    # local Schur: S_l = sum_l B A^-1 B^T  ->  Ll * (6N)^2-ish products
    rows.append(CommRow("schur reduce (local)", "-", 0.0, Ll * (6 * N) ** 2 * 2.0 / N))
    # psum over lm of S (6N x 6N) + b (6N)
    vol = ((6 * N) ** 2 + 6 * N) * dtype_bytes * 2 * (pl - 1) / max(pl, 1)
    rows.append(CommRow("psum reduced camera system", "lm", vol, 0.0))
    # replicated solve (every device): chol of 6N
    rows.append(CommRow("camera solve (replicated)", "-", 0.0, (6 * N) ** 3 / 3.0))
    # landmark back-substitution (local)
    rows.append(CommRow("landmark backsub (local)", "-", 0.0, Ll * N * 40.0))
    return rows


def print_comm_table(N: int, L: int, pk: int, pl: int, dtype_bytes: int = 8):
    rows = comm_volume_table(N, L, pk, pl, dtype_bytes)
    print(f"BA comm/compute per iteration — N={N} kf, L={L} lm, mesh kf={pk} x lm={pl}")
    print(f"{'phase':<34}{'axis':<6}{'MB/device':>12}{'GFLOP/device':>14}")
    for r in rows:
        print(
            f"{r.phase:<34}{r.axis:<6}{r.bytes_moved / 1e6:>12.3f}"
            f"{r.flops / 1e9:>14.4f}"
        )
    tot_b = sum(r.bytes_moved for r in rows)
    tot_f = sum(r.flops for r in rows)
    print(f"{'TOTAL':<34}{'':<6}{tot_b / 1e6:>12.3f}{tot_f / 1e9:>14.4f}")
    return rows
