"""Multi-host scaffolding (parallel/distributed.py): mesh construction,
comm-volume accounting, and (slow) the 2-process gloo demo."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_make_ba_mesh_single_process():
    import jax

    from uvio_jax.parallel.distributed import make_ba_mesh

    mesh = make_ba_mesh()
    n = len(jax.devices())
    assert mesh.axis_names == ("kf", "lm")
    assert int(np.prod(mesh.devices.shape)) == n
    # lm axis (the big reduced-camera-system psum) gets the larger share
    assert mesh.devices.shape[1] >= mesh.devices.shape[0]
    m2 = make_ba_mesh(n_kf_shards=1)
    assert m2.devices.shape == (1, n)


def test_comm_volume_table_scaling():
    from uvio_jax.parallel.distributed import comm_volume_table

    rows = comm_volume_table(N=256, L=4096, pk=2, pl=4)
    by = {r.phase: r for r in rows}
    # the reduced-camera-system psum dominates communication
    cam = by["psum reduced camera system"]
    assert cam.axis == "lm"
    assert cam.bytes_moved > by["psum per-landmark A,b_l"].bytes_moved
    # per-device landmark compute shrinks with more lm shards
    rows8 = comm_volume_table(N=256, L=4096, pk=2, pl=8)
    assert (
        {r.phase: r for r in rows8}["jacobians+hessians (local)"].flops
        < by["jacobians+hessians (local)"].flops
    )
    # single-device: no communication at all
    rows1 = comm_volume_table(N=256, L=4096, pk=1, pl=1)
    assert sum(r.bytes_moved for r in rows1) == 0.0


def test_init_from_env_noop_without_vars(monkeypatch):
    from uvio_jax.parallel import distributed as D

    for k in ("UVIO_COORDINATOR", "UVIO_NUM_PROCESSES", "UVIO_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert D.init_from_env() is False


@pytest.mark.slow
def test_multiproc_ba_demo():
    """2-process x 2-virtual-device gloo cluster (a CPU-only demo; the
    children are pinned to the CPU): the cross-process sharded BA must
    match the single-process solve (scaling.py worker asserts the cost
    agreement internally)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "scaling.py"),
         "--multiproc"],
        env=env, capture_output=True, text=True, timeout=900,
        cwd=REPO,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "multiproc demo" in r.stdout
