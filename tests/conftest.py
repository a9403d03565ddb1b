"""Test configuration: a deterministic 8-device virtual CPU mesh.

Sharding/pjit paths are validated on virtual CPU devices; numerics tests
want f64 CPU. Must run before jax initializes its backends, hence env
vars here. JAX_PLATFORMS set by the caller wins, so the `gpu`-marked
tests can run on the card (`JAX_PLATFORMS=cuda,cpu pytest -m gpu`).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import uvio_jax  # noqa: E402,F401  (enables x64)
