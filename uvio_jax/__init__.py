"""uvio_jax — a UWB-aided visual-inertial estimation framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of the UVIO /
OpenVINS reference stack (MSCKF sliding-window VIO with SLAM landmarks,
zero-velocity updates, UWB range updates with online anchor calibration,
static/dynamic initialization, a B-spline simulator, and a trajectory
evaluation toolkit).

Design stance (vs. the C++/Eigen reference):
  * state is a fixed-layout array pytree with presence masks — no dynamic
    resizing; clone window is a slot ring buffer, landmarks/anchors are
    slot pools (static shapes => one XLA compilation per config);
  * per-feature loops (triangulation, Jacobians, nullspace projection,
    chi2 gating) are `vmap`-batched over padded track tensors;
  * the EKF propagate/update are fused dense kernels;
  * determinism comes for free (seeded, no thread nondeterminism).

Float64 is enabled at import: covariance algebra follows the reference in
double precision by default (`VioConfig.dtype`); the f32 deployment path
runs with full-precision f32 matmuls (see the matmul-precision pin below),
validated by NEES against the f64 path, and the image-plane frontend
kernels run in f32.
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

# On an NVIDIA GPU an f32 matmul may run in TF32, which keeps ~10 mantissa
# bits (about three decimal digits) — too few for the EKF covariance
# algebra (P Hᵀ products and Cholesky downdates of a covariance whose
# entries span many orders of magnitude lose positive definiteness).
# Force full-f32 matmuls globally. The image-plane frontend kernels
# contain no matmuls (FAST/LK are elementwise + small stencils), so this
# pin costs them nothing.
#
# NOTE: like jax_enable_x64 above, this mutates process-global jax config
# at import time — any other JAX code in the same process inherits both
# (documented in README "Numerics").
jax.config.update("jax_default_matmul_precision", "highest")

# XLA compiles are expensive; persist them across runs. JAX itself reads
# JAX_COMPILATION_CACHE_DIR, so when it is set nothing is overridden here;
# otherwise the cache sits at a fixed path in the checkout (part of the
# cache key, so it must not move between runs).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".jax_cache")),
    )
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

__version__ = "0.1.0"
