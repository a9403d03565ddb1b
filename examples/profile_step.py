"""Per-stage timing of the fused filter step on the current backend.

Times each jitted stage (marginalize / propagate+clone / msckf update)
separately, then the fused step and a 100-frame lax.scan chunk, to show
where the frame budget goes. Mirrors the reference's per-stage wall
timing (`VioManager.cpp:604-644`) at the kernel level.
"""

import time

import numpy as np


def timeit(fn, *args, iters=50, warmup=2):
    import jax

    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    import jax
    import jax.numpy as jnp

    import uvio_jax  # noqa: F401
    from functools import partial

    from uvio_jax.filter.ekf import marginalize_clone
    from uvio_jax.filter.propagator import propagate_and_clone
    from uvio_jax.pipeline import StepConfig, filter_step
    from uvio_jax.types import StateLayout, init_state
    from uvio_jax.types.state import oldest_clone_slot
    from uvio_jax.update.msckf import msckf_update

    print("backend:", jax.default_backend(), jax.devices()[0])
    layout = StateLayout(max_clones=12, max_imu_batch=24, max_slam=0)
    cfg = StepConfig(layout=layout, sigma_pix=1.0)
    F, K, C, M = 40, layout.max_clones, layout.num_cams, layout.max_imu_batch

    rng = np.random.default_rng(0)
    state = init_state(layout, dtype=jnp.float32)
    state = state.replace(
        time=jnp.asarray(0.0, jnp.float64),
        cov=jnp.asarray(np.eye(layout.dim) * 1e-4, jnp.float32),
        calib_cam_intr=jnp.asarray(
            np.tile([458.0, 458.0, 367.0, 248.0, 0, 0, 0, 0], (C, 1)), jnp.float32
        ),
    )
    imu_t = jnp.asarray(np.linspace(0.0, 0.1, M))
    imu_w = jnp.asarray(0.1 * rng.standard_normal((M, 3)), jnp.float32)
    imu_a = jnp.asarray(
        np.tile([0.0, 0.0, 9.81], (M, 1)) + 0.2 * rng.standard_normal((M, 3)), jnp.float32
    )
    uv = jnp.asarray(rng.uniform(100, 600, (F, K, C, 2)), jnp.float32)
    mask = jnp.asarray(rng.uniform(size=(F, K, C)) < 0.6)

    # fill the window first
    step = jax.jit(partial(filter_step, cfg=cfg))
    for i in range(K + 2):
        state, _ = step(state, imu_t + 0.1 * i, imu_w, imu_a, uv, mask)
    jax.block_until_ready(state.cov)

    marg = jax.jit(lambda s: marginalize_clone(s, layout, oldest_clone_slot(s, layout)))
    prop = jax.jit(
        partial(propagate_and_clone, layout=layout, noises=cfg.noises,
                gravity_mag=cfg.gravity_mag)
    )
    upd = jax.jit(
        partial(msckf_update, layout=layout, cam_model=cfg.cam_model,
                sigma_pix=cfg.sigma_pix, chi2_mult=cfg.chi2_mult)
    )

    t_marg = timeit(marg, state)
    sm = marg(state)
    t_prop = timeit(lambda s: prop(s, imu_t=imu_t + 100.0, imu_w=imu_w, imu_a=imu_a), sm)
    sp = prop(sm, imu_t=imu_t + 100.0, imu_w=imu_w, imu_a=imu_a)
    t_upd = timeit(lambda s: upd(s, obs_uv=uv, obs_mask=mask)[0], sp)
    t_step = timeit(lambda s: step(s, imu_t + 200.0, imu_w, imu_a, uv, mask)[0], state)

    # scan chunk
    T = 100
    ts = jnp.asarray(
        300.0 + np.arange(T)[:, None] * 0.1 + np.linspace(0, 0.1, M)[None, :]
    )
    ws = jnp.tile(imu_w[None], (T, 1, 1))
    as_ = jnp.tile(imu_a[None], (T, 1, 1))
    uvs = jnp.tile(uv[None], (T, 1, 1, 1, 1))
    masks = jnp.tile(mask[None], (T, 1, 1, 1))

    def chunk(s, frames):
        def body(st, fr):
            st, info = filter_step(st, *fr, cfg=cfg)
            return st, info["num_used"]

        return jax.lax.scan(body, s, frames)

    chunk_j = jax.jit(chunk)
    t_chunk = timeit(lambda s: chunk_j(s, (ts, ws, as_, uvs, masks))[0], state, iters=5)

    print(f"marginalize      {t_marg*1e3:8.3f} ms")
    print(f"propagate+clone  {t_prop*1e3:8.3f} ms")
    print(f"msckf update     {t_upd*1e3:8.3f} ms")
    print(f"fused step       {t_step*1e3:8.3f} ms (dispatch overhead incl.)")
    print(f"scan chunk/frame {t_chunk/T*1e3:8.3f} ms -> {T/t_chunk:.1f} fps")


if __name__ == "__main__":
    main()
