"""Device-resident fused image->pose step (frontend/fused_vio.py):
rendered images in, poses out, one jitted dispatch per frame."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


@pytest.mark.slow
def test_fused_vio_tracks_and_filters():
    from uvio_jax.eval.capture import gt_initial_state, render_image_stream
    from uvio_jax.filter.propagator import select_imu_readings_np
    from uvio_jax.frontend.fused_vio import make_fused_vio_step
    from uvio_jax.types import StateLayout

    sim, imgs, stamps, imu = render_image_stream(50, duration=12.0)
    cam = sim.params.cameras[0]
    layout = StateLayout(max_clones=11, max_imu_batch=32, max_slam=0)
    step, make_carry = make_fused_vio_step(
        layout, cam.intrinsics, cam.model, sigma_pix=2.0
    )
    jstep = jax.jit(step)

    st = gt_initial_state(sim, layout, stamps[0])
    carry = make_carry(imgs[0])
    key = jax.random.PRNGKey(0)
    cur = stamps[0]
    used_total = 0
    for i in range(1, len(imgs)):
        tt, ww, aa = select_imu_readings_np(
            imu[:, 0], imu[:, 1:4], imu[:, 4:7], cur, stamps[i],
            layout.max_imu_batch,
        )
        cur = stamps[i]
        key, sub = jax.random.split(key)
        st, carry, info = jstep(
            st, carry, jnp.asarray(imgs[i]), jnp.asarray(tt), jnp.asarray(ww),
            jnp.asarray(aa), jnp.asarray(stamps[i], jnp.float64), sub,
        )
        used_total += int(info["num_used"])
        assert bool(info["cov_ok"])
    g = sim.get_gt_state(stamps[len(imgs) - 1])
    perr = float(np.linalg.norm(np.asarray(st.p) - g["p_IinG"]))
    # tracker keeps its slots filled and the filter consumes features
    assert int(info["num_tracks"]) > 100
    assert used_total > 100
    # raw-image mono MSCKF over ~5 s: bounded drift
    assert perr < 0.5, perr
