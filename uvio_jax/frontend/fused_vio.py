"""Fully device-resident image -> pose VIO step (one dispatch per frame).

The manager's host path (`manager.py`) mirrors the reference's
architecture: tracker output returns to the host, triage picks update
features, and a padded FrameBundle goes back to the device. That round
trip is the right shape for the full feature set (SLAM slots, UWB
drains, ZUPT), but it puts the host on the critical path of the
simplest deployment loop — mono MSCKF odometry from raw images.

This module fuses the whole frame into ONE jitted device step:

    image -> hist-eq -> pyramid -> pyramidal LK -> RANSAC -> FAST-9 ->
    grid top-N refill -> propagate+clone -> slot-ring track triage ->
    MSCKF update -> marginalize -> pose out

Track bookkeeping lives on device as a (N_tracks, K_clones) ring
history aligned with the state's clone slots: column k of `hist_uv` /
`hist_mask` holds each track's observation at clone slot k, so the
padded MSCKF obs tensor is a pure gather (no host in the loop).

Triage semantics (reference parity, `VioManager.cpp:366-500`):
  * LOST tracks (active but not tracked this frame) become MSCKF
    update candidates;
  * MAXTRACK tracks (observed at the clone about to be marginalized)
    are updated too, their measurements consumed (history cleared),
    and the track stays alive accumulating new observations;
  * the top `max_msckf_in_update` candidates by observation count are
    used (the reference sorts by track length the same way).

This is the path `benchmarks/image_pipeline.py` measures for the
one-GPU image->pose number; it is also usable directly for
lowest-latency mono odometry.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..cam import models as cam_models
from ..filter.ekf import marginalize_clone
from ..filter.propagator import NoiseManager, propagate_and_clone
from ..types.layout import StateLayout
from ..update.msckf import msckf_update
from .klt import (
    build_pyramid,
    fast_score,
    grid_detect,
    hist_equalize,
    lk_track,
    ransac_fundamental,
    refill_targets,
)


# named scopes of the step's stages, in order (device time outside them
# is track triage and slot refill)
STAGES = ("hist_eq", "pyramid", "lk", "ransac", "fast", "grid_detect",
          "propagate_clone", "msckf_update", "marginalize")


def make_fused_vio_step(
    layout: StateLayout,
    intrinsics,
    cam_model: int,
    *,
    num_features: int = 150,
    grid: Tuple[int, int] = (6, 8),
    levels: int = 4,
    half: int = 7,
    fast_thresh: float = 20.0,
    per_cell: int = 4,
    ransac_thresh: float = 2.0 / 450.0,
    noises: NoiseManager = None,
    gravity_mag: float = 9.81,
    integration: str = "rk4",
    sigma_pix: float = 1.0,
    chi2_mult: float = 1.0,
    max_msckf_in_update: int = 40,
):
    """Build (step_fn, make_carry).

    step_fn(state, carry, img, imu_t, imu_w, imu_a, stamp_time, key)
        -> (state, carry, info)    — jit this once, dispatch per frame.
    make_carry(img0) -> carry      — device-resident track state.

    `layout.num_cams` must be 1 (mono odometry path).
    """
    assert layout.num_cams == 1, "fused path is mono"
    noises = noises or NoiseManager()
    K = layout.max_clones
    N = num_features
    F = max_msckf_in_update
    intr = jnp.asarray(intrinsics, jnp.float32)

    def step(state, carry, img, imu_t, imu_w, imu_a, stamp_time, key):
        pyr_prev, uv, active, hist_uv, hist_mask = carry

        # ---- frontend ------------------------------------------------
        # unlike the tracker's stateless `_device_step`, the previous
        # frame's equalized PYRAMID is carried across frames: rebuilding
        # it was ~40% of the frontend cost for zero benefit. Each stage
        # runs under a named scope (STAGES) so a profiler trace of the
        # step attributes device time per stage.
        with jax.named_scope("hist_eq"):
            img_eq = hist_equalize(img)
        with jax.named_scope("pyramid"):
            pyr = build_pyramid(img_eq, levels)
        with jax.named_scope("lk"):
            uv_new, ok = lk_track(pyr_prev, pyr, uv, active, half=half)
        with jax.named_scope("ransac"):
            uvn1 = cam_models.undistort(intr, cam_model, uv)
            uvn2 = cam_models.undistort(intr, cam_model, uv_new)
            inl = ransac_fundamental(uvn1, uvn2, ok & active, key, ransac_thresh)
        tracked = active & ok & inl
        with jax.named_scope("fast"):
            score = fast_score(img_eq, fast_thresh)
        with jax.named_scope("grid_detect"):
            det_uv, det_ok = grid_detect(
                score, grid[0], grid[1], uv_new, tracked, per_cell=per_cell
            )

        # ---- propagate + stochastic clone ---------------------------
        ring_full = jnp.sum(state.clones_valid) >= K
        with jax.named_scope("propagate_clone"):
            state = propagate_and_clone(
                state, layout, imu_t, imu_w, imu_a, noises, gravity_mag,
                integration=integration, stamp_time=stamp_time,
            )
        h = state.clone_head
        # oldest slot (marginalized at the end of this frame once the
        # ring is full): the one the NEXT frame's clone would overwrite
        marg_slot = (h + 1) % K

        # ---- record this frame's observations -----------------------
        hist_uv = hist_uv.at[:, h].set(uv_new)
        hist_mask = hist_mask.at[:, h].set(tracked)

        # ---- triage: lost + maxtrack-at-marg ------------------------
        lost = active & ~tracked
        maxtrack = tracked & hist_mask[:, marg_slot] & ring_full
        cand = lost | maxtrack
        nobs = jnp.sum(hist_mask, axis=1)
        score = jnp.where(cand & (nobs >= 2), nobs, -1)
        _, sel = jax.lax.top_k(score, F)  # (F,) slot indices
        sel_ok = score[sel] > 0
        obs_uv = hist_uv[sel][:, :, None, :]  # (F,K,1,2)
        obs_mask = hist_mask[sel][:, :, None] & sel_ok[:, None, None]

        # ---- MSCKF update -------------------------------------------
        with jax.named_scope("msckf_update"):
            state, minfo = msckf_update(
                state, layout, cam_model, obs_uv, obs_mask,
                sigma_pix=sigma_pix, chi2_mult=chi2_mult,
            )

        # consume used candidates' measurements (reference: to_delete
        # after the update); maxtrack slots stay active and restart
        # their history from the next frame
        consumed = jnp.zeros((N,), bool).at[sel].set(sel_ok, mode="drop")
        hist_mask = hist_mask & ~consumed[:, None]
        active = tracked

        # ---- marginalize the oldest clone when the ring is full -----
        def do_marg(sh):
            s, hm = sh
            s = marginalize_clone(s, layout, marg_slot)
            return s, hm.at[:, marg_slot].set(False)

        with jax.named_scope("marginalize"):
            state, hist_mask = jax.lax.cond(
                ring_full, do_marg, lambda sh: sh, (state, hist_mask)
            )

        # ---- refill free slots from detections ----------------------
        tgt = refill_targets(~active, det_ok)
        uv_out = uv_new.at[tgt].set(det_uv, mode="drop")
        active = active.at[tgt].set(True, mode="drop")
        hist_uv = hist_uv.at[tgt, h].set(det_uv, mode="drop")
        hist_mask = hist_mask.at[tgt, h].set(True, mode="drop")

        carry = (pyr, uv_out, active, hist_uv, hist_mask)
        info = {
            "q": state.q, "p": state.p,
            "num_tracks": jnp.sum(active),
            "num_used": minfo["num_used"],
            "cov_ok": minfo["cov_ok"],
        }
        return state, carry, info

    def make_carry(img0):
        pyr0 = build_pyramid(hist_equalize(jnp.asarray(img0, jnp.float32)), levels)
        return (
            pyr0,
            jnp.zeros((N, 2), jnp.float32),
            jnp.zeros((N,), bool),
            jnp.zeros((N, K, 2), jnp.float32),
            jnp.zeros((N, K), bool),
        )

    return step, make_carry
