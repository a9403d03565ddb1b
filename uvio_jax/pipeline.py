"""Fused per-frame filter step — the flagship jittable "model".

One device-side function covering the reference's
`do_feature_propagate_update` hot path (`VioManager.cpp:323-714`):

    [marginalize-if-full] -> propagate+clone -> batched MSCKF update

The step is a pure function of (state, frame tensors) and is the unit
that gets jitted, vmapped over sequence batches (Monte-Carlo / dataset
evaluation — the reference's `error_dataset` many-runs use case), and
sharded over a device mesh (data-parallel axis "dp").
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .filter.ekf import marginalize_clone
from .filter.propagator import (
    NoiseManager,
    propagate_and_clone,
    propagate_mean_cov,
)
from .types.layout import StateLayout
from .types.state import FilterState, oldest_clone_slot
from .update.msckf import msckf_update


@dataclasses.dataclass(frozen=True)
class StepConfig:
    layout: StateLayout
    cam_model: int = 0
    sigma_pix: float = 1.0
    chi2_mult: float = 1.0
    gravity_mag: float = 9.81
    noises: NoiseManager = dataclasses.field(default_factory=NoiseManager)


def filter_step(
    state: FilterState,
    imu_t: jnp.ndarray,
    imu_w: jnp.ndarray,
    imu_a: jnp.ndarray,
    obs_uv: jnp.ndarray,
    obs_mask: jnp.ndarray,
    *,
    cfg: StepConfig,
):
    """One camera-frame step. imu_* padded (M,)/(M,3); obs (F,K,C,2)."""
    L = cfg.layout

    def marg(s):
        return marginalize_clone(s, L, oldest_clone_slot(s, L))

    state = jax.lax.cond(
        jnp.all(state.clones_valid), marg, lambda s: s, state
    )
    state = propagate_and_clone(
        state, L, imu_t, imu_w, imu_a, cfg.noises, cfg.gravity_mag
    )
    state, info = msckf_update(
        state,
        L,
        cfg.cam_model,
        obs_uv,
        obs_mask,
        sigma_pix=cfg.sigma_pix,
        chi2_mult=cfg.chi2_mult,
    )
    return state, info


# ----------------------------------------------------------------------
# Full fused frame step: the WHOLE of the reference's per-frame hot path
# (`UVioManager::track_image_and_update` + `do_feature_propagate_update`,
# UVioManager.cpp:114-205 / VioManager.cpp:323-714) as ONE jitted unit:
#
#   [ZUPT branch] -> [UWB drain scan] -> propagate+clone -> MSCKF ->
#   SLAM re-obs update -> SLAM delayed init -> [anchor change +
#   marginalize]
#
# The host builds the padded FrameBundle (feature triage, IMU windows,
# UWB set padding, marg decision) and makes ONE device dispatch per
# frame instead of 4-6 with host syncs between stages.
# ----------------------------------------------------------------------


class FrameBundle(NamedTuple):
    """Per-frame padded inputs for `full_filter_step`. All leading dims
    are static: M IMU samples, F msckf feats, S slam slots, Fc init
    candidates, U uwb range-sets (each with its own Mu-sample window)."""

    # propagation to the image time (camera-clock stamp; imu window
    # endpoints already shifted by the estimated camera-IMU offset)
    imu_t: jnp.ndarray  # (M,) f64
    imu_w: jnp.ndarray  # (M,3)
    imu_a: jnp.ndarray  # (M,3)
    stamp_time: jnp.ndarray  # scalar f64
    # MSCKF features (aligned to clone slots incl. the to-be-added one)
    msckf_uv: jnp.ndarray  # (F,K,C,2)
    msckf_mask: jnp.ndarray  # (F,K,C)
    # SLAM landmark re-observations (indexed by slam slot)
    slam_uv: jnp.ndarray  # (S,K,C,2)
    slam_mask: jnp.ndarray  # (S,K,C)
    # SLAM delayed-init candidates
    cand_uv: jnp.ndarray  # (Fc,K,C,2)
    cand_mask: jnp.ndarray  # (Fc,K,C)
    cand_slots: jnp.ndarray  # (Fc,) int32 target slam slots
    cand_ids: jnp.ndarray  # (Fc,) int32 feature ids, -1 = inactive
    # UWB range-sets to drain before the visual update (padding sets:
    # all-false masks + identity IMU windows)
    uwb_imu_t: jnp.ndarray  # (U,Mu) f64
    uwb_imu_w: jnp.ndarray  # (U,Mu,3)
    uwb_imu_a: jnp.ndarray  # (U,Mu,3)
    uwb_stamp: jnp.ndarray  # (U,) f64 camera-clock range-set times
    uwb_ranges: jnp.ndarray  # (U,A)
    uwb_mask: jnp.ndarray  # (U,A)
    # ZUPT attempt (host gates on disparity/only-at-beginning)
    zupt_try: jnp.ndarray  # scalar bool
    zupt_imu_t: jnp.ndarray  # (M,) f64
    zupt_imu_w: jnp.ndarray  # (M,3)
    zupt_imu_a: jnp.ndarray  # (M,3)
    # end-of-frame clone marginalization (host pre-decides the slot)
    marg_enable: jnp.ndarray  # scalar bool
    marg_slot: jnp.ndarray  # scalar int32


@dataclasses.dataclass(frozen=True)
class FullStepConfig:
    layout: StateLayout
    cam_model: int = 0
    sigma_pix: float = 1.0
    chi2_mult: float = 1.0
    gravity_mag: float = 9.81
    noises: NoiseManager = dataclasses.field(default_factory=NoiseManager)
    integration: str = "rk4"
    # SLAM
    max_slam_init_per_frame: int = 8
    # UWB (active when uwb_sets_per_frame > 0 and layout.max_anchors > 0)
    uwb_sets_per_frame: int = 0
    sigma_range: float = 0.1
    uwb_chi2_mult: float = 1.0
    # ZUPT (compiled in only when try_zupt)
    try_zupt: bool = False
    zupt_chi2_mult: float = 1.0
    zupt_noise_mult: float = 10.0
    zupt_max_velocity: float = 0.1
    # explicit zero-motion clone-pair constraint instead of the direct
    # inertial update (`UpdaterZeroVelocity.cpp:283-330`)
    zupt_explicit: bool = False


def _dummy_infos(cfg: FullStepConfig, F: int, S: int, Fc: int, U: int, A: int):
    b = jnp.bool_
    return {
        "msckf": {
            "tri_ok": jnp.zeros((F,), b),
            "kept": jnp.zeros((F,), b),
            "num_used": jnp.zeros((), jnp.int32),
            "cov_ok": jnp.ones((), b),
        },
        "slam_kept": jnp.zeros((S,), b),
        "slam_failed": jnp.zeros((S,), b),
        "slam_inited": jnp.zeros((Fc,), b),
        "uwb_accepted": jnp.zeros((U, A), b),
        "cov_ok": jnp.ones((), b),
    }


def full_filter_step(state: FilterState, fb: FrameBundle, *, cfg: FullStepConfig):
    """One complete camera-frame step (see module section comment).

    Returns (new_state, infos) where infos carries everything the host
    mirror needs: zupt_accepted, msckf kept/num_used, slam kept/failed/
    inited, uwb accepted, cov_ok."""
    L = cfg.layout
    F = fb.msckf_uv.shape[0]
    S = L.max_slam
    Fc = fb.cand_ids.shape[0]
    U = fb.uwb_ranges.shape[0] if cfg.uwb_sets_per_frame > 0 else 0
    A = getattr(L, "max_anchors", 0)

    from .update.slam import slam_delayed_init, slam_update

    # ---- ZUPT attempt (static compile-out when disabled) -------------
    if cfg.try_zupt:
        from .update.zupt import zupt_explicit_update, zupt_try_update

        def attempt(s):
            kwargs = dict(
                chi2_mult=cfg.zupt_chi2_mult, noise_mult=cfg.zupt_noise_mult,
                max_velocity=cfg.zupt_max_velocity, stamp_time=fb.stamp_time,
            )
            if cfg.zupt_explicit:
                s2, acc, _ = zupt_explicit_update(
                    s, L, fb.zupt_imu_t, fb.zupt_imu_w, fb.zupt_imu_a,
                    cfg.noises, cfg.gravity_mag,
                    integration=cfg.integration, **kwargs,
                )
            else:
                s2, acc, _ = zupt_try_update(
                    s, L, fb.zupt_imu_t, fb.zupt_imu_w, fb.zupt_imu_a,
                    cfg.noises, cfg.gravity_mag, **kwargs,
                )
            return s2, acc

        st_z, z_acc = jax.lax.cond(
            fb.zupt_try, attempt, lambda s: (s, jnp.zeros((), bool)), state
        )
    else:
        st_z, z_acc = state, jnp.zeros((), bool)

    def zupt_done(_):
        return st_z, _dummy_infos(cfg, F, S, Fc, U, A)

    def visual(_):
        st = state
        cov_ok = jnp.ones((), bool)

        # ---- UWB drain: per range-set propagate (no clone) + update --
        uwb_acc = jnp.zeros((U, A), bool)
        if U > 0 and A > 0:
            from .update.uwb import uwb_update

            def uwb_body(s, inp):
                it, iw, ia, ts, rr, rm = inp

                def work(s):
                    s, _ = propagate_mean_cov(
                        s, L, it, iw, ia, cfg.noises, cfg.gravity_mag,
                        integration=cfg.integration, stamp_time=ts,
                    )
                    s, info = uwb_update(
                        s, L, rr, rm,
                        sigma_range=cfg.sigma_range, chi2_mult=cfg.uwb_chi2_mult,
                    )
                    # Deliberate deviation from the reference: re-seed the
                    # IMU-state FEJ to the range-updated mean so the NEXT
                    # propagation's first-interval transition linearizes at
                    # the corrected state (the reference leaves FEJ at the
                    # pre-update mean). A/B on the uwb head-to-head stream:
                    # with refresh 0.015 m ATE, reference FEJ semantics
                    # 0.018 m (ref itself: 0.064 m). The clone/landmark
                    # FEJ — where first-estimates consistency lives — is
                    # untouched. (Before the skip-padding cond above, the
                    # capacity-padding sub-steps refreshed FEJ as a side
                    # effect; this makes it explicit — outputs bit-match
                    # the old step to ~1e-15.)
                    s = s.replace(q_fej=s.q, p_fej=s.p, v_fej=s.v)
                    return s, info["accepted"]

                # capacity-padding rows (no ranges, no time advance) skip
                # the whole propagate+update: the manager pads to the
                # static U capacity, and each padded sub-step otherwise
                # costs a full M-sample covariance propagation (~2 ms on
                # a CPU host — the uwb live-loop's dominant waste)
                return jax.lax.cond(
                    jnp.any(rm) | (ts > s.time),
                    work,
                    lambda s: (s, jnp.zeros((A,), bool)),
                    s,
                )

            st, uwb_acc = jax.lax.scan(
                uwb_body, st,
                (fb.uwb_imu_t, fb.uwb_imu_w, fb.uwb_imu_a,
                 fb.uwb_stamp, fb.uwb_ranges, fb.uwb_mask),
            )

        # ---- propagate + stochastic clone -----------------------------
        st = propagate_and_clone(
            st, L, fb.imu_t, fb.imu_w, fb.imu_a, cfg.noises,
            cfg.gravity_mag, integration=cfg.integration,
            stamp_time=fb.stamp_time,
        )

        # ---- MSCKF update ---------------------------------------------
        st, minfo = msckf_update(
            st, L, cfg.cam_model, fb.msckf_uv, fb.msckf_mask,
            sigma_pix=cfg.sigma_pix, chi2_mult=cfg.chi2_mult,
        )
        minfo = {**minfo, "num_used": jnp.asarray(minfo["num_used"], jnp.int32)}
        cov_ok = cov_ok & minfo["cov_ok"]

        # ---- SLAM re-obs update + delayed init ------------------------
        if S > 0:
            st, sinfo = slam_update(
                st, L, fb.slam_uv, fb.slam_mask, cfg.cam_model,
                sigma_pix=cfg.sigma_pix, chi2_mult=cfg.chi2_mult,
            )
            cov_ok = cov_ok & sinfo["cov_ok"]

            # delayed init gated on having candidates: the prep
            # (triangulation + GN refine + Jacobian build for Fc
            # candidates) is the expensive part and ran unconditionally
            # every frame; most frames have no free-slot candidates
            def do_init(s):
                s2, ii = slam_delayed_init(
                    s, L, fb.cand_uv, fb.cand_mask, fb.cand_slots,
                    fb.cand_ids, cfg.cam_model,
                    sigma_pix=cfg.sigma_pix, chi2_mult=cfg.chi2_mult,
                )
                return s2, ii["inited"]

            def skip_init(s):
                return s, jnp.zeros((Fc,), bool)

            st, slam_inited = jax.lax.cond(
                jnp.any(fb.cand_ids >= 0), do_init, skip_init, st
            )
            slam_kept, slam_failed = sinfo["kept"], sinfo["failed"]
        else:
            slam_kept = jnp.zeros((S,), bool)
            slam_failed = jnp.zeros((S,), bool)
            slam_inited = jnp.zeros((Fc,), bool)

        # ---- anchor change + clone marginalization --------------------
        def do_marg(s):
            if S > 0 and L.slam_rep != 0:
                from .update.representations import anchor_change

                s = anchor_change(
                    s, marg_slot=fb.marg_slot, new_slot=s.clone_head, layout=L
                )
            return marginalize_clone(s, L, fb.marg_slot)

        st = jax.lax.cond(fb.marg_enable, do_marg, lambda s: s, st)

        infos = {
            "msckf": minfo,
            "slam_kept": slam_kept,
            "slam_failed": slam_failed,
            "slam_inited": slam_inited,
            "uwb_accepted": uwb_acc,
            "cov_ok": cov_ok,
        }
        return st, infos

    new_state, infos = jax.lax.cond(z_acc, zupt_done, visual, None)
    infos["zupt_accepted"] = z_acc
    return new_state, infos


def make_full_step(cfg: FullStepConfig):
    """Jitted fused full-frame step."""
    return jax.jit(partial(full_filter_step, cfg=cfg))


def make_step(cfg: StepConfig):
    """Jitted single-sequence step."""
    return jax.jit(partial(filter_step, cfg=cfg))


def make_batched_step(cfg: StepConfig, mesh=None):
    """vmapped step over a leading sequence-batch axis, optionally
    sharded over mesh axis "dp" (multi-chip Monte-Carlo / dataset eval).
    """
    fn = jax.vmap(partial(filter_step, cfg=cfg))
    if mesh is None:
        return jax.jit(fn)
    from jax.sharding import NamedSharding, PartitionSpec as P

    shard = NamedSharding(mesh, P("dp"))
    return jax.jit(fn, in_shardings=shard, out_shardings=shard)


class HostPipeline:
    """Double-buffered host->device frame ingestion.

    The reference overlaps sensor ingestion with estimation via a
    detached camera-processing thread (`UVIOROS1Visualizer.cpp:72-114`).
    The array-program equivalent: while the device executes chunk k, a
    background thread stages chunk k+1's frame tensors onto the device
    (`jax.device_put`), so host IO/staging never blocks the device.

    Usage:
        pipe = HostPipeline(chunk_source)   # iterator of frame pytrees
        for staged in pipe:                 # staged already on device
            state, out = run_chunk(state, staged)
    """

    def __init__(self, chunks, device=None, depth: int = 2):
        import queue
        import threading

        import jax

        self._q = queue.Queue(maxsize=depth)
        self._device = device or jax.devices()[0]
        self._sentinel = object()

        def worker():
            try:
                for c in chunks:
                    self._q.put(jax.device_put(c, self._device))
            finally:
                self._q.put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._sentinel:
                return
            yield item
