"""VIO manager: host orchestration around the jitted device pipeline.

Equivalent of `ov_msckf/src/core/VioManager.{h,cpp}` — builds the
layout/state, buffers IMU, ingests feature tracks (sim tracker or a
real frontend), and runs the per-frame pipeline of
`do_feature_propagate_update` (`VioManager.cpp:323-714`):

    propagate+clone -> feature triage -> MSCKF update
    -> [SLAM update/init, round 2] -> marginalize oldest clone

Device work (propagation scan, batched MSCKF update) is jitted once per
static layout; host work is O(features) dict bookkeeping per frame.

The clone window uses `max_clones + 1` ring slots: the reference lets
the window grow to N+1 between `augment_clone` and end-of-update
marginalization (`VioManager.cpp:584-597`); the extra slot gives the
same semantics with static shapes.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .cam import RADTAN
from .filter.ekf import marginalize_clone
from .filter.propagator import (
    NoiseManager,
    propagate_and_clone,
    select_imu_readings_np,
)
from .filter.ekf import marginalize_slam
from .frontend.database import FeatureDatabase
from .init.dynamic_init import DynamicInitOptions
from .init.static_init import StaticInitOptions, try_static_init
from .update.zupt import zupt_try_update
from .types.layout import StateLayout
from .types.state import FilterState, init_state, num_clones, oldest_clone_slot
from .update.msckf import msckf_update
from .update.slam import slam_delayed_init, slam_update


@dataclasses.dataclass
class CameraConfig:
    model: int = RADTAN
    intrinsics: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([458.0, 458.0, 367.0, 248.0, 0, 0, 0, 0.0])
    )
    q_ItoC: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.0, 0, 0, 1]))
    p_IinC: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))


@dataclasses.dataclass
class VioConfig:
    max_clones: int = 11
    max_slam: int = 0
    feat_rep_slam: int = 1  # representations.ANCHORED_MSCKF_INVERSE_DEPTH
    # delay (s) after initialization before SLAM features may be
    # initialized — prevents a bad first set of FEJ-frozen landmarks
    # (`dt_slam_delay` yaml key, VioManager.cpp:443-444)
    dt_slam_delay: float = 2.0
    max_msckf_in_update: int = 40
    max_slam_init_per_frame: int = 8
    slam_fail_marg: int = 2  # chi2 failures before landmark marginalization
    max_imu_batch: int = 64
    # mean/covariance integration method: "discrete" | "rk4" | "analytical"
    # (StateOptions::IntegrationMethod; rk4 and analytical share the
    # closed-form ACI2 F/G like the reference)
    integration: str = "rk4"
    gravity_mag: float = 9.81
    sigma_pix: float = 1.0
    chi2_mult: float = 1.0
    noises: NoiseManager = dataclasses.field(default_factory=NoiseManager)
    cameras: List[CameraConfig] = dataclasses.field(default_factory=lambda: [CameraConfig()])
    calib_cam_pose: bool = False
    calib_cam_intrinsics: bool = False
    calib_cam_timeoffset: bool = False
    # camera-IMU time offset seed value (`calib_camimu_dt` yaml key)
    camimu_dt: float = 0.0
    # IMU intrinsic calibration (StateOptions do_calib_imu_intrinsics /
    # do_calib_imu_g_sensitivity / imu_model, `StateOptions.h:41-56`)
    calib_imu_intrinsics: bool = False
    calib_imu_g_sensitivity: bool = False
    imu_model: int = 0  # 0 = kalibr, 1 = rpng
    # seed values (None = perfect/identity); 6-vec dw/da, 9-vec tg, quats
    imu_dw: np.ndarray = None
    imu_da: np.ndarray = None
    imu_tg: np.ndarray = None
    imu_gq: np.ndarray = None
    imu_aq: np.ndarray = None
    # compute precision for everything except the time axis
    dtype: str = "float64"
    # prior std-devs for online calibration states (when enabled) —
    # exactly the reference's startup covariance (`State.cpp:134-163`)
    calib_pose_prior_rot: float = 0.005  # rad (State.cpp:154)
    calib_pose_prior_pos: float = 0.015  # m (State.cpp:156)
    calib_intr_prior: float = 1.0  # focal/center px (State.cpp:161)
    calib_dist_prior: float = 0.005  # distortion coeffs (State.cpp:163)
    calib_dt_prior: float = 0.01  # s (State.cpp:150)
    calib_imu_dw_prior: float = 0.005  # Dw entries (State.cpp:138)
    calib_imu_da_prior: float = 0.008  # Da entries (State.cpp:139)
    calib_imu_tg_prior: float = 0.005  # g-sensitivity (State.cpp:141)
    calib_imu_th_prior: float = 0.005  # gyro/acc frame rot (State.cpp:144)
    # initialization
    use_static_init: bool = False
    init_options: StaticInitOptions = dataclasses.field(default_factory=StaticInitOptions)
    init_max_disparity: float = 10.0  # px, stillness check for no-jerk init
    use_dynamic_init: bool = False  # init_dyn_use
    dyn_init_options: "DynamicInitOptions" = None  # defaults applied in ctor
    # zero-velocity update
    try_zupt: bool = False
    zupt_chi2_mult: float = 1.0
    zupt_noise_mult: float = 10.0
    zupt_max_velocity: float = 0.1
    zupt_max_disparity: float = 0.5
    zupt_only_at_beginning: bool = False
    # explicit zero-motion clone-pair constraint variant
    # (`UpdaterZeroVelocity.cpp:283-330`)
    zupt_explicit: bool = False
    # run the whole frame (UWB drain + ZUPT + propagate/clone + MSCKF +
    # SLAM + marginalize) as ONE jitted device dispatch (pipeline.
    # full_filter_step). False = legacy staged path with one dispatch
    # and a host sync per stage (kept for per-stage timing/debugging).
    fused_step: bool = True
    # defer device synchronization in the fused per-frame step: dispatch
    # and return without fetching results, letting dispatches pipeline.
    # Hides dispatch/transfer latency and removes the per-frame
    # host-device round trip. Effective only when no host decision depends on the frame's
    # device results: max_slam == 0, try_zupt False, no UWB drained this
    # frame — otherwise the frame falls back to the synchronous path.
    # cov-health is checked on a deferred ~16-frame-old result; traveled
    # distance is not tracked (no UWB gate needs it in this mode).
    async_dispatch: bool = False
    # action on a corrupted covariance after an update (negative
    # diagonal or NaN): "raise" mirrors the reference's hard exit
    # (`StateHelper.cpp:102-113`), "warn" logs and keeps filtering,
    # "ignore" is silent.
    on_cov_fail: str = "raise"


class CovarianceError(RuntimeError):
    """Covariance diagonal went negative/NaN after an update — the
    filter state is corrupted (the reference exits the process here,
    `StateHelper::EKFUpdate`, `StateHelper.cpp:102-113`)."""


class VioManager:
    def _layout_extras(self) -> dict:
        """Extra StateLayout kwargs contributed by subclasses.

        The UWB manager adds anchor slots + the lever-arm calib state
        here so the layout is built correctly ONCE — the reference
        subclass similarly extends the state at construction
        (`UVioManager.cpp:26-55`) rather than rebuilding it.
        """
        return {}

    def __init__(self, cfg: VioConfig):
        self.cfg = cfg
        self.layout = StateLayout(
            max_clones=cfg.max_clones + 1,
            max_slam=cfg.max_slam,
            num_cams=len(cfg.cameras),
            calib_cam_timeoffset=cfg.calib_cam_timeoffset,
            calib_cam_pose=cfg.calib_cam_pose,
            calib_cam_intrinsics=cfg.calib_cam_intrinsics,
            calib_imu_intrinsics=cfg.calib_imu_intrinsics,
            calib_imu_g_sensitivity=cfg.calib_imu_g_sensitivity,
            imu_model=cfg.imu_model,
            slam_rep=cfg.feat_rep_slam,
            max_imu_batch=cfg.max_imu_batch,
            **self._layout_extras(),
        )
        self.dtype = getattr(jnp, cfg.dtype)
        s = init_state(self.layout, dtype=self.dtype)
        # seed calibration values from config
        s = s.replace(
            calib_cam_q=jnp.asarray(np.stack([c.q_ItoC for c in cfg.cameras]), self.dtype),
            calib_cam_p=jnp.asarray(np.stack([c.p_IinC for c in cfg.cameras]), self.dtype),
            calib_cam_intr=jnp.asarray(
                np.stack([c.intrinsics for c in cfg.cameras]), self.dtype
            ),
            calib_dt=jnp.asarray(cfg.camimu_dt, self.dtype),
        )
        # seed IMU intrinsic values from config (identity when None)
        if cfg.imu_dw is not None:
            s = s.replace(calib_imu_dw=jnp.asarray(cfg.imu_dw, self.dtype))
        if cfg.imu_da is not None:
            s = s.replace(calib_imu_da=jnp.asarray(cfg.imu_da, self.dtype))
        if cfg.imu_tg is not None:
            s = s.replace(calib_imu_tg=jnp.asarray(cfg.imu_tg, self.dtype))
        if cfg.imu_gq is not None:
            s = s.replace(calib_imu_gq=jnp.asarray(cfg.imu_gq, self.dtype))
        if cfg.imu_aq is not None:
            s = s.replace(calib_imu_aq=jnp.asarray(cfg.imu_aq, self.dtype))
        if cfg.calib_imu_intrinsics:
            from .filter.ekf import set_block_covariance

            L = self.layout
            blk = np.diag(
                [cfg.calib_imu_dw_prior**2] * 6
                + [cfg.calib_imu_da_prior**2] * 6
                + ([cfg.calib_imu_tg_prior**2] * 9 if cfg.calib_imu_g_sensitivity else [])
                + [cfg.calib_imu_th_prior**2] * 3
            )
            s = s.replace(
                cov=set_block_covariance(
                    s.cov, jnp.int32(L.imu_intr_off), jnp.asarray(blk, self.dtype)
                )
            )
        # seed priors for enabled calibration states (the reference puts
        # these in the initial covariance at construction)
        if cfg.calib_cam_pose or cfg.calib_cam_intrinsics or cfg.calib_cam_timeoffset:
            from .filter.ekf import set_block_covariance

            cov = s.cov
            L = self.layout
            if cfg.calib_cam_timeoffset:
                cov = set_block_covariance(
                    cov, jnp.int32(L.calib_dt_off),
                    jnp.asarray([[cfg.calib_dt_prior**2]], self.dtype),
                )
            if cfg.calib_cam_pose:
                blk = np.diag(
                    [cfg.calib_pose_prior_rot**2] * 3 + [cfg.calib_pose_prior_pos**2] * 3
                )
                for c in range(len(cfg.cameras)):
                    cov = set_block_covariance(
                        cov, jnp.int32(L.calib_cam_pose_off + 6 * c),
                        jnp.asarray(blk, self.dtype),
                    )
            if cfg.calib_cam_intrinsics:
                # focal/center at 1 px, distortion far tighter
                # (State.cpp:161-163: 1.0^2 vs 0.005^2)
                blk = np.diag(
                    [cfg.calib_intr_prior**2] * 4 + [cfg.calib_dist_prior**2] * 4
                )
                for c in range(len(cfg.cameras)):
                    cov = set_block_covariance(
                        cov, jnp.int32(L.calib_cam_intr_off + 8 * c),
                        jnp.asarray(blk, self.dtype),
                    )
            s = s.replace(cov=cov)
        self.state: FilterState = s
        self.db = FeatureDatabase()
        self.is_initialized = False
        # imu buffer (host)
        self._imu_t: List[float] = []
        self._imu_w: List[np.ndarray] = []
        self._imu_a: List[np.ndarray] = []
        # host mirror: clone slot -> timestamp
        self.slot_times: Dict[int, float] = {}
        self._head = -1
        self.last_timing = None
        self._timing_file = None
        # traveled distance since initialization, accumulated per visual
        # update (`VioManager.cpp:646-650`); gates UWB ingestion
        # (UVioManager.cpp:64-67 `distance > min_dist_to_use_uwb`)
        self.distance = 0.0
        self._last_update_p: Optional[np.ndarray] = None
        # host mirrors of state.time / state.calib_dt: both are
        # deterministic on the host (time = the stamp of the last
        # consumed measurement; dt changes only via the EKF when
        # timeoffset calib is on, refreshed after sync updates), so the
        # live loop needs no per-frame device->host scalar fetch for them
        self._time_host: Optional[float] = None
        self._dt_host: float = float(cfg.camimu_dt)
        # camera-IMU time offset applied at the last propagation
        # (`Propagator::last_prop_time_offset`, Propagator.cpp:54-64):
        # IMU windows are [t_state + dt_last, t_meas + dt_now] so a
        # changing dt estimate never skips or double-counts IMU samples.
        self._last_prop_dt: Optional[float] = None

        self._jit_prop = jax.jit(
            partial(propagate_and_clone, layout=self.layout, noises=cfg.noises,
                    gravity_mag=cfg.gravity_mag, integration=cfg.integration)
        )
        cam_model = cfg.cameras[0].model
        self._jit_msckf = jax.jit(
            partial(
                msckf_update,
                layout=self.layout,
                cam_model=cam_model,
                sigma_pix=cfg.sigma_pix,
                chi2_mult=cfg.chi2_mult,
            )
        )
        self._jit_marg = jax.jit(partial(marginalize_clone, layout=self.layout))
        # SLAM bookkeeping (host mirror of state.slam_id)
        self.slam_slot_by_fid: Dict[int, int] = {}
        self.slam_fail: Dict[int, int] = {}
        self.slam_consumed_t: Dict[int, float] = {}
        if cfg.max_slam > 0:
            self._jit_slam_up = jax.jit(
                partial(
                    slam_update,
                    layout=self.layout,
                    cam_model=cam_model,
                    sigma_pix=cfg.sigma_pix,
                    chi2_mult=cfg.chi2_mult,
                )
            )
            self._jit_slam_init = jax.jit(
                partial(
                    slam_delayed_init,
                    layout=self.layout,
                    cam_model=cam_model,
                    sigma_pix=cfg.sigma_pix,
                    chi2_mult=cfg.chi2_mult,
                )
            )
            self._jit_marg_slam = jax.jit(partial(marginalize_slam, layout=self.layout))

        # fused full-frame step (pipeline.full_filter_step): one device
        # dispatch per camera frame
        if cfg.fused_step:
            from .pipeline import FullStepConfig, make_full_step

            self._full_cfg = FullStepConfig(
                layout=self.layout,
                cam_model=cam_model,
                sigma_pix=cfg.sigma_pix,
                chi2_mult=cfg.chi2_mult,
                gravity_mag=cfg.gravity_mag,
                noises=cfg.noises,
                integration=cfg.integration,
                max_slam_init_per_frame=cfg.max_slam_init_per_frame,
                try_zupt=cfg.try_zupt,
                zupt_chi2_mult=cfg.zupt_chi2_mult,
                zupt_noise_mult=cfg.zupt_noise_mult,
                zupt_max_velocity=cfg.zupt_max_velocity,
                zupt_explicit=cfg.zupt_explicit,
                **self._full_step_extras(),
            )
            self._jit_full = make_full_step(self._full_cfg)

    # ------------------------------------------------------------------
    def _async_eligible(self) -> bool:
        """Extra per-frame gate on the async (no-sync) dispatch path.
        Subclasses veto it while a host mirror that only updates on the
        sync path is still load-bearing (UVioManager: the traveled-
        distance UWB ingestion gate)."""
        return True

    # ------------------------------------------------------------------
    def _check_cov_ok(self, cov_ok: bool, where: str):
        """Act on the device-side covariance health flag (negative
        diagonal / NaN after an update). Reference hard-exits
        (`StateHelper.cpp:102-113`); policy via cfg.on_cov_fail."""
        if cov_ok:
            return
        msg = (
            f"covariance diagonal negative/NaN after {where} at "
            f"t={float(self.state.time):.6f}"
        )
        if self.cfg.on_cov_fail == "raise":
            raise CovarianceError(msg)
        if self.cfg.on_cov_fail == "warn":
            import warnings

            warnings.warn(msg, RuntimeWarning)

    # ------------------------------------------------------------------
    def _full_step_extras(self) -> dict:
        """FullStepConfig kwargs contributed by subclasses (UWB)."""
        return {}

    def _collect_uwb_sets(self, t_img: float):
        """Range-sets to drain inside the fused step (<= U, oldest
        first); overflow is handled by the subclass. Base: none."""
        return []

    def _consume_uwb_sets(self, sets):
        """Remove drained sets from the subclass buffer. Base: no-op."""

    # ------------------------------------------------------------------
    def initialize_with_gt(self, t, q_GtoI, p, v, bg, ba, prior_std=None):
        """Groundtruth initialization (`VioManagerHelper.cpp:40-76`)."""
        if prior_std is None:
            # the reference's exact gt-init prior
            # (`VioManagerHelper.cpp:49-53`: base 0.02, q 0.017, p 0.05,
            # v 0.01; biases stay at the 0.02 base). The previous bg
            # seed here was 10x tighter than the reference's — the
            # filter resisted early gyro-bias corrections, visible as a
            # first-quarter rotation transient under aggressive motion.
            prior_std = np.concatenate(
                [
                    np.full(3, 0.017),  # theta (rad)
                    np.full(3, 0.05),  # p
                    np.full(3, 0.01),  # v
                    np.full(3, 0.02),  # bg
                    np.full(3, 0.02),  # ba
                ]
            )
        # set the IMU block prior; preserve any pre-seeded blocks
        # (anchor/extrinsic priors were installed at construction)
        cov = np.asarray(self.state.cov).copy()
        cov[:15, :] = 0.0
        cov[:, :15] = 0.0
        cov[:15, :15] = np.diag(prior_std**2)
        dt = self.dtype
        q = jnp.asarray(q_GtoI, dt)
        self.state = self.state.replace(
            time=jnp.asarray(float(t), jnp.float64),
            q=q, q_fej=q,
            p=jnp.asarray(p, dt), p_fej=jnp.asarray(p, dt),
            v=jnp.asarray(v, dt), v_fej=jnp.asarray(v, dt),
            bg=jnp.asarray(bg, dt), ba=jnp.asarray(ba, dt),
            cov=jnp.asarray(cov, dt),
        )
        self.is_initialized = True
        # SLAM delayed-init gate reference point (`startup_time`)
        self._startup_time = float(t)
        self._time_host = float(t)

    # ------------------------------------------------------------------
    def _try_static_init(self):
        opts = self.cfg.init_options
        if self.cfg.try_zupt:
            # ZUPT can hold a still platform: init during stillness without
            # waiting for a jerk, gated on image disparity instead
            # (InertialInitializer.cpp:102-147 dual-condition dispatch)
            opts = dataclasses.replace(opts, wait_for_jerk=False)
            if not self._window_disparity_small(opts.window_time):
                return False
        res = try_static_init(
            np.asarray(self._imu_t), np.stack(self._imu_w) if self._imu_w else np.zeros((0, 3)),
            np.stack(self._imu_a) if self._imu_a else np.zeros((0, 3)),
            opts,
        )
        if res is None:
            return False
        self.initialize_with_gt(
            res.time, res.q_GtoI, res.p, res.v, res.bg, res.ba, prior_std=res.prior_std
        )
        # tracks older than the init stamp reference pre-init poses: drop
        self.db.cleanup_older_than(res.time + 1e-9)
        # the init stamp is the end of the STILL window, up to window/2 in
        # the past — fast-forward by propagate+clone through the already-
        # seen frame times like the reference's init thread
        # (`VioManagerHelper.cpp:151-160` clone_rate decimation), keeping
        # every IMU window short enough for the static batch limit
        frame_times = sorted(
            {tt for f in self.db.features.values() for tt in f.times() if tt > res.time}
        )
        # estimate rows for the replayed (already-seen) frames, from the
        # init stamp onward — the reference emits state estimates for
        # these while fast-forwarding, so its "first estimate" predates
        # the decision frame by up to window/2 (recorders should consume
        # `init_replay_rows` for latency-comparable output)
        self.init_replay_rows = [
            (res.time, np.asarray(res.q_GtoI), np.asarray(res.p))
        ]
        if frame_times:
            rate = len(frame_times) // self.cfg.max_clones + 1
            for ft in frame_times[::rate]:
                self._propagate_clone(ft)
                self._marginalize(ft)
                self.init_replay_rows.append(
                    (ft, np.asarray(self.state.q), np.asarray(self.state.p))
                )
        return True

    def _try_dynamic_init(self, t: float) -> bool:
        """In-motion initialization (InertialInitializer dynamic path):
        gather the last `num_pose` frame times + feature tracks + IMU
        slices, run the shooting-MLE, gate on reprojection rmse."""
        from .cam import models as cam_models
        from .init.dynamic_init import result_to_state, solve_dynamic_init
        from .math import quat_to_rot

        opts = self.cfg.dyn_init_options or DynamicInitOptions()
        # rotation gate (init_dyn_min_deg): require accumulated gyro
        # rotation over the window before attempting (the reference sums
        # |w| dt in degrees, `DynamicInitializer.cpp:~110-130`)
        if opts.min_deg > 0 and self._imu_t:
            it = np.asarray(self._imu_t)
            iw = np.stack(self._imu_w)
            span0 = t - self.cfg.init_options.window_time
            sel = it >= span0
            if sel.sum() >= 2:
                dts = np.diff(it[sel])
                wn = np.linalg.norm(iw[sel][1:], axis=1)
                deg = np.degrees(np.sum(wn * np.clip(dts, 0, None)))
                if deg < opts.min_deg:
                    return False
        # frame times observed so far (from the db)
        all_times = sorted({tt for f in self.db.features.values() for tt in f.times()})
        if len(all_times) < opts.num_pose:
            return False
        span = self.cfg.init_options.window_time
        pose_times = [tt for tt in all_times if tt >= t - span]
        if len(pose_times) < opts.num_pose:
            return False
        # demand most of the window to be filled: short spans let the
        # biases absorb arbitrary error while still fitting reprojection
        if pose_times[-1] - pose_times[0] < 0.75 * span:
            return False
        idx = np.linspace(0, len(pose_times) - 1, opts.num_pose).astype(int)
        pose_times = [pose_times[i] for i in sorted(set(idx))]
        if len(pose_times) < opts.num_pose:
            return False
        if not self._imu_t or self._imu_t[0] > pose_times[0]:
            return False
        P = opts.num_pose
        M = self.layout.max_imu_batch * 4
        imu_t = np.zeros((P - 1, M))
        imu_w = np.zeros((P - 1, M, 3))
        imu_a = np.zeros((P - 1, M, 3))
        # pose times are camera-clock: shift IMU windows by the seeded
        # camera-IMU offset (the initializer uses t_img + t_off as well)
        dt0 = self._dt_host
        try:
            for i in range(P - 1):
                tt, ww, aa = select_imu_readings_np(
                    np.asarray(self._imu_t), np.stack(self._imu_w), np.stack(self._imu_a),
                    pose_times[i] + dt0, pose_times[i + 1] + dt0, M,
                )
                imu_t[i], imu_w[i], imu_a[i] = tt, ww, aa
        except (ValueError, AssertionError):
            return False
        # feature tracks at those pose times (cam 0), undistorted
        cam = self.cfg.cameras[0]
        F = opts.max_features
        obs = np.zeros((F, P, 2))
        mask = np.zeros((F, P), bool)
        count = 0
        for f in self.db.features.values():
            lst = f.obs.get(0, [])
            by_t = {o[0]: (o[1], o[2]) for o in lst}
            hits = [p for p, pt in enumerate(pose_times) if pt in by_t]
            if len(hits) < P - 1:
                continue
            for p in hits:
                obs[count, p] = by_t[pose_times[p]]
                mask[count, p] = True
            count += 1
            if count == F:
                break
        if count < opts.min_features:
            return False
        uvn = np.array(
            cam_models.undistort(
                jnp.asarray(cam.intrinsics), cam.model, jnp.asarray(obs.reshape(-1, 2))
            )
        ).reshape(F, P, 2)
        uvn[~mask] = 0.0
        R_ItoC = np.asarray(quat_to_rot(jnp.asarray(cam.q_ItoC)))
        out = solve_dynamic_init(
            jnp.asarray(imu_t), jnp.asarray(imu_w), jnp.asarray(imu_a),
            jnp.asarray(uvn), jnp.asarray(mask),
            jnp.asarray(R_ItoC), jnp.asarray(cam.p_IinC), opts,
        )
        if float(out["rmse_norm"]) > opts.max_reproj_rmse:
            return False
        # conditioning gate (init_dyn_min_rec_cond): accept only if the
        # IMU-state information block is well conditioned
        if float(out["rcond"]) < opts.min_rec_cond:
            return False
        # bias plausibility gates (an init that "explains" motion with a
        # huge accel bias is overfit, not initialized)
        p_sol = out["params"]
        if float(jnp.linalg.norm(p_sol["ba"])) > 0.5 or float(
            jnp.linalg.norm(p_sol["bg"])
        ) > 0.1:
            return False
        from .init.dynamic_init import result_to_state_first

        st = result_to_state_first(out["params"], opts)
        st["time"] = pose_times[0]
        # seeded prior stds, scaled by the reference's inflation knobs
        # (init_dyn_inflation_*; base sigmas chosen so the reference
        # defaults 10/10/100/100 reproduce the tuned values below)
        s_ori = 0.10 * np.sqrt(opts.inflation_ori / 10.0)
        s_vel = 0.30 * np.sqrt(opts.inflation_vel / 10.0)
        s_bg = 0.05 * np.sqrt(opts.inflation_bg / 100.0)
        s_ba = 0.20 * np.sqrt(opts.inflation_ba / 100.0)
        prior_std = np.concatenate(
            [
                np.full(2, s_ori),  # roll/pitch (gravity estimate quality)
                np.full(1, 1e-4),  # yaw pinned (frame definition)
                np.full(3, 1e-4),  # position (origin definition)
                np.full(3, s_vel),  # velocity
                np.full(3, s_bg),
                np.full(3, s_ba),
            ]
        )
        self.initialize_with_gt(
            st["time"], st["q_GtoI"], st["p"], st["v"], st["bg"], st["ba"],
            prior_std=prior_std,
        )
        # replay the window: clone at the first pose, then fast-forward
        # propagate+clone through the remaining pose times so the filter
        # starts with a full, well-conditioned clone window
        # (VioManagerHelper.cpp:111-166)
        if not hasattr(self, "_jit_clone_only"):
            from .filter.ekf import augment_clone

            self._jit_clone_only = jax.jit(partial(augment_clone, layout=self.layout))
        self.state = self._jit_clone_only(self.state, w_hat=jnp.zeros(3, self.dtype))
        K = self.layout.max_clones
        self._head = 0 if self._head < 0 else (self._head + 1) % K
        self.slot_times[self._head] = pose_times[0]
        # replay every frame time in the window (consecutive frames keep
        # IMU slices within max_imu_batch), marginalizing as we go.
        # NOTE: no `init_replay_rows` here — the reference's DYNAMIC init
        # stamps at the window END (`DynamicInitializer.cpp`), so its
        # estimate file has no backdated rows; emitting ours would make
        # the init-latency comparison asymmetric (the static path does
        # backdate, matching the reference's static behavior).
        replay = [tt for tt in all_times if pose_times[0] < tt <= t]
        for pt in replay:
            self._propagate_clone(pt)
            self._marginalize(pt)
        # drop observations older than the window start; keep the rest
        self.db.cleanup_older_than(pose_times[0] - 1e-9)
        return True

    def _try_zupt(self, t: float) -> bool:
        """IMU+disparity zero-velocity test; True = motion frozen."""
        if self.cfg.zupt_only_at_beginning and getattr(self, "_has_moved", False):
            return False
        if self.cfg.zupt_max_disparity > 0 and not self._disparity_small(t):
            return False
        t0 = self._time_host
        if t <= t0:
            return False
        tt, ww, aa, dt_now = self._select_imu_window(t)
        if not hasattr(self, "_jit_zupt"):
            if self.cfg.zupt_explicit:
                from .update.zupt import zupt_explicit_update

                zupt_fn = partial(
                    zupt_explicit_update, integration=self.cfg.integration
                )
            else:
                zupt_fn = zupt_try_update
            self._jit_zupt = jax.jit(
                partial(
                    zupt_fn,
                    layout=self.layout,
                    noises=self.cfg.noises,
                    gravity_mag=self.cfg.gravity_mag,
                    chi2_mult=self.cfg.zupt_chi2_mult,
                    noise_mult=self.cfg.zupt_noise_mult,
                    max_velocity=self.cfg.zupt_max_velocity,
                )
            )
        new_state, accepted, gamma = self._jit_zupt(
            self.state, imu_t=jnp.asarray(tt), imu_w=jnp.asarray(ww),
            imu_a=jnp.asarray(aa), stamp_time=jnp.asarray(t, jnp.float64),
        )
        # observability: the reference prints the zupt chi2 each attempt
        # (`UpdaterZeroVelocity.cpp` PRINT_DEBUG)
        self.last_zupt_info = {
            "accepted": bool(accepted),
            "gamma": float(gamma),
            "n_imu": int((np.asarray(tt) > np.asarray(tt)[0]).sum()) + 1,
        }
        if bool(accepted):
            self.state = new_state
            self._time_host = float(t)
            self._last_prop_dt = dt_now
            # consumed: observations at this frozen frame can't be used
            # later (no clone exists for t) — drop them
            self.db.cleanup_older_than(t + 1e-9)
            return True
        self._has_moved = True
        return False

    def _window_disparity_small(self, window: float) -> bool:
        """Mean feature displacement across the init window < threshold."""
        if not self._imu_t:
            return False
        t_new = self._imu_t[-1]
        t_old = t_new - window
        disps = []
        for f in self.db.features.values():
            for cam, lst in f.obs.items():
                if len(lst) < 2:
                    continue
                first = next((o for o in lst if o[0] >= t_old), None)
                last = lst[-1]
                if first is not None and last[0] > first[0]:
                    disps.append(np.hypot(last[1] - first[1], last[2] - first[2]))
        if not disps:
            return False
        return float(np.mean(disps)) < self.cfg.init_max_disparity

    def _disparity_small(self, t: float) -> bool:
        """Average track disparity between the two newest frames
        (FeatureHelper::compute_disparity semantics)."""
        prev = getattr(self, "_last_frame_t", None)
        if prev is None:
            return False
        disps = []
        for f in self.db.features.values():
            for cam, lst in f.obs.items():
                uv_now = [o for o in lst if abs(o[0] - t) < 1e-9]
                uv_prev = [o for o in lst if abs(o[0] - prev) < 1e-9]
                if uv_now and uv_prev:
                    du = uv_now[0][1] - uv_prev[0][1]
                    dv = uv_now[0][2] - uv_prev[0][2]
                    disps.append(np.hypot(du, dv))
        if not disps:
            return False
        return float(np.mean(disps)) < self.cfg.zupt_max_disparity

    def feed_imu(self, t: float, w: np.ndarray, a: np.ndarray):
        self._imu_t.append(float(t))
        self._imu_w.append(np.asarray(w))
        self._imu_a.append(np.asarray(a))
        if not self.is_initialized:
            # bound the pre-init buffer to ~3 init windows
            horizon = 3.0 * self.cfg.init_options.window_time
            while self._imu_t and self._imu_t[0] < t - horizon:
                self._imu_t.pop(0)
                self._imu_w.pop(0)
                self._imu_a.pop(0)

    # ------------------------------------------------------------------
    def feed_features(self, t: float, cam_obs: List[Tuple[np.ndarray, np.ndarray]]):
        """Ingest one frame of tracked features and run the pipeline.

        cam_obs: per camera, (ids (N,), uvs (N,2)) — the TrackSIM path
        (`feed_measurement_simulation`); a real frontend feeds the same.
        """
        for cam, (ids, uvs) in enumerate(cam_obs):
            for i, fid in enumerate(ids):
                self.db.update_feature(int(fid), t, cam, float(uvs[i, 0]), float(uvs[i, 1]))
        if not self.is_initialized:
            if self.cfg.use_static_init and self._try_static_init():
                return
            if self.cfg.use_dynamic_init:
                self._try_dynamic_init(t)
            return
        if t <= self._time_host:
            # out-of-order frame: warn + drop (`VioManager.cpp:329-334`)
            from .utils.logger import print_warning

            print_warning(
                "image at t=%.6f is older than state time %.6f: dropped",
                t,
                self._time_host,
            )
            return
        if self.cfg.fused_step:
            self._frame_fused(t)
            return
        if self.cfg.try_zupt and self._try_zupt(t):
            self._last_frame_t = t
            return  # motion frozen: no clone, no visual update this frame
        import time as _time

        t0 = _time.perf_counter()
        self._pre_visual_update(t)
        t1 = _time.perf_counter()
        self._propagate_clone(t)
        jax.block_until_ready(self.state.cov)
        t2 = _time.perf_counter()
        self._msckf_step(t)
        jax.block_until_ready(self.state.cov)
        t3 = _time.perf_counter()
        if self.cfg.max_slam > 0:
            self._slam_step(t)
            jax.block_until_ready(self.state.cov)
        t4 = _time.perf_counter()
        self._marginalize(t)
        t5 = _time.perf_counter()
        if self.cfg.calib_cam_timeoffset:
            self._dt_host = float(self.state.calib_dt)
        # per-stage wall times (the reference's timing CSV,
        # VioManager.cpp:604-644); seconds per stage
        self.last_timing = {
            "timestamp": t,
            "uwb": t1 - t0,
            "propagation": t2 - t1,
            "msckf": t3 - t2,
            "slam": t4 - t3,
            "marginalization": t5 - t4,
            "total": t5 - t0,
        }
        if self._timing_file is not None:
            row = self.last_timing
            self._timing_file.write(
                f"{row['timestamp']:.9f},{row['uwb']:.6f},{row['propagation']:.6f},"
                f"{row['msckf']:.6f},{row['slam']:.6f},{row['marginalization']:.6f},"
                f"{row['total']:.6f}\n"
            )
        self._last_frame_t = t
        self._time_host = float(t)
        self._track_distance()

    def _track_distance(self):
        """Accumulate traveled distance after a completed visual update
        (`VioManager.cpp:646-650`)."""
        p = np.asarray(self.state.p)
        if self._last_update_p is not None:
            self.distance += float(np.linalg.norm(p - self._last_update_p))
        self._last_update_p = p

    # ------------------------------------------------------------------
    def _frame_fused(self, t: float):
        """One-dispatch frame: build the padded FrameBundle on host,
        run `pipeline.full_filter_step`, then update the host mirrors
        from the returned infos. Covers the same work as the staged
        path (`do_feature_propagate_update` + UWB drain + ZUPT)."""
        import time as _time

        from .pipeline import FrameBundle

        t0h = _time.perf_counter()
        L, cfg = self.layout, self.cfg
        K, C, S = L.max_clones, L.num_cams, L.max_slam
        M = L.max_imu_batch
        Fc = cfg.max_slam_init_per_frame
        U = self._full_cfg.uwb_sets_per_frame
        A = getattr(L, "max_anchors", 0)

        dt_now = self._dt_host
        if self._last_prop_dt is None:
            self._last_prop_dt = dt_now
        # collect UWB sets BEFORE capturing the propagation cursor: on
        # overflow the staged fallback drain propagates the state forward,
        # and every window below must start from the post-drain state time
        # (otherwise the drained IMU interval would be integrated twice)
        sets = self._collect_uwb_sets(t)
        cursor = self._time_host
        dt_last = self._last_prop_dt

        imu_t_arr = np.asarray(self._imu_t)
        imu_w_arr = np.stack(self._imu_w)
        imu_a_arr = np.stack(self._imu_a)

        # ---- ZUPT host gates + window ---------------------------------
        zupt_try = False
        zt = np.full(M, cursor)
        zw = np.zeros((M, 3))
        za = np.zeros((M, 3))
        if cfg.try_zupt:
            zupt_try = not (
                cfg.zupt_only_at_beginning and getattr(self, "_has_moved", False)
            )
            if zupt_try and cfg.zupt_max_disparity > 0 and not self._disparity_small(t):
                zupt_try = False
            if zupt_try:
                zt, zw, za = select_imu_readings_np(
                    imu_t_arr, imu_w_arr, imu_a_arr,
                    cursor + dt_last, max(t + dt_now, cursor + dt_last + 1e-9), M,
                )

        # ---- UWB range-set windows ------------------------------------
        u_t = np.full((U, M), cursor)
        u_w = np.zeros((U, M, 3))
        u_a = np.zeros((U, M, 3))
        u_stamp = np.full(U, cursor)
        u_r = np.zeros((U, A))
        u_m = np.zeros((U, A), bool)
        ucursor, udt_last = cursor, dt_last
        for k, (t_u, ranges) in enumerate(sets):
            if t_u > ucursor:
                u_t[k], u_w[k], u_a[k] = select_imu_readings_np(
                    imu_t_arr, imu_w_arr, imu_a_arr,
                    ucursor + udt_last,
                    max(t_u + dt_now, ucursor + udt_last + 1e-9), M,
                )
                u_stamp[k] = t_u
                ucursor, udt_last = t_u, dt_now
            else:
                u_t[k] = np.full(M, ucursor)
                u_stamp[k] = ucursor
            for aid, dist in ranges.items():
                slot = self.anchor_slot_by_id[aid]
                u_r[k, slot] = dist
                u_m[k, slot] = True
        # padding rows keep the running cursor so masked-out sets never
        # rewind the device state timestamp mid-step
        u_stamp[len(sets):] = ucursor
        u_t[len(sets):] = ucursor

        # ---- main propagation window ----------------------------------
        tt, ww, aa = select_imu_readings_np(
            imu_t_arr, imu_w_arr, imu_a_arr,
            ucursor + udt_last, max(t + dt_now, ucursor + udt_last + 1e-9), M,
        )

        # ---- tentative ring advance (rolled back on ZUPT accept) ------
        new_head = 0 if self._head < 0 else (self._head + 1) % K
        saved_slots, saved_head = dict(self.slot_times), self._head
        self._head = new_head
        self.slot_times[new_head] = t

        marg_enable = len(self.slot_times) > cfg.max_clones
        marg_slot = (
            min(self.slot_times, key=self.slot_times.get) if marg_enable else 0
        )
        marg_t = self.slot_times.get(marg_slot) if marg_enable else None

        # ---- SLAM maintenance: drop dead-track landmarks (rare
        # separate dispatches, like the reference's should_marg flags)
        if S > 0:
            # Reference lifetime semantics (`VioManager.cpp:460-481`): a
            # landmark is marginalized when its feature is GONE FROM THE
            # DATABASE (feat2 == nullptr — i.e. its last observation has
            # aged out of the clone window), not the first frame its
            # track misses. A briefly-occluded / FOV-edge-flickering
            # feature therefore resumes as the SAME landmark instead of
            # re-initializing — measurably better yaw anchoring on
            # turning trajectories (stereo corridor h2h).
            horizon = min(self.slot_times.values()) if self.slot_times else t
            for fid in list(self.slam_slot_by_fid):
                f = self.db.features.get(fid)
                if f is None or f.newest_time() < horizon:
                    self._free_landmark(fid)
                    if f is not None:
                        f.to_delete = True
            self.db.cleanup()

        # ---- feature triage -> padded obs tensors ----------------------
        feats = self._select_msckf_feats(t)
        uv_m, mask_m = self._build_obs(feats)

        time_to_slot = {tt_: s for s, tt_ in self.slot_times.items()}
        uv_s = np.zeros((S, K, C, 2))
        mask_s = np.zeros((S, K, C), bool)
        slam_any_obs = False
        for fid, slot in self.slam_slot_by_fid.items():
            f = self.db.features.get(fid)
            cons = self.slam_consumed_t.get(fid, -np.inf)
            for cam, lst in f.obs.items():
                for (tt_, u, v) in lst:
                    s = time_to_slot.get(tt_)
                    if s is not None and tt_ > cons:
                        uv_s[slot, s, cam] = (u, v)
                        mask_s[slot, s, cam] = True
                        slam_any_obs = True

        cands = self._slam_candidates(t) if S > 0 else []
        uv_c = np.zeros((Fc, K, C, 2))
        mask_c = np.zeros((Fc, K, C), bool)
        slots_c = np.zeros(Fc, np.int32)
        fids_c = np.full(Fc, -1, np.int32)
        if cands:
            used = set(self.slam_slot_by_fid.values())
            free_slots = [s for s in range(S) if s not in used]
            for i, f in enumerate(cands[: min(len(free_slots), Fc)]):
                slots_c[i] = free_slots[i]
                fids_c[i] = f.feat_id
                for cam, lst in f.obs.items():
                    for (tt_, u, v) in lst:
                        s = time_to_slot.get(tt_)
                        if s is not None:
                            uv_c[i, s, cam] = (u, v)
                            mask_c[i, s, cam] = True

        # numpy leaves throughout: jit device-puts the whole bundle in one
        # batched transfer at dispatch; per-leaf jnp.asarray costs ~2 ms
        # of host time per frame (measured) for zero benefit
        fb = FrameBundle(
            imu_t=tt, imu_w=ww, imu_a=aa,
            stamp_time=np.float64(t),
            msckf_uv=uv_m, msckf_mask=mask_m,
            slam_uv=uv_s, slam_mask=mask_s,
            cand_uv=uv_c, cand_mask=mask_c,
            cand_slots=slots_c, cand_ids=fids_c,
            uwb_imu_t=u_t, uwb_imu_w=u_w,
            uwb_imu_a=u_a, uwb_stamp=u_stamp,
            uwb_ranges=u_r, uwb_mask=u_m,
            zupt_try=np.bool_(zupt_try),
            zupt_imu_t=zt, zupt_imu_w=zw,
            zupt_imu_a=za,
            marg_enable=np.bool_(marg_enable),
            marg_slot=np.int32(marg_slot),
        )
        t1h = _time.perf_counter()

        # ---- ONE device dispatch ---------------------------------------
        self.state, infos = self._jit_full(self.state, fb)

        # async mode: no host decision depends on this frame's device
        # results — skip the sync entirely and let dispatches pipeline
        # (hides device round-trip latency; see VioConfig.async_dispatch)
        if (
            cfg.async_dispatch
            and S == 0
            and not cfg.try_zupt
            and self._async_eligible()
        ):
            t2h = _time.perf_counter()
            if not hasattr(self, "_pending_infos"):
                self._pending_infos = []
            self._pending_infos.append((t, infos["cov_ok"]))
            if len(self._pending_infos) >= 32:
                # check the NEWEST pending flag and drop the batch: cov
                # corruption persists (NaN stays NaN), and even a fetch
                # of a long-finished scalar costs a full device round
                # trip — one per 32 frames instead of one per frame
                t_old, ok_old = self._pending_infos[-1]
                self._pending_infos.clear()
                self._check_cov_ok(
                    bool(ok_old), f"fused frame step (deferred, t={t_old:.3f})"
                )
                # piggyback the host mirrors that only refresh on the
                # sync path onto this already-paid round trip: the EKF
                # moves calib_dt while the host builds IMU windows from
                # the stale mirror, and traveled distance feeds the UWB
                # ingestion gate (UVioManager.cpp:64-67)
                if cfg.calib_cam_timeoffset:
                    self._dt_host = float(self.state.calib_dt)
                self._track_distance()
            self.last_msckf_info = infos["msckf"]  # device arrays, lazy
            if sets:
                # in-step UWB drain bookkeeping is host-deterministic:
                # nothing below needs the device's accept flags
                self.last_uwb_info = {"accepted": infos["uwb_accepted"]}
                self._consume_uwb_sets(sets)
            self._last_prop_dt = dt_now
            for f in feats:
                f.to_delete = True
            self.db.cleanup()
            if marg_enable:
                self.slot_times.pop(marg_slot, None)
                self.db.cleanup_older_than(marg_t + 1e-9)
            while len(self._imu_t) > 2 and self._imu_t[1] < t - 0.2:
                self._imu_t.pop(0)
                self._imu_w.pop(0)
                self._imu_a.pop(0)
            t3h = _time.perf_counter()
            self._record_fused_timing(t, t1h - t0h, t2h - t1h, t3h - t2h)
            self._last_frame_t = t
            self._time_host = float(t)
            return

        jax.block_until_ready(self.state.cov)
        t2h = _time.perf_counter()

        z_acc = bool(infos["zupt_accepted"])
        if cfg.try_zupt and zupt_try and not z_acc:
            self._has_moved = True
        if z_acc:
            # motion frozen: no clone/update happened on device
            self.slot_times, self._head = saved_slots, saved_head
            self._time_host = float(t)
            self._last_prop_dt = dt_now
            self.db.cleanup_older_than(t + 1e-9)
            self._last_frame_t = t
            self._record_fused_timing(t, t1h - t0h, t2h - t1h, 0.0)
            return

        self._check_cov_ok(bool(infos["cov_ok"]), "fused frame step")
        self.last_msckf_info = infos["msckf"]
        self.last_uwb_info = {"accepted": infos["uwb_accepted"]}
        self._consume_uwb_sets(sets)
        self._last_prop_dt = dt_now
        if cfg.calib_cam_timeoffset:
            # the EKF moved the dt estimate; refresh the host mirror
            self._dt_host = float(self.state.calib_dt)

        # msckf features consumed
        for f in feats:
            f.to_delete = True
        self.db.cleanup()

        # slam bookkeeping from infos
        if S > 0:
            if slam_any_obs:
                failed = np.asarray(infos["slam_failed"])
                for fid in list(self.slam_slot_by_fid):
                    slot = self.slam_slot_by_fid[fid]
                    self.slam_consumed_t[fid] = t
                    if failed[slot]:
                        self.slam_fail[fid] = self.slam_fail.get(fid, 0) + 1
                        if self.slam_fail[fid] >= cfg.slam_fail_marg:
                            f = self.db.features.get(fid)
                            if f is not None:
                                f.to_delete = True
                            self._free_landmark(fid)
                self.db.cleanup()
            inited = np.asarray(infos["slam_inited"])
            for i in range(Fc):
                if fids_c[i] >= 0 and inited[i]:
                    self.slam_slot_by_fid[int(fids_c[i])] = int(slots_c[i])
                    self.slam_consumed_t[int(fids_c[i])] = t

        # marginalization mirror (device already did anchor change + marg)
        if marg_enable:
            self.slot_times.pop(marg_slot, None)
            self.db.cleanup_older_than(marg_t + 1e-9)

        # trim consumed imu (keep a tail for interpolation)
        while len(self._imu_t) > 2 and self._imu_t[1] < t - 0.2:
            self._imu_t.pop(0)
            self._imu_w.pop(0)
            self._imu_a.pop(0)

        t3h = _time.perf_counter()
        self._record_fused_timing(t, t1h - t0h, t2h - t1h, t3h - t2h)
        self._last_frame_t = t
        self._time_host = float(t)
        self._track_distance()

    def _record_fused_timing(self, t, build_s, device_s, post_s):
        """Fused-mode per-frame timing. The staged CSV columns map to:
        uwb <- host tensor build, propagation <- device step,
        msckf/slam <- 0 (fused into device), marginalization <- host
        bookkeeping."""
        self.last_timing = {
            "timestamp": t,
            "uwb": build_s,
            "propagation": device_s,
            "msckf": 0.0,
            "slam": 0.0,
            "marginalization": post_s,
            "total": build_s + device_s + post_s,
        }
        if self._timing_file is not None:
            row = self.last_timing
            self._timing_file.write(
                f"{row['timestamp']:.9f},{row['uwb']:.6f},{row['propagation']:.6f},"
                f"{row['msckf']:.6f},{row['slam']:.6f},{row['marginalization']:.6f},"
                f"{row['total']:.6f}\n"
            )

    # ------------------------------------------------------------------
    def _pre_visual_update(self, t: float):
        """Hook for subclasses (UVIO drains buffered UWB ranges here)."""

    # ------------------------------------------------------------------
    def _select_imu_window(self, t1_cam: float):
        """IMU slice for propagating the state (camera clock) to
        `t1_cam`: endpoints shifted into the IMU clock by the estimated
        camera-IMU offset, `time0 = t_state + dt_last`,
        `time1 = t_meas + dt_now` (`Propagator.cpp:54-64`). Returns
        (tt, ww, aa, dt_now); callers commit `self._last_prop_dt =
        dt_now` once the state time actually advances."""
        t0 = float(self.state.time)
        dt_now = self._dt_host
        if self._last_prop_dt is None:
            self._last_prop_dt = dt_now
        time0 = t0 + self._last_prop_dt
        # a dt estimate update can only shrink the window by ~ms; keep
        # it strictly positive for the slicer
        time1 = max(t1_cam + dt_now, time0 + 1e-9)
        tt, ww, aa = select_imu_readings_np(
            np.asarray(self._imu_t), np.stack(self._imu_w), np.stack(self._imu_a),
            time0, time1, self.layout.max_imu_batch,
        )
        return tt, ww, aa, dt_now

    def _propagate_clone(self, t: float):
        tt, ww, aa, dt_now = self._select_imu_window(t)
        self.state = self._jit_prop(
            self.state, imu_t=jnp.asarray(tt), imu_w=jnp.asarray(ww),
            imu_a=jnp.asarray(aa), stamp_time=jnp.asarray(t, jnp.float64),
        )
        self._time_host = float(t)
        self._last_prop_dt = dt_now
        # mirror ring arithmetic
        K = self.layout.max_clones
        self._head = 0 if self._head < 0 else (self._head + 1) % K
        self.slot_times[self._head] = t
        # trim consumed imu (keep a tail for interpolation)
        while len(self._imu_t) > 2 and self._imu_t[1] < t - 0.2:
            self._imu_t.pop(0)
            self._imu_w.pop(0)
            self._imu_a.pop(0)

    # ------------------------------------------------------------------
    def _select_msckf_feats(self, t: float):
        """Triage (`VioManager.cpp:366-500`, SLAM promotion in round 2):
        lost features + features observed at the to-be-marginalized
        clone time, longest tracks first, capped."""
        lost = [f for f in self.db.features_not_seen_at(t) if f.num_obs() >= 2]
        marg = []
        if len(self.slot_times) > self.cfg.max_clones:
            marg_t = min(self.slot_times.values())
            marg = [f for f in self.db.features_seen_at(marg_t) if f.newest_time() >= t]
        feats = {f.feat_id: f for f in lost + marg}
        # SLAM-tracked features never go through the MSCKF path
        for fid in self.slam_slot_by_fid:
            feats.pop(fid, None)
        # max-track candidates are promoted to SLAM instead (when slots free)
        for f in self._slam_candidates(t):
            feats.pop(f.feat_id, None)
        out = sorted(feats.values(), key=lambda f: -f.num_obs())
        return out[: self.cfg.max_msckf_in_update]

    def _slam_candidates(self, t: float):
        """Max-track features eligible for SLAM promotion: observed at the
        to-be-marginalized clone, still tracked, spanning the window."""
        if self.cfg.max_slam == 0 or len(self.slot_times) <= self.cfg.max_clones:
            return []
        # wait dt_slam_delay after startup before the first delayed init
        # (VioManager.cpp:443-444 "prevents bad first set of slam points")
        if t - getattr(self, "_startup_time", -np.inf) < self.cfg.dt_slam_delay:
            return []
        free = self.cfg.max_slam - len(self.slam_slot_by_fid)
        if free <= 0:
            return []
        marg_t = min(self.slot_times.values())
        out = []
        for f in self.db.features_seen_at(marg_t):
            if f.feat_id in self.slam_slot_by_fid:
                continue
            if f.newest_time() < t:
                continue
            times = {tt for tt in f.times() if tt in {v for v in self.slot_times.values()}}
            if len(times) >= self.cfg.max_clones:
                out.append(f)
        # Deliberate deviation: among tied full-window tracks, promote
        # the OLDEST (stable sort over insertion order). The reference
        # takes the NEWEST instead (`VioManager.cpp:446-451` slices the
        # END of the insertion-ordered maxtracks vector); A/B over
        # 5-seed Monte-Carlos: oldest-first wins the corridor scenarios
        # (mono_slam 0.0111 vs 0.0134 m, stereo_slam 0.0073 vs 0.0082)
        # and only concedes ~6% on the sustained-rotation circle
        # diagnostic (0.0096 vs 0.0090) — older tracks have survived
        # longer and carry more verified geometry.
        out = sorted(out, key=lambda f: -f.num_obs())
        return out[: min(free, self.cfg.max_slam_init_per_frame)]

    def _build_obs(self, feats):
        """Pad tracks into (F,K,C,2)+(F,K,C) aligned to clone slots."""
        L = self.layout
        F = self.cfg.max_msckf_in_update
        K, C = L.max_clones, L.num_cams
        uv = np.zeros((F, K, C, 2))
        mask = np.zeros((F, K, C), bool)
        time_to_slot = {tt: s for s, tt in self.slot_times.items()}
        for i, f in enumerate(feats):
            for cam, lst in f.obs.items():
                for (tt, u, v) in lst:
                    s = time_to_slot.get(tt)
                    if s is not None:
                        uv[i, s, cam] = (u, v)
                        mask[i, s, cam] = True
        return uv, mask

    def _msckf_step(self, t: float):
        feats = self._select_msckf_feats(t)
        if not feats:
            return
        uv, mask = self._build_obs(feats)
        self.state, info = self._jit_msckf(self.state, obs_uv=uv, obs_mask=mask)
        self._check_cov_ok(bool(info["cov_ok"]), "msckf update")
        self.last_msckf_info = info
        # consume used features (reference sets to_delete on MSCKF feats)
        for f in feats:
            f.to_delete = True
        self.db.cleanup()

    # ------------------------------------------------------------------
    def _free_landmark(self, fid: int):
        slot = self.slam_slot_by_fid.pop(fid)
        self.slam_fail.pop(fid, None)
        self.slam_consumed_t.pop(fid, None)
        self.state = self._jit_marg_slam(self.state, slot=jnp.int32(slot))

    def _slam_step(self, t: float):
        """SLAM landmark maintenance: re-observation update, failure
        accounting, and delayed init of promoted max-track features."""
        L = self.layout
        S, K, C = self.cfg.max_slam, L.max_clones, L.num_cams
        time_to_slot = {tt: s for s, tt in self.slot_times.items()}

        # 1) drop landmarks whose track died (reference marks should_marg)
        for fid in list(self.slam_slot_by_fid):
            f = self.db.features.get(fid)
            if f is None or f.newest_time() < t:
                self._free_landmark(fid)
                if f is not None:
                    f.to_delete = True
        self.db.cleanup()

        # 2) re-observation update with not-yet-consumed measurements
        uv = np.zeros((S, K, C, 2))
        mask = np.zeros((S, K, C), bool)
        any_obs = False
        for fid, slot in self.slam_slot_by_fid.items():
            f = self.db.features.get(fid)
            cons = self.slam_consumed_t.get(fid, -np.inf)
            for cam, lst in f.obs.items():
                for (tt, u, v) in lst:
                    s = time_to_slot.get(tt)
                    if s is not None and tt > cons:
                        uv[slot, s, cam] = (u, v)
                        mask[slot, s, cam] = True
                        any_obs = True
        if any_obs:
            self.state, info = self._jit_slam_up(
                self.state, obs_uv=jnp.asarray(uv), obs_mask=jnp.asarray(mask)
            )
            self._check_cov_ok(bool(info["cov_ok"]), "slam update")
            failed = np.asarray(info["failed"])
            for fid in list(self.slam_slot_by_fid):
                slot = self.slam_slot_by_fid[fid]
                self.slam_consumed_t[fid] = t
                if failed[slot]:
                    self.slam_fail[fid] = self.slam_fail.get(fid, 0) + 1
                    if self.slam_fail[fid] >= self.cfg.slam_fail_marg:
                        f = self.db.features.get(fid)
                        if f is not None:
                            f.to_delete = True
                        self._free_landmark(fid)
            self.db.cleanup()

        # 3) delayed init of promoted candidates
        cands = self._slam_candidates(t)
        if cands:
            used = set(self.slam_slot_by_fid.values())
            free_slots = [s for s in range(S) if s not in used]
            Fc = self.cfg.max_slam_init_per_frame
            uv = np.zeros((Fc, K, C, 2))
            mask = np.zeros((Fc, K, C), bool)
            slots = np.zeros(Fc, np.int32)
            fids = np.full(Fc, -1, np.int32)
            for i, f in enumerate(cands[: min(len(free_slots), Fc)]):
                slots[i] = free_slots[i]
                fids[i] = f.feat_id
                for cam, lst in f.obs.items():
                    for (tt, u, v) in lst:
                        s = time_to_slot.get(tt)
                        if s is not None:
                            uv[i, s, cam] = (u, v)
                            mask[i, s, cam] = True
            self.state, info = self._jit_slam_init(
                self.state,
                obs_uv=jnp.asarray(uv),
                obs_mask=jnp.asarray(mask),
                target_slots=jnp.asarray(slots),
                cand_ids=jnp.asarray(fids),
            )
            inited = np.asarray(info["inited"])
            for i in range(Fc):
                if fids[i] >= 0 and inited[i]:
                    self.slam_slot_by_fid[int(fids[i])] = int(slots[i])
                    self.slam_consumed_t[int(fids[i])] = t

    # ------------------------------------------------------------------
    def _marginalize(self, t: float):
        if len(self.slot_times) > self.cfg.max_clones:
            slot = min(self.slot_times, key=self.slot_times.get)
            marg_t = self.slot_times.pop(slot)
            # re-anchor landmarks whose anchor clone is about to die
            # (UpdaterSLAM::change_anchors)
            if self.cfg.max_slam > 0 and self.cfg.feat_rep_slam != 0:
                if not hasattr(self, "_jit_anchor_change"):
                    from .update.representations import anchor_change

                    self._jit_anchor_change = jax.jit(
                        partial(anchor_change, layout=self.layout)
                    )
                self.state = self._jit_anchor_change(
                    self.state, marg_slot=jnp.int32(slot), new_slot=self.state.clone_head
                )
            self.state = self._jit_marg(self.state, slot=jnp.int32(slot))
            # drop observations at (and before) the marginalized time —
            # their clone no longer exists
            self.db.cleanup_older_than(marg_t + 1e-9)

    # ------------------------------------------------------------------
    def get_propagated_pose(self, t: float):
        """IMU-rate pose output: mean-only propagation of the current
        state to time t (`fast_state_propagate` /
        `visualize_odometry` equivalent). Returns (q_GtoI, p, v)."""
        t0 = self._time_host if self._time_host is not None else -np.inf
        if not self.is_initialized or t <= t0 or not self._imu_t:
            return (np.asarray(self.state.q), np.asarray(self.state.p),
                    np.asarray(self.state.v))
        from .filter.propagator import propagate_mean_only

        if not hasattr(self, "_jit_fast_prop"):
            self._jit_fast_prop = jax.jit(
                partial(
                    propagate_mean_only,
                    gravity_mag=self.cfg.gravity_mag,
                    imu_model=self.cfg.imu_model,
                )
            )
        # same offset-shifted window as the filter (`fast_state_propagate`
        # uses time0/time1 with t_off too, Propagator.cpp:148-154); the
        # transient prediction does not commit _last_prop_dt
        tt, ww, aa, _ = self._select_imu_window(t)
        q, p, v = self._jit_fast_prop(
            self.state, imu_t=jnp.asarray(tt), imu_w=jnp.asarray(ww), imu_a=jnp.asarray(aa)
        )
        return np.asarray(q), np.asarray(p), np.asarray(v)

    # ------------------------------------------------------------------
    def record_timing(self, path: str):
        """Start recording per-stage timing rows to a CSV
        (record_timing_information / record_timing_filepath)."""
        self._timing_file = open(path, "w")
        self._timing_file.write(
            "# timestamp,uwb,propagation,msckf,slam,marginalization,total\n"
        )

    # ------------------------------------------------------------------
    def get_pose(self):
        """Current (q_GtoI, p_IinG) estimate as numpy."""
        return np.asarray(self.state.q), np.asarray(self.state.p)

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str):
        """Snapshot the full estimator (device pytree + host mirror) to
        one .npz. The reference cannot do this (SURVEY.md §5:
        checkpoint/resume "None"); here the estimator is a pytree, so a
        restart resumes exactly where it left off."""
        from .utils.checkpoint import save_state

        meta = {
            "is_initialized": bool(self.is_initialized),
            "head": int(self._head),
            "slot_times": {str(k): float(v) for k, v in self.slot_times.items()},
            "last_frame_t": float(getattr(self, "_last_frame_t", 0.0)),
            "last_prop_dt": (
                float(self._last_prop_dt) if self._last_prop_dt is not None else None
            ),
            # keep at least one full propagation window of IMU history so
            # the first post-restore propagation sees every reading it needs
            "imu_t": [float(t) for t in self._imu_t[-self.cfg.max_imu_batch:]],
            "imu_w": [list(map(float, w)) for w in self._imu_w[-self.cfg.max_imu_batch:]],
            "imu_a": [list(map(float, a)) for a in self._imu_a[-self.cfg.max_imu_batch:]],
            "db": self.db.to_dict(),
            "slam_slot_by_fid": {str(k): v for k, v in self.slam_slot_by_fid.items()},
            "slam_fail": {str(k): v for k, v in self.slam_fail.items()},
            "slam_consumed_t": {str(k): v for k, v in self.slam_consumed_t.items()},
        }
        save_state(path, self.state, meta)

    def load_checkpoint(self, path: str):
        """Restore a `save_checkpoint` snapshot into this manager (must
        be constructed with the same config/layout)."""
        from .utils.checkpoint import load_state

        state, meta = load_state(path, self.state)
        self.state = state
        # host mirrors rebuilt from the restored device state (one-time
        # fetch; see _time_host/_dt_host in __init__)
        self._time_host = float(state.time)
        self._dt_host = float(state.calib_dt)
        self.is_initialized = meta["is_initialized"]
        self._head = meta["head"]
        self.slot_times = {int(k): v for k, v in meta["slot_times"].items()}
        self._last_frame_t = meta["last_frame_t"]
        self._last_prop_dt = meta.get("last_prop_dt")
        self._imu_t = list(meta["imu_t"])
        self._imu_w = [np.asarray(w) for w in meta["imu_w"]]
        self._imu_a = [np.asarray(a) for a in meta["imu_a"]]
        self.db = FeatureDatabase.from_dict(meta.get("db", {}))
        self.slam_slot_by_fid = {int(k): int(v) for k, v in meta.get("slam_slot_by_fid", {}).items()}
        self.slam_fail = {int(k): int(v) for k, v in meta.get("slam_fail", {}).items()}
        self.slam_consumed_t = {int(k): float(v) for k, v in meta.get("slam_consumed_t", {}).items()}

    # ------------------------------------------------------------------
    def get_active_tracks(self, t: Optional[float] = None):
        """3D positions of features tracked into the newest frame —
        the reference's `retriangulate_active_tracks`
        (`VioManagerHelper.cpp:190-387`), which feeds visualization and
        loop-closure consumers (`publish_loopclosure_information`).

        Returns (ids (N,), p_FinG (N,3)) of successfully triangulated
        active MSCKF tracks, plus all valid SLAM landmarks (their slot
        ids are the feature ids they were promoted from).
        """
        from .cam import models as cam_models
        from .update.msckf import clone_camera_poses
        from .update.representations import landmark_global
        from .update.triangulation import triangulate_batch

        t = self._last_frame_t if t is None else t
        feats = [
            f for f in self.db.features_seen_at(t)
            if f.feat_id not in self.slam_slot_by_fid
        ]
        ids_out, pts_out = [], []
        if feats:
            L = self.layout
            K, C = L.max_clones, L.num_cams
            uv = np.zeros((len(feats), K, C, 2))
            mask = np.zeros((len(feats), K, C), bool)
            time_to_slot = {tt: s for s, tt in self.slot_times.items()}
            for i, f in enumerate(feats):
                for cam, lst in f.obs.items():
                    for (tt, u, v) in lst:
                        s = time_to_slot.get(tt)
                        if s is not None:
                            uv[i, s, cam] = (u, v)
                            mask[i, s, cam] = True
            st = self.state
            uvn = np.stack(
                [
                    np.asarray(
                        cam_models.undistort(
                            st.calib_cam_intr[c],
                            self.cfg.cameras[c].model,
                            jnp.asarray(uv[:, :, c, :]),
                        )
                    )
                    for c in range(C)
                ],
                axis=2,
            )
            (R_val, p_val), _ = clone_camera_poses(st, L)
            p_f, ok = triangulate_batch(
                jnp.asarray(uvn.reshape(len(feats), K * C, 2)),
                jnp.asarray(mask.reshape(len(feats), K * C)),
                jnp.asarray(R_val.reshape(K * C, 3, 3)),
                jnp.asarray(p_val.reshape(K * C, 3)),
            )
            ok = np.asarray(ok)
            p_f = np.asarray(p_f)
            for i, f in enumerate(feats):
                if ok[i]:
                    ids_out.append(f.feat_id)
                    pts_out.append(p_f[i])
        # SLAM landmarks: exact representation-chained global positions
        if self.cfg.max_slam > 0:
            p_glob, _ = landmark_global(self.state, self.layout)
            p_glob = np.asarray(p_glob)
            valid = np.asarray(self.state.slam_valid)
            sid = np.asarray(self.state.slam_id)
            for s in range(self.cfg.max_slam):
                if valid[s]:
                    ids_out.append(int(sid[s]))
                    pts_out.append(p_glob[s])
        if not ids_out:
            return np.zeros(0, np.int64), np.zeros((0, 3))
        return np.asarray(ids_out), np.stack(pts_out)
