"""Filter state pytree: fixed-shape mean blocks + dense covariance.

Array replacement for the reference's pointer-graph state
(`ov_msckf/src/state/State.h`, `uvio/src/state/UVioState.h`): every
block is a fixed-size array with a validity mask; the covariance is one
dense (dim, dim) matrix laid out by `StateLayout`.

First-estimate-Jacobian (FEJ) support: `*_fej` arrays hold the
linearization points. They are written by propagation/cloning/landmark
init and deliberately NOT touched by EKF updates (the whole point of
FEJ, cf. `ov_core/src/types/Type.h` fej storage).

Conventions: `q` is the JPL quaternion `q_GtoI` (R(q) v_G = v_I),
`p`/`v` are in global, `calib_cam_q/p` are `q_ItoC`/`p_IinC`, UWB
anchors carry `p_AinG`, const bias gamma and distance-scale bias alpha
(range model `y = (1+alpha) d + gamma + n`,
`uvio/src/utils/uvio_sensor_data.h:34-69`).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .layout import IMU_MODEL_KALIBR, StateLayout


def dm_identity(imu_model: int):
    """The 6-vector whose `Dm` triangular fill is the identity matrix
    (KALIBR lower / RPNG upper column-wise fill, `State.h:91-102`)."""
    if imu_model == IMU_MODEL_KALIBR:
        return [1.0, 0.0, 0.0, 1.0, 0.0, 1.0]
    return [1.0, 0.0, 1.0, 0.0, 0.0, 1.0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FilterState:
    # time of the current IMU state estimate (seconds, f64)
    time: jnp.ndarray

    # IMU nominal state
    q: jnp.ndarray  # (4,) q_GtoI
    p: jnp.ndarray  # (3,) p_IinG
    v: jnp.ndarray  # (3,) v_IinG
    bg: jnp.ndarray  # (3,)
    ba: jnp.ndarray  # (3,)
    # IMU first-estimate (linearization point)
    q_fej: jnp.ndarray
    p_fej: jnp.ndarray
    v_fej: jnp.ndarray

    # clone ring buffer (stochastic clones of the IMU pose)
    clones_q: jnp.ndarray  # (K,4)
    clones_p: jnp.ndarray  # (K,3)
    clones_q_fej: jnp.ndarray  # (K,4)
    clones_p_fej: jnp.ndarray  # (K,3)
    clones_t: jnp.ndarray  # (K,)
    clones_valid: jnp.ndarray  # (K,) bool
    clone_head: jnp.ndarray  # () int32, slot of newest clone (-1 if none)

    # SLAM landmark pool. slam_p holds the representation value:
    # p_FinG for GLOBAL_3D, (alpha, beta, rho) for anchored inverse depth
    slam_p: jnp.ndarray  # (S,3)
    slam_p_fej: jnp.ndarray  # (S,3)
    slam_valid: jnp.ndarray  # (S,) bool
    slam_id: jnp.ndarray  # (S,) int32 feature id (-1 = free)
    slam_anchor_slot: jnp.ndarray  # (S,) int32 anchor clone slot
    slam_anchor_cam: jnp.ndarray  # (S,) int32 anchor camera

    # IMU intrinsics: Dw/Da 6-vectors (State::Dm triangular fill),
    # Tg 9-vector (column-wise), and the gyro/acc frame rotations
    # q_GYROtoIMU / q_ACCtoIMU (only the model-appropriate one carries
    # error-state dofs; both may be seeded from config)
    calib_imu_dw: jnp.ndarray  # (6,)
    calib_imu_da: jnp.ndarray  # (6,)
    calib_imu_tg: jnp.ndarray  # (9,)
    calib_imu_gq: jnp.ndarray  # (4,) q_GYROtoIMU
    calib_imu_aq: jnp.ndarray  # (4,) q_ACCtoIMU

    # calibration states
    calib_dt: jnp.ndarray  # () camera-IMU time offset
    calib_cam_q: jnp.ndarray  # (C,4) q_ItoC
    calib_cam_p: jnp.ndarray  # (C,3) p_IinC
    calib_cam_intr: jnp.ndarray  # (C,8)

    # UWB states
    uwb_p_IinU: jnp.ndarray  # (3,) lever arm
    anchors_p: jnp.ndarray  # (A,3) p_AinG
    anchors_gamma: jnp.ndarray  # (A,) const bias
    anchors_alpha: jnp.ndarray  # (A,) distance bias
    anchors_valid: jnp.ndarray  # (A,) bool

    # dense covariance over the full error state
    cov: jnp.ndarray  # (D,D)

    def replace(self, **updates) -> "FilterState":
        """Copy with the named fields replaced (the state is immutable)."""
        return dataclasses.replace(self, **updates)


def init_state(layout: StateLayout, dtype=jnp.float64) -> FilterState:
    """Identity-orientation zero state with zero covariance.

    `dtype` sets the compute precision of every block EXCEPT the time
    axis (`time`, `clones_t`), which is always f64: epoch-second
    timestamps (EuRoC ~1.4e9) have only ~128 s resolution in f32.
    """
    K, S, A, C = layout.max_clones, layout.max_slam, layout.max_anchors, layout.num_cams
    q0 = jnp.array([0.0, 0.0, 0.0, 1.0], dtype=dtype)
    z3 = jnp.zeros(3, dtype=dtype)
    return FilterState(
        time=jnp.array(-1.0, dtype=jnp.float64),
        q=q0,
        p=z3,
        v=z3,
        bg=z3,
        ba=z3,
        q_fej=q0,
        p_fej=z3,
        v_fej=z3,
        clones_q=jnp.tile(q0, (K, 1)),
        clones_p=jnp.zeros((K, 3), dtype=dtype),
        clones_q_fej=jnp.tile(q0, (K, 1)),
        clones_p_fej=jnp.zeros((K, 3), dtype=dtype),
        clones_t=jnp.full((K,), -1.0, dtype=jnp.float64),
        clones_valid=jnp.zeros((K,), dtype=bool),
        clone_head=jnp.array(-1, dtype=jnp.int32),
        slam_p=jnp.zeros((S, 3), dtype=dtype),
        slam_p_fej=jnp.zeros((S, 3), dtype=dtype),
        slam_valid=jnp.zeros((S,), dtype=bool),
        slam_id=jnp.full((S,), -1, dtype=jnp.int32),
        slam_anchor_slot=jnp.zeros((S,), dtype=jnp.int32),
        slam_anchor_cam=jnp.zeros((S,), dtype=jnp.int32),
        calib_imu_dw=jnp.asarray(dm_identity(layout.imu_model), dtype=dtype),
        calib_imu_da=jnp.asarray(dm_identity(layout.imu_model), dtype=dtype),
        calib_imu_tg=jnp.zeros(9, dtype=dtype),
        calib_imu_gq=q0,
        calib_imu_aq=q0,
        calib_dt=jnp.array(0.0, dtype=dtype),
        calib_cam_q=jnp.tile(q0, (C, 1)),
        calib_cam_p=jnp.zeros((C, 3), dtype=dtype),
        calib_cam_intr=jnp.concatenate(
            [
                jnp.ones((C, 2), dtype=dtype),
                jnp.zeros((C, 6), dtype=dtype),
            ],
            axis=1,
        ),
        uwb_p_IinU=z3,
        anchors_p=jnp.zeros((A, 3), dtype=dtype),
        anchors_gamma=jnp.zeros((A,), dtype=dtype),
        anchors_alpha=jnp.zeros((A,), dtype=dtype),
        anchors_valid=jnp.zeros((A,), bool),
        cov=jnp.zeros((layout.dim, layout.dim), dtype=dtype),
    )


def num_clones(state: FilterState) -> jnp.ndarray:
    return jnp.sum(state.clones_valid.astype(jnp.int32))


def oldest_clone_slot(state: FilterState, layout: StateLayout) -> jnp.ndarray:
    """Slot index of the oldest valid clone (ring order: head+1 when full)."""
    t = jnp.where(state.clones_valid, state.clones_t, jnp.inf)
    return jnp.argmin(t).astype(jnp.int32)
