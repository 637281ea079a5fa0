"""Fixed-shape filter state (the fixed-shape ``StateServer``).

Replaces the reference's pointer-rich dynamic state (``StateServer`` with a
``std::map`` of camera states and a ``MapServer`` of features,
msckf_vio.h:91-99, feature.hpp:166-168) with preallocated, masked arrays so
the whole filter is one jit-compiled program:

* camera states live in a *compaction queue* of ``M = max_cam_state_size``
  slots ordered oldest -> newest (slot index == position in the covariance);
* the error covariance is a constant ``(21+6M, 21+6M)`` matrix whose rows
  and columns beyond the active count are zero (replaces
  ``conservative_resize``, msckf_vio.cpp:567,1174);
* feature tracks live in a pool of ``K = max_tracks`` slots, each with an
  ``(M, 4)`` observation array aligned to the camera slots.

Error-state layout (identical to the reference, msckf_vio.cpp:417-429):
``[0:3 dtheta, 3:6 d_bg, 6:9 dv, 9:12 d_ba, 12:15 dp, 15:18 dtheta_extr,
18:21 dt_extr]`` then 6 dof per camera slot ``[dtheta_c, dp_c]``.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..config import FilterConfig, StereoCalib
from ..utils.quaternion import quat_identity


class ImuState(NamedTuple):
    """IMU state + online-estimated IMU<->cam0 extrinsics + FEJ shadows
    (reference imu_state.h:28-88)."""

    q: jnp.ndarray  # (4,) JPL world->IMU
    bg: jnp.ndarray  # (3,)
    v: jnp.ndarray  # (3,)
    ba: jnp.ndarray  # (3,)
    p: jnp.ndarray  # (3,)
    R_imu_cam0: jnp.ndarray  # (3,3) rotates IMU-frame vectors to cam0 frame
    t_cam0_imu: jnp.ndarray  # (3,) cam0 position in IMU frame
    q_null: jnp.ndarray  # (4,) observability-constrained shadow states
    v_null: jnp.ndarray  # (3,)
    p_null: jnp.ndarray  # (3,)
    time: jnp.ndarray  # () seconds


class CamStates(NamedTuple):
    """Sliding window of M camera poses, SoA layout, queue-ordered
    (reference cam_state.h:25-60; CamStateServer ordered by id)."""

    q: jnp.ndarray  # (M, 4) JPL world->cam0
    p: jnp.ndarray  # (M, 3) cam0 position in world
    q_null: jnp.ndarray  # (M, 4)
    p_null: jnp.ndarray  # (M, 3)
    sid: jnp.ndarray  # (M,) int32 state id (for debugging/association)
    time: jnp.ndarray  # (M,)


class TrackMap(NamedTuple):
    """Feature map (reference ``MapServer``): K track slots with stereo
    observations aligned to camera slots."""

    fid: jnp.ndarray  # (K,) int32 feature id; -1 = free slot
    obs: jnp.ndarray  # (K, M, 4) normalized [u0, v0, u1, v1]
    obs_valid: jnp.ndarray  # (K, M) bool
    pos: jnp.ndarray  # (K, 3) triangulated world position
    initialized: jnp.ndarray  # (K,) bool
    # Per-observation tracking-SNR proxy (frontend template min gradient
    # eigenvalue per pixel at the frame the observation was made; 0 =
    # unknown).  Feeds the SNR-adaptive observation noise
    # (FilterConfig.noise_adaptive); the reference uses a single static
    # observation_noise scalar (msckf_vio.cpp:44).
    quality: jnp.ndarray  # (K, M)


class FilterState(NamedTuple):
    imu: ImuState
    cams: CamStates
    num_cams: jnp.ndarray  # () int32 active camera slots
    P: jnp.ndarray  # (D, D) error covariance, D = 21 + 6M
    tracks: TrackMap
    gravity: jnp.ndarray  # (3,) world gravity (0, 0, -g)
    tracking_rate: jnp.ndarray  # ()
    next_sid: jnp.ndarray  # () int32 camera state id counter
    online_reset_count: jnp.ndarray  # () int32


def init_filter_state(
    cfg: FilterConfig, calib: StereoCalib, dtype=jnp.float64
) -> FilterState:
    """Build the initial state (reference loadParameters, msckf_vio.cpp:58-127)."""
    M = cfg.max_cam_state_size
    K = cfg.max_tracks
    D = cfg.state_dim

    # Extrinsics from the Kalibr camchain: T_cam0_imu = T_cam_imu^-1,
    # R_imu_cam0 = R(T_cam0_imu)^T = R(T_cam_imu), t_cam0_imu = t(T_cam0_imu).
    T_ci = calib.cam0.T_cam_imu_mat()
    R_imu_cam0 = np.asarray(T_ci[:3, :3])
    t_cam0_imu = np.asarray(-T_ci[:3, :3].T @ T_ci[:3, 3])

    imu = ImuState(
        q=quat_identity(dtype),
        bg=jnp.zeros(3, dtype),
        v=jnp.asarray(cfg.initial_velocity, dtype),
        ba=jnp.zeros(3, dtype),
        p=jnp.zeros(3, dtype),
        R_imu_cam0=jnp.asarray(R_imu_cam0, dtype),
        t_cam0_imu=jnp.asarray(t_cam0_imu, dtype),
        q_null=quat_identity(dtype),
        v_null=jnp.asarray(cfg.initial_velocity, dtype),
        p_null=jnp.zeros(3, dtype),
        time=jnp.zeros((), dtype),
    )

    cams = CamStates(
        q=jnp.tile(quat_identity(dtype), (M, 1)),
        p=jnp.zeros((M, 3), dtype),
        q_null=jnp.tile(quat_identity(dtype), (M, 1)),
        p_null=jnp.zeros((M, 3), dtype),
        sid=-jnp.ones((M,), jnp.int32),
        time=jnp.zeros((M,), dtype),
    )

    P = jnp.diag(jnp.asarray(initial_cov_diag(cfg, D), dtype))

    tracks = TrackMap(
        fid=-jnp.ones((K,), jnp.int32),
        obs=jnp.zeros((K, M, 4), dtype),
        obs_valid=jnp.zeros((K, M), bool),
        pos=jnp.zeros((K, 3), dtype),
        initialized=jnp.zeros((K,), bool),
        quality=jnp.zeros((K, M), dtype),
    )

    return FilterState(
        imu=imu,
        cams=cams,
        num_cams=jnp.zeros((), jnp.int32),
        P=P,
        tracks=tracks,
        gravity=jnp.asarray([0.0, 0.0, -9.81], dtype),
        tracking_rate=jnp.zeros((), dtype),
        next_sid=jnp.zeros((), jnp.int32),
        online_reset_count=jnp.zeros((), jnp.int32),
    )


def initial_cov_diag(cfg: FilterConfig, D: int) -> np.ndarray:
    """Initial covariance diagonal (msckf_vio.cpp:102-112): zero orientation
    and position uncertainty; nontrivial velocity/bias/extrinsic blocks."""
    diag = np.zeros(D, dtype=np.float64)
    diag[3:6] = cfg.initial_cov_gyro_bias
    diag[6:9] = cfg.initial_cov_velocity
    diag[9:12] = cfg.initial_cov_acc_bias
    diag[15:18] = cfg.initial_cov_extrinsic_rotation
    diag[18:21] = cfg.initial_cov_extrinsic_translation
    return diag


def continuous_noise_cov(cfg: FilterConfig, dtype=jnp.float64) -> jnp.ndarray:
    """12x12 continuous-time process noise (msckf_vio.cpp:174-179)."""
    diag = np.concatenate(
        [
            np.full(3, cfg.gyro_noise_var),
            np.full(3, cfg.gyro_bias_noise_var),
            np.full(3, cfg.acc_noise_var),
            np.full(3, cfg.acc_bias_noise_var),
        ]
    )
    return jnp.diag(jnp.asarray(diag, dtype))


def active_cam_mask(num_cams: jnp.ndarray, M: int) -> jnp.ndarray:
    """(M,) bool mask of active camera slots."""
    return jnp.arange(M) < num_cams


def active_state_mask(num_cams: jnp.ndarray, D: int) -> jnp.ndarray:
    """(D,) bool mask of active error-state entries."""
    return jnp.arange(D) < 21 + 6 * num_cams
