"""The stereo MSCKF filter: one jit-compiled step per stereo frame.

Re-design of the reference's ``MsckfVio::featureCallback``
pipeline (msckf_vio.cpp:306-375): batchImuProcessing -> stateAugmentation ->
addFeatureObservations -> removeLostFeatures -> pruneCamStateBuffer ->
publish -> onlineReset, with every phase operating on fixed-shape masked
arrays so the entire step is a single XLA program (scannable over a whole
sequence).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FilterConfig, StereoCalib, matmul_precision_scope
from ..utils.chi2 import chi2_p95_table
from ..utils.quaternion import jpl_to_rot, rot_to_jpl
from .augmentation import add_feature_observations, augment_state
from .propagation import ImuBatch, propagate
from .pruning import compact_after_removal, find_redundant_cam_slots
from .state import FilterState, continuous_noise_cov, init_filter_state, initial_cov_diag
from .triangulation import check_motion_tracks, triangulate_tracks
from .update import (
    cam_cov_blocks,
    gating_scores,
    measurement_update,
    measurement_update_schur,
    measurement_update_schur_compact,
    schur_gating,
    schur_gating_compact,
    track_blocks,
    track_jacobians,
)


class FrameFeatures(NamedTuple):
    """Per-frame output of the frontend (CameraMeasurement, data_msg.h:38-46)."""

    time: jnp.ndarray  # ()
    fid: jnp.ndarray  # (F,) int32
    uv: jnp.ndarray  # (F, 4) normalized [u0, v0, u1, v1]
    valid: jnp.ndarray  # (F,) bool
    # (F,) per-track tracking-SNR proxy (template min-eig; 0 = unknown) for
    # the SNR-adaptive observation noise.  None = all-unknown (kept optional
    # so synthetic-track tests and external feeders need no change).
    quality: jnp.ndarray | None = None


class MsckfParams(NamedTuple):
    """Device-resident calibration + tables (static per run)."""

    R_c0_c1: jnp.ndarray  # (3,3): p_c1 = R p_c0 + t
    t_c0_c1: jnp.ndarray  # (3,)
    Q_imu: jnp.ndarray  # (12,12) continuous-time process noise
    chi2_table: jnp.ndarray  # (100,) gating thresholds by dof
    sigma2: jnp.ndarray  # () observation noise variance
    init_cov_diag: jnp.ndarray  # (D,) for online reset
    T_body_imu_R: jnp.ndarray  # (3,3) R(T_imu_body) for publish
    rotation_threshold: jnp.ndarray
    translation_threshold: jnp.ndarray
    tracking_rate_threshold: jnp.ndarray
    feature_translation_threshold: jnp.ndarray
    position_std_threshold: jnp.ndarray


class PoseOutput(NamedTuple):
    """Per-frame published pose (TUM tuple) + diagnostics."""

    time: jnp.ndarray
    p: jnp.ndarray  # (3,) body position in world
    q_xyzw: jnp.ndarray  # (4,) Hamilton body->world quaternion
    p_cov: jnp.ndarray  # (3,3) body-frame position covariance
    num_cams: jnp.ndarray
    num_tracks: jnp.ndarray
    tracking_rate: jnp.ndarray


def make_params(cfg: FilterConfig, calib: StereoCalib, dtype=jnp.float64) -> MsckfParams:
    T01 = calib.T_cam0_cam1_mat()
    Tib = np.asarray(calib.T_imu_body, dtype=np.float64).reshape(4, 4)
    # Reference stores T_imu_body^-1's rotation for publish (msckf_vio.cpp:128).
    R_bi = Tib[:3, :3].T
    return MsckfParams(
        R_c0_c1=jnp.asarray(T01[:3, :3], dtype),
        t_c0_c1=jnp.asarray(T01[:3, 3], dtype),
        Q_imu=continuous_noise_cov(cfg, dtype),
        chi2_table=jnp.asarray(chi2_p95_table(99), dtype),
        sigma2=jnp.asarray(cfg.observation_noise_var, dtype),
        init_cov_diag=jnp.asarray(initial_cov_diag(cfg, cfg.state_dim), dtype),
        T_body_imu_R=jnp.asarray(R_bi, dtype),
        rotation_threshold=jnp.asarray(cfg.rotation_threshold, dtype),
        translation_threshold=jnp.asarray(cfg.translation_threshold, dtype),
        tracking_rate_threshold=jnp.asarray(cfg.tracking_rate_threshold, dtype),
        feature_translation_threshold=jnp.asarray(cfg.feature_translation_threshold, dtype),
        position_std_threshold=jnp.asarray(cfg.position_std_threshold, dtype),
    )


def _snr_weights(quality: jnp.ndarray, obs_mask: jnp.ndarray, cfg: FilterConfig):
    """Per-track EKF weight w = sigma2_base / sigma2_track for the
    SNR-adaptive observation noise (FilterConfig.noise_adaptive).

    ``quality``: (Kc, Ms) per-observation template min-eig (0 = unknown);
    ``obs_mask``: which observations belong to the track.  The track's noise
    variance inflates by clip(ref / mean_quality, 1, cap); unknown-quality
    tracks keep the base noise.  Returns (Kc,) weights in (0, 1]."""
    q = jnp.where(obs_mask & (quality > 0), quality, 0.0)
    cnt = jnp.sum(q > 0, axis=1)
    qmean = jnp.sum(q, axis=1) / jnp.maximum(cnt, 1).astype(q.dtype)
    infl = jnp.where(
        qmean > 0,
        jnp.clip(
            cfg.noise_snr_ref / jnp.maximum(qmean, 1e-12),
            1.0,
            cfg.noise_inflation_cap,
        ),
        1.0,
    )
    return 1.0 / infl


def _gate_and_update(
    state: FilterState,
    params: MsckfParams,
    method: str,
    pos,
    obs,
    obs_mask,
    use,
    dof,
    max_update: int = 0,
    cam_idx=None,
    ns_iters: int = 0,
    w=None,
) -> FilterState:
    """Chi-square gate + compressed EKF update over the selected tracks.

    method='qr'/'cholesky': explicit nullspace projection (complete QR) then
    dense compression (reference-faithful, used on CPU/f64).
    method='schur': feature-marginalized information accumulation — no QR
    anywhere; the batched-matmul fast path (see update.py).

    ``max_update > 0`` compacts the candidate set to that many slots before
    any Jacobian work (only ~10-20 tracks finish per frame; computing
    gating Cholesky lanes for the whole pool is wasted work).  Overflow
    candidates are dropped from the update only — their map entries are
    handled by the caller exactly as if gated out.  The hot callers compact
    *before* triangulation via ``_compact_candidates`` and pass
    ``max_update=0`` here.

    ``cam_idx`` (schur only): (Mc,) camera slots when every used
    observation lives in those slots (the 2-slot prune update).  The whole
    gate+update then runs camera-compacted — (4Mc, 4Mc) gating systems and
    a rank-6Mc EKF update — exactly equivalent to the full-width path.

    ``w`` (optional, (K,)): per-track noise weights from ``_snr_weights``.
    Scaling the track's Jacobian blocks and residuals by sqrt(w) makes the
    base-sigma2 formulas below EXACTLY the per-track-noise gating/update
    (w * (H P H^T) + s2 I = w * (H P H^T + (s2/w) I), and the nullspace
    basis / information accumulation are scale-covariant)."""
    if max_update and max_update < use.shape[0]:
        order = jnp.argsort(~use)  # stable: selected tracks first
        idx = order[:max_update]
        pos = pos[idx]
        obs = obs[idx]
        obs_mask = obs_mask[idx]
        use = use[idx]
        dof = dof[idx]
        if w is not None:
            w = w[idx]

    if method == "schur":
        cams = state.cams
        if cam_idx is not None:
            cams = cams._replace(
                q=cams.q[cam_idx], p=cams.p[cam_idx],
                q_null=cams.q_null[cam_idx], p_null=cams.p_null[cam_idx],
            )
        blocks = track_blocks(
            pos, obs, obs_mask, cams, state.gravity,
            params.R_c0_c1, params.t_c0_c1,
        )
        if w is not None:
            sw = jnp.sqrt(w).astype(blocks.H_x.dtype)
            blocks = blocks._replace(
                H_x=blocks.H_x * sw[:, None, None, None],
                H_f=blocks.H_f * sw[:, None, None, None],
                r=blocks.r * sw[:, None, None],
            )
        if cam_idx is not None:
            Pc = cam_cov_blocks(state.P, cam_idx)
            gamma = schur_gating_compact(blocks, Pc, params.sigma2, ns_iters)
            use = use & (gamma < params.chi2_table[dof])
            return measurement_update_schur_compact(
                state, blocks, use, params.sigma2, cam_idx, ns_iters
            )
        gamma = schur_gating(blocks, state.P, params.sigma2, ns_iters)
        use = use & (gamma < params.chi2_table[dof])
        return measurement_update_schur(state, blocks, use, params.sigma2, ns_iters)

    jacs = track_jacobians(
        pos, obs, obs_mask, state.cams, state.gravity,
        params.R_c0_c1, params.t_c0_c1,
    )
    if w is not None:
        sw = jnp.sqrt(w).astype(jacs.H_o.dtype)
        jacs = jacs._replace(
            H_o=jacs.H_o * sw[:, None, None], r_o=jacs.r_o * sw[:, None]
        )
    gamma = gating_scores(jacs, state.P, params.sigma2)
    use = use & (gamma < params.chi2_table[dof])
    return measurement_update(state, jacs, use, params.sigma2, method=method)


def _compact_candidates(candidates: jnp.ndarray, max_update: int):
    """Stable indices of (at most) ``max_update`` candidate tracks, selected
    candidates first.  Compacting *before* triangulation means the LM solver
    runs over 32 slots instead of the whole pool; a candidate that later
    fails triangulation wastes a slot, which only matters in the rare frame
    with more than ``max_update`` candidates (the cap itself already departs
    from the uncapped reference there)."""
    K = candidates.shape[0]
    if not max_update or max_update >= K:
        return jnp.arange(K, dtype=jnp.int32)
    return jnp.argsort(~candidates)[:max_update].astype(jnp.int32)


def _lost_candidates(state: FilterState, params: MsckfParams, max_update: int = 0):
    """Select + triangulate the tracks that lost tracking this frame (the
    shared first half of removeLostFeatures, msckf_vio.cpp:937-1002).

    Returns (idx, obs_c, obs_valid_c, use, dof, pos, drop_only, candidates):
    compacted candidate indices into the pool, their observations, the
    per-candidate participation mask after motion/triangulation checks,
    gating dof, and the world positions to linearize at."""
    tracks = state.tracks

    active = tracks.fid >= 0
    newest = state.num_cams - 1
    observed_now = tracks.obs_valid[:, jnp.maximum(newest, 0)] & (state.num_cams > 0)
    lost = active & ~observed_now
    n_obs = jnp.sum(tracks.obs_valid, axis=1)

    drop_only = lost & (n_obs < 3)
    candidates = lost & (n_obs >= 3)

    idx = _compact_candidates(candidates, max_update)
    obs_c = tracks.obs[idx]
    obs_valid_c = tracks.obs_valid[idx]
    initialized_c = tracks.initialized[idx]

    # Motion check + triangulation for not-yet-initialized candidates.
    motion_ok = check_motion_tracks(
        obs_c, obs_valid_c, state.cams.q, state.cams.p,
        params.feature_translation_threshold,
    )
    tri = triangulate_tracks(
        obs_c, obs_valid_c, state.cams.q, state.cams.p,
        params.R_c0_c1, params.t_c0_c1,
    )
    init_ok = jnp.where(initialized_c, True, motion_ok & tri.valid)
    pos = jnp.where(initialized_c[:, None], tracks.pos[idx], tri.pos_w)

    use = candidates[idx] & init_ok
    dof = jnp.clip(n_obs[idx] - 1, 1, 99)
    return idx, obs_c, obs_valid_c, use, dof, pos, drop_only, candidates


def _remove_lost_features(state: FilterState, params: MsckfParams, method: str, max_update: int = 0, ns_iters: int = 0, cfg: FilterConfig | None = None) -> FilterState:
    """Triangulate + update with tracks that lost tracking this frame
    (reference removeLostFeatures, msckf_vio.cpp:937-1024)."""
    idx, obs_c, obs_valid_c, use, dof, pos, drop_only, candidates = _lost_candidates(
        state, params, max_update
    )
    w = None
    if cfg is not None and cfg.noise_adaptive:
        w = _snr_weights(state.tracks.quality[idx], obs_valid_c, cfg)
    state = _gate_and_update(
        state, params, method, pos, obs_c,
        obs_valid_c & use[:, None], use, dof, ns_iters=ns_iters, w=w,
    )

    # All processed or too-short tracks leave the map.
    gone = drop_only | candidates
    tracks = state.tracks._replace(
        fid=jnp.where(gone, -1, state.tracks.fid),
        obs_valid=state.tracks.obs_valid & ~gone[:, None],
        initialized=jnp.where(gone, False, state.tracks.initialized),
    )
    return state._replace(tracks=tracks)


def _prune_cam_states(state: FilterState, params: MsckfParams, method: str, max_update: int = 0, ns_iters: int = 0, cfg: FilterConfig | None = None) -> FilterState:
    """Marginalize two redundant camera states
    (reference pruneCamStateBuffer, msckf_vio.cpp:1073-1184)."""
    tracks = state.tracks
    K, M = tracks.obs_valid.shape

    slot_a, slot_b = find_redundant_cam_slots(
        state, params.rotation_threshold, params.translation_threshold,
        params.tracking_rate_threshold,
    )
    involved = tracks.obs_valid[:, slot_a].astype(jnp.int32) + tracks.obs_valid[:, slot_b].astype(jnp.int32)
    involved_mask = (jnp.arange(M)[None, :] == slot_a) | (jnp.arange(M)[None, :] == slot_b)
    involved_mask = involved_mask & tracks.obs_valid

    active = tracks.fid >= 0
    update_cand = active & (involved >= 2)

    idx = _compact_candidates(update_cand, max_update)
    obs_k = tracks.obs[idx]
    obs_valid_k = tracks.obs_valid[idx]
    initialized_k = tracks.initialized[idx]
    cand_k = update_cand[idx]

    motion_ok = check_motion_tracks(
        obs_k, obs_valid_k, state.cams.q, state.cams.p,
        params.feature_translation_threshold,
    )
    tri = triangulate_tracks(
        obs_k, obs_valid_k, state.cams.q, state.cams.p,
        params.R_c0_c1, params.t_c0_c1,
    )
    init_ok = jnp.where(initialized_k, True, motion_ok & tri.valid)
    pos = jnp.where(initialized_k[:, None], tracks.pos[idx], tri.pos_w)
    newly_init = cand_k & ~initialized_k & motion_ok & tri.valid

    use = cand_k & init_ok
    dof = jnp.clip(involved[idx], 1, 99)
    involved_mask_k = involved_mask[idx]
    w = None
    if cfg is not None and cfg.noise_adaptive:
        # Weight from the observations this update consumes (the two
        # pruned slots).
        w = _snr_weights(tracks.quality[idx], involved_mask_k, cfg)
    if method == "schur":
        # Every used observation lives in the two pruned slots, so the
        # gate+update runs camera-compacted: (K, 8, 8) gating systems and a
        # rank-12 EKF update instead of (K, 4M, 4M) + a (D, D) solve.
        cam_idx = jnp.stack([slot_a, slot_b])
        obs_c = obs_k[:, cam_idx]
        mask_c = (involved_mask_k & use[:, None])[:, cam_idx]
        state = _gate_and_update(
            state, params, method, pos, obs_c, mask_c, use, dof,
            cam_idx=cam_idx, ns_iters=ns_iters, w=w,
        )
    else:
        state = _gate_and_update(
            state, params, method, pos, obs_k,
            involved_mask_k & use[:, None], use, dof, ns_iters=ns_iters, w=w,
        )

    # Persist positions of tracks initialized during this phase (the
    # reference keeps Feature::position for later updates; scatter the
    # compacted slots back into the pool).
    tracks = state.tracks._replace(
        pos=state.tracks.pos.at[idx].set(
            jnp.where(newly_init[:, None], pos, state.tracks.pos[idx])
        ),
        initialized=state.tracks.initialized.at[idx].set(
            state.tracks.initialized[idx] | newly_init
        ),
    )
    # Delete the involved observations from every track.
    tracks = tracks._replace(obs_valid=tracks.obs_valid & ~involved_mask)
    state = state._replace(tracks=tracks)

    return compact_after_removal(state, slot_a, slot_b)


def _online_reset(state: FilterState, params: MsckfParams) -> FilterState:
    """Uncertainty watchdog (reference onlineReset, msckf_vio.cpp:1186-1236)."""
    stds_ok = (
        (jnp.sqrt(state.P[12, 12]) < params.position_std_threshold)
        & (jnp.sqrt(state.P[13, 13]) < params.position_std_threshold)
        & (jnp.sqrt(state.P[14, 14]) < params.position_std_threshold)
    )
    enabled = params.position_std_threshold > 0

    def reset(s: FilterState) -> FilterState:
        tracks = s.tracks._replace(
            fid=jnp.full_like(s.tracks.fid, -1),
            obs_valid=jnp.zeros_like(s.tracks.obs_valid),
            initialized=jnp.zeros_like(s.tracks.initialized),
        )
        return s._replace(
            num_cams=jnp.zeros_like(s.num_cams),
            P=jnp.diag(params.init_cov_diag),
            tracks=tracks,
            online_reset_count=s.online_reset_count + 1,
        )

    return jax.lax.cond(enabled & ~stds_ok, reset, lambda s: s, state)


def _publish(state: FilterState, time, params: MsckfParams) -> PoseOutput:
    """Pose export (reference publish, msckf_vio.cpp:1238-1261): body pose
    T_b_w = T_imu_body * T_i_w * T_imu_body^-1; Hamilton quaternion of the
    JPL world->IMU state equals the body->world Hamilton quaternion."""
    R_bi = params.T_body_imu_R  # R(T_imu_body^-1) = R(T_imu_body)^T is stored
    R_i_w = jpl_to_rot(state.imu.q).T
    R_b_w = R_bi @ R_i_w @ R_bi.T
    p_b = R_bi @ state.imu.p
    q_ham = rot_to_jpl(R_b_w.T)  # JPL of world->body == Hamilton of body->world
    # Position covariance (the reference marshals P's pose blocks into an
    # odometry message then discards them, msckf_vio.cpp:1262-1293; here the
    # 3x3 position block ships with every pose).  p_b = R_bi p_i, so the
    # body-frame covariance is R_bi P_pp R_bi^T.
    P_pp = jax.lax.dynamic_slice(state.P, (12, 12), (3, 3))
    p_cov = R_bi @ P_pp @ R_bi.T
    return PoseOutput(
        time=time,
        p=p_b,
        q_xyzw=q_ham,
        p_cov=p_cov,
        num_cams=state.num_cams,
        num_tracks=jnp.sum(state.tracks.fid >= 0),
        tracking_rate=state.tracking_rate,
    )


def _propagate_augment_observe(
    state: FilterState, frame: FrameFeatures, imu: ImuBatch, params: MsckfParams
) -> FilterState:
    """Shared front half of ``filter_step`` and ``filter_internals``: time
    origin on the first frame (featureCallback, msckf_vio.cpp:314-317), IMU
    propagation, state augmentation, observation bookkeeping.  One
    implementation so the debug dump can never silently diverge from the
    live filter."""
    first = state.next_sid == 0
    state = state._replace(
        imu=state.imu._replace(time=jnp.where(first, frame.time, state.imu.time))
    )
    state = propagate(state, imu, params.Q_imu)
    state = augment_state(state, frame.time)
    return add_feature_observations(
        state, frame.fid, frame.uv, frame.valid, quality=frame.quality
    )


def filter_step(
    state: FilterState,
    frame: FrameFeatures,
    imu: ImuBatch,
    params: MsckfParams,
    cfg: FilterConfig,
    method: str = "qr",
):
    """One full frame of the back-end.  jit/scan-able.

    Filter-side matmuls run at ``cfg.matmul_precision`` (default float32,
    exact f32).  A reduced-precision default (bf16 passes) was measured
    before the GPU port to degrade accuracy (bench-scene ATE 0.022 vs CPU
    0.004) and to make it batch-size dependent (B=16 regressed to 0.14
    with bit-identical lanes diverging), because its rounding depends on
    how XLA tiles the batch.  The filter's matrices are tiny (<=D^2 with
    D~141), so full precision costs little; tensorfloat32 is the
    measurable alternative (PERF.md)."""
    with matmul_precision_scope(cfg.matmul_precision):
        state = _propagate_augment_observe(state, frame, imu, params)
        state = _remove_lost_features(
            state, params, method, cfg.max_update_tracks, cfg.ns_iters, cfg=cfg
        )
        state = jax.lax.cond(
            state.num_cams >= cfg.max_cam_state_size,
            lambda s: _prune_cam_states(
                s, params, method, cfg.max_update_tracks, cfg.ns_iters, cfg=cfg
            ),
            lambda s: s,
            state,
        )
        out = _publish(state, frame.time, params)
        state = _online_reset(state, params)
        return state, out


def filter_internals(
    state: FilterState,
    frame: FrameFeatures,
    imu: ImuBatch,
    params: MsckfParams,
    cfg: FilterConfig,
    method: str = "qr",
) -> dict:
    """Differential-debug dump of one frame's update-phase tensors.

    The reference dumps its stacked Jacobians / residuals at frame
    ``n_pub == 9`` into debug_msckfvio.txt for differential debugging
    against the original Eigen implementation (msckf_vio.cpp:719-723).
    This is the fixed-shape analog: given the filter state *before* a
    frame, it replays propagation/augmentation/observation bookkeeping and
    returns (without mutating anything) every tensor the lost-feature
    update would consume — candidate track ids, triangulated positions,
    the OC-projected Jacobian blocks, nullspace-projected stacked rows,
    gating scores vs their chi-square thresholds, and the covariance
    diagonal.  Drive it with ``apps/run_euroc.py --dump-filter-frame N``.
    """
    with matmul_precision_scope(cfg.matmul_precision):
        state = _propagate_augment_observe(state, frame, imu, params)

        idx, obs_c, obs_valid_c, use, dof, pos, drop_only, candidates = _lost_candidates(
            state, params, cfg.max_update_tracks
        )
        obs_mask = obs_valid_c & use[:, None]
        blocks = track_blocks(
            pos, obs_c, obs_mask, state.cams, state.gravity,
            params.R_c0_c1, params.t_c0_c1,
        )
        jacs = track_jacobians(
            pos, obs_c, obs_mask, state.cams, state.gravity,
            params.R_c0_c1, params.t_c0_c1,
        )
        if cfg.noise_adaptive:
            # Mirror the live filter's SNR weighting in the dumped tensors.
            sw = jnp.sqrt(
                _snr_weights(state.tracks.quality[idx], obs_valid_c, cfg)
            )
            blocks = blocks._replace(
                H_x=blocks.H_x * sw[:, None, None, None].astype(blocks.H_x.dtype),
                H_f=blocks.H_f * sw[:, None, None, None].astype(blocks.H_f.dtype),
                r=blocks.r * sw[:, None, None].astype(blocks.r.dtype),
            )
            jacs = jacs._replace(
                H_o=jacs.H_o * sw[:, None, None].astype(jacs.H_o.dtype),
                r_o=jacs.r_o * sw[:, None].astype(jacs.r_o.dtype),
            )
        gamma_qr = gating_scores(jacs, state.P, params.sigma2)
        gamma_schur = schur_gating(blocks, state.P, params.sigma2, cfg.ns_iters)
        thresh = params.chi2_table[dof]
        return {
            "num_cams": state.num_cams,
            "cam_q": state.cams.q,
            "cam_p": state.cams.p,
            "cov_diag": jnp.diagonal(state.P),
            "candidate_idx": idx,
            "candidate_fid": state.tracks.fid[idx],
            "candidate_use": use,
            "candidate_dof": dof,
            "n_lost_short": jnp.sum(drop_only),
            "n_candidates": jnp.sum(candidates),
            "pos_w": pos,
            "obs": obs_c,
            "obs_mask": obs_mask,
            # Per-(track, camera) OC-projected measurement blocks
            # (measurementJacobian, msckf_vio.cpp:610-677).
            "H_x_blocks": blocks.H_x,
            "H_f_blocks": blocks.H_f,
            "r_blocks": blocks.r,
            # Nullspace-projected stacked rows (featureJacobian, :679-776).
            "H_o": jacs.H_o,
            "r_o": jacs.r_o,
            "rows_valid": jacs.rows_valid,
            # Gating (gatingTest, :909-935) through both linear algebras.
            "gamma_qr": gamma_qr,
            "gamma_schur": gamma_schur,
            "chi2_threshold": thresh,
            "gate_pass_qr": use & (gamma_qr < thresh),
            "gate_pass_schur": use & (gamma_schur < thresh),
        }


def init_state(cfg: FilterConfig, calib: StereoCalib, dtype=jnp.float64) -> FilterState:
    return init_filter_state(cfg, calib, dtype)


def reset_filter(state: FilterState, cfg: FilterConfig, calib: StereoCalib) -> FilterState:
    """Full manual reset (reference resetCallback, msckf_vio.cpp:243-304):
    rebuilds the state/covariance from config, clears cameras, features and
    buffered timing — keeping only the dtype/shapes.  Never invoked by the
    sequence drivers (as in the reference); exposed for operators."""
    fresh = init_filter_state(cfg, calib, state.P.dtype)
    return fresh._replace(gravity=state.gravity)
