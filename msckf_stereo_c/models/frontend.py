"""Stereo feature-tracking front-end (the reference's ``ImageProcessor``,
image_processor.cpp:139-1211) as a single fixed-shape jittable step.

Design: a pool of ``N = max_features`` track slots replaces the
``GridFeatures`` map-of-vectors; per-grid top-k selection and lifetime
pruning are rank computations over the pool (argsort by composite keys), and
feature detection is the dense grid FAST of ``ops.fast``.  Pyramids are
carried as tuples of per-level arrays so a whole sequence can be scanned.

Pipeline per frame (mirroring stereoCallback):
  pyramids -> [first frame? detect : predict + KLT track + stereo match]
  -> grid bucket -> add new features (masked FAST + stereo match + fill)
  -> prune overfull grids -> publish normalized stereo measurements.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FrontendConfig, StereoCalib, matmul_precision_scope
from ..ops.camera import distort_points, undistort_points
from ..ops.fast import detect_grid_corners, occupancy_from_points
from ..ops.klt import optical_flow_pyr_lk
from ..ops.klt_corr import (
    fused_stereo_supported,
    optical_flow_lk_corr_l0,
    optical_flow_pyr_lk_corr,
    stereo_anchor_lr_fused,
)
from ..ops.klt_gemm import optical_flow_pyr_lk_gemm

from ..ops.pyramid import build_pyramid, smooth5
from ..ops.ransac import two_point_ransac
from ..utils.lie import skew, so3_exp

_KLT_IMPLS = {
    "gemm": optical_flow_pyr_lk_gemm,
    "corr": optical_flow_pyr_lk_corr,
    "gather": optical_flow_pyr_lk,
}


def _norms(cfg: FrontendConfig):
    """(general, anchor) photometric norms for cfg.klt_norm.  'mixed' uses
    the damped joint translation+offset solve for the frame-to-frame
    problems (offset-invariant on texture, near-raw on ramps, noise-benign)
    and the full affine-photometric solve only for the anchor alignment,
    whose template spans the whole exposure-drift range (birth gain vs
    current gain).  See docs/STRESS_NOTES.md round 5 for why neither
    'gain' nor 'zeromean' everywhere survives the 5-seed protocol."""
    if cfg.klt_norm == "mixed":
        return "offset", "gain"
    if cfg.klt_norm == "anchor_gain":
        # Frame-to-frame solves keep the raw (reference-faithful,
        # bit-identical-to-'none') path — zero SNR cost, no ramp pathology —
        # and ONLY the anchor alignment gets the affine-photometric solve:
        # the one problem whose template (stored at birth) spans the full
        # exposure-drift range, and the identified noise-locked-bias
        # mechanism (docs/STRESS_NOTES.md rounds 4-5).
        return "none", "gain"
    return cfg.klt_norm, cfg.klt_norm


def _klt_fn(name: str, norm: str = "none"):
    try:
        fn = _KLT_IMPLS[name]
    except KeyError:
        raise ValueError(
            f"unknown klt_impl {name!r}; choose from {sorted(_KLT_IMPLS)}"
        ) from None
    if name == "corr" and norm != "none":
        import functools

        fn = functools.partial(fn, norm=norm)
    return fn


class TrackerState(NamedTuple):
    """Fixed-pool replacement for GridFeatures (image_processor.h:100-113)."""

    pts0: jnp.ndarray  # (N, 2) cam0 pixel positions
    pts1: jnp.ndarray  # (N, 2) cam1 pixel positions
    fid: jnp.ndarray  # (N,) int32, -1 = free
    lifetime: jnp.ndarray  # (N,) int32
    response: jnp.ndarray  # (N,)
    next_fid: jnp.ndarray  # () int32
    # Interpolated full-res template patches at pts0 (N, patch+2, patch+2),
    # written by the merged stereo call and reused as the next frame's
    # temporal-KLT templates (see FrontendConfig.tmpl_carry).
    tmpl: jnp.ndarray
    # Per-track cam0 depth estimate from the last stereo match (meters;
    # 0 = unknown).  Feeds the translation-aware temporal prediction: the
    # IMU homography warp only models rotation, and at close range / fast
    # translation the translation-induced flow (fx*v*dt/Z, e.g. ~17 px at
    # 3.6 m and 2.7 m/s) exceeds the single-level search radius.
    depth: jnp.ndarray
    # Birth-time template patches (N, patch+2, patch+2), fixed for the
    # track's life — the drift-free reference for anchor refinement
    # (FrontendConfig.anchor_refine).
    anchor: jnp.ndarray
    # Per-track template minimum gradient eigenvalue per pixel from the
    # latest stereo match (the KLT localization-SNR proxy; 0 = unknown).
    # Published as FrameOutput.quality for the filter's SNR-adaptive
    # observation noise (FilterConfig.noise_adaptive).
    snr: jnp.ndarray


class FrontendParams(NamedTuple):
    """Device-side calibration for the front-end."""

    K0: jnp.ndarray  # (4,) fx fy cx cy cam0
    D0: jnp.ndarray  # (4,)
    K1: jnp.ndarray  # (4,)
    D1: jnp.ndarray  # (4,)
    R_c0_c1: jnp.ndarray  # (3,3) rotation of T_cn_cnm1
    t_c0_c1: jnp.ndarray  # (3,)
    R_imu_cam0: jnp.ndarray  # (3,3) R(T_cam_imu) cam0
    R_imu_cam1: jnp.ndarray  # (3,3) R(T_cam_imu) cam1
    E: jnp.ndarray  # (3,3) essential matrix [t]x R
    norm_pixel_unit: jnp.ndarray  # () 4/(fx0+fy0+fx1+fy1)


class FrameOutput(NamedTuple):
    fid: jnp.ndarray  # (N,) int32
    uv: jnp.ndarray  # (N, 4) normalized stereo observations
    valid: jnp.ndarray  # (N,)
    # TrackingInfo counters (data_msg.h:48-55).
    before_tracking: jnp.ndarray
    after_tracking: jnp.ndarray
    after_matching: jnp.ndarray
    after_ransac: jnp.ndarray
    # Diagnostics: tracks whose anchor refinement converged + was accepted
    # this frame (0 when anchor_refine is inactive).  No array default: a
    # NamedTuple default would be materialized as a device constant at
    # import time, before any jax.config the caller might set.
    anchor_accepted: jnp.ndarray
    # (N,) per-track tracking-SNR proxy (template min gradient eigenvalue
    # per pixel; 0 = unknown/neutral) for the filter's SNR-adaptive
    # observation noise.
    quality: jnp.ndarray


def make_frontend_params(calib: StereoCalib, dtype=jnp.float32) -> FrontendParams:
    T01 = calib.T_cam0_cam1_mat()
    R01 = T01[:3, :3]
    t01 = T01[:3, 3]
    E = np.asarray(skew(jnp.asarray(t01))) @ R01
    fx0, fy0 = calib.cam0.intrinsics[:2]
    fx1, fy1 = calib.cam1.intrinsics[:2]
    # R(T_cam_imu) for cam1 = R(T_cn_cnm1 @ T_cam0_imu):
    R_i_c1 = (T01 @ calib.cam0.T_cam_imu_mat())[:3, :3]
    return FrontendParams(
        K0=jnp.asarray(calib.cam0.intrinsics, dtype),
        D0=jnp.asarray(calib.cam0.distortion_coeffs, dtype),
        K1=jnp.asarray(calib.cam1.intrinsics, dtype),
        D1=jnp.asarray(calib.cam1.distortion_coeffs, dtype),
        R_c0_c1=jnp.asarray(R01, dtype),
        t_c0_c1=jnp.asarray(t01, dtype),
        R_imu_cam0=jnp.asarray(calib.cam0.T_cam_imu_mat()[:3, :3], dtype),
        R_imu_cam1=jnp.asarray(R_i_c1, dtype),
        E=jnp.asarray(E, dtype),
        norm_pixel_unit=jnp.asarray(4.0 / (fx0 + fy0 + fx1 + fy1), dtype),
    )


def init_tracker_state(cfg: FrontendConfig, dtype=jnp.float32) -> TrackerState:
    N = cfg.max_features
    q = cfg.patch_size + 2
    return TrackerState(
        pts0=jnp.zeros((N, 2), dtype),
        pts1=jnp.zeros((N, 2), dtype),
        fid=-jnp.ones((N,), jnp.int32),
        lifetime=jnp.zeros((N,), jnp.int32),
        response=jnp.zeros((N,), dtype),
        next_fid=jnp.zeros((), jnp.int32),
        tmpl=jnp.zeros((N, q, q), dtype),
        depth=jnp.zeros((N,), dtype),
        anchor=jnp.zeros((N, q, q), dtype),
        snr=jnp.zeros((N,), dtype),
    )


def _tmpl_carry_active(cfg: FrontendConfig) -> bool:
    """Template carry requires single-level temporal AND stereo fine calls
    of the corr implementation (the carried patch must be exactly what the
    next call would extract: same image pair granularity, same level)."""
    return (
        cfg.tmpl_carry
        and cfg.klt_impl == "corr"
        and cfg.temporal_levels == 1
        and cfg.stereo_levels == 1
    )


def _fused_stereo_active(cfg: FrontendConfig, img_shape) -> bool:
    """The fused stereo+LR+anchor fine level (ops.klt_corr.
    stereo_anchor_lr_fused) replaces the unfused three-call composition when
    the configuration matches its geometry: corr implementation, single
    fine level, full-union left-right check, image large enough for the
    margined search windows."""
    return (
        cfg.klt_impl == "corr"
        and cfg.stereo_levels == 1
        and cfg.stereo_lr_threshold > 0
        and cfg.stereo_lr_survivors
        and fused_stereo_supported(img_shape, cfg.patch_size)
    )


def _grid_code(pts, img_shape, cfg: FrontendConfig):
    H, W = img_shape
    gh = H // cfg.grid_row
    gw = W // cfg.grid_col
    row = jnp.clip((pts[:, 1] // gh).astype(jnp.int32), 0, cfg.grid_row - 1)
    col = jnp.clip((pts[:, 0] // gw).astype(jnp.int32), 0, cfg.grid_col - 1)
    return row * cfg.grid_col + col


def _rank_within_group(group: jnp.ndarray, order_key: jnp.ndarray, valid: jnp.ndarray, num_groups: int):
    """Rank of each element within its group when sorted by ``order_key``
    ascending; invalid elements get a huge rank.  Pure sort/cumsum — no
    dynamic shapes."""
    n = group.shape[0]
    g = jnp.where(valid, group, num_groups)
    # Two-key sort (group, then key).  A float composite g*BIG+key would lose
    # the key entirely in f32; lexsort keeps both exact.
    sorted_idx = jnp.lexsort((order_key, g))
    sorted_g = g[sorted_idx]
    pos = jnp.arange(n)
    first_pos = jnp.searchsorted(sorted_g, jnp.arange(num_groups + 1))
    rank_sorted = pos - first_pos[sorted_g]
    rank = jnp.zeros(n, jnp.int32).at[sorted_idx].set(rank_sorted.astype(jnp.int32))
    return jnp.where(valid, rank, n)


def _detect_candidates(
    pts0: jnp.ndarray,
    pts_valid: jnp.ndarray,
    img_top: jnp.ndarray,
    cfg: FrontendConfig,
    img_shape: Tuple[int, int],
):
    """FAST corners away from current tracks, sieved to the per-grid top
    ``grid_max_feature_num`` by response (reference addNewFeatures detection
    + sieve, image_processor.cpp:632-677).  Returns fixed-size candidate
    arrays (C = num_grids * grid_max_feature_num)."""
    occupied = occupancy_from_points(pts0, pts_valid, img_shape, cfg.detector_cell)
    corners = detect_grid_corners(img_top, float(cfg.fast_threshold), cfg.detector_cell, occupied)

    cand_grid = _grid_code(corners.xy, img_shape, cfg)
    rank = _rank_within_group(cand_grid, -corners.score, corners.valid, cfg.num_grids)
    C = cfg.num_grids * cfg.grid_max_feature_num
    slot = jnp.where(rank < cfg.grid_max_feature_num, cand_grid * cfg.grid_max_feature_num + rank, C)
    cand_xy = jnp.zeros((C, 2), corners.xy.dtype).at[slot].set(corners.xy, mode="drop")
    cand_score = jnp.zeros((C,), corners.score.dtype).at[slot].set(corners.score, mode="drop")
    cand_valid = jnp.zeros((C,), bool).at[slot].set(corners.valid, mode="drop")

    # Budget: keep the most NEEDED candidates.  Slot layout is grid-major
    # (slot = grid * grid_max + within-grid response rank), so a candidate's
    # "need rank" is its within-grid rank minus the grid's estimated vacancy
    # (from the temporally-tracked points; the exact vacancy isn't known
    # until after the stereo gate).  Sort (need rank, -response), keep B.
    B = cfg.cand_budget
    if B and B < C:
        est_count = jnp.zeros((cfg.num_grids,), jnp.int32).at[
            jnp.where(pts_valid, _grid_code(pts0, img_shape, cfg), cfg.num_grids)
        ].add(1, mode="drop")
        g_of_slot = jnp.arange(C, dtype=jnp.int32) // cfg.grid_max_feature_num
        r_of_slot = jnp.arange(C, dtype=jnp.int32) % cfg.grid_max_feature_num
        need = jnp.maximum(cfg.grid_min_feature_num - est_count, 0)
        need_rank = jnp.where(cand_valid, r_of_slot - need[g_of_slot], C)
        idx = jnp.lexsort((-cand_score, need_rank))[:B]
        return cand_xy[idx], cand_score[idx], cand_valid[idx]
    return cand_xy, cand_score, cand_valid


def _stereo_match_merged(
    pyr0: Sequence[jnp.ndarray],
    pyr1: Sequence[jnp.ndarray],
    pts_surv: jnp.ndarray,
    surv_guess: jnp.ndarray,
    surv_valid: jnp.ndarray,
    cand_xy: jnp.ndarray,
    cand_valid: jnp.ndarray,
    params: FrontendParams,
    cfg: FrontendConfig,
    img_shape: Tuple[int, int],
    anchor_sp: jnp.ndarray | None = None,
):
    """Stereo match surviving tracks AND detection candidates in one pass.

    Surviving tracks carry their previous disparity (within ~1-2 px: at
    EuRoC speeds the per-frame depth change moves disparity by ~1 px, well
    inside the full-res search radius) and need ONLY the full-resolution
    level; candidates start from the extrinsic-rotation guess and walk the
    coarse levels first (reference stereoMatch, image_processor.cpp:534-620).
    Both end on the SAME full-resolution level, which runs as a single
    concatenated KLT call (per-level cost is per-feature-lane) with one
    epipolar gate over the union.  Candidate
    numerics are identical level-by-level to a full-pyramid walk; validity
    is only ever taken from the final full-resolution level.

    With the default configuration (_fused_stereo_active) the fine level
    runs as ops.klt_corr.stereo_anchor_lr_fused — one call covering anchor
    refinement (``anchor_sp`` = birth templates for the survivor lanes),
    the forward match, and the backward left-right round trip, sharing
    patch extractions (an op-count reduction).  Returns
    ((pts0_surv, pts1_surv, ok_surv, depth_surv),
     (cand_pts1, cand_ok, cand_depth), (surv_tmpl, cand_tmpl), n_anchor)
    where pts0_surv are the (possibly anchor-refined) cam0 positions."""
    H, W = img_shape
    norm, anchor_norm = _norms(cfg)
    klt = _klt_fn(cfg.klt_impl, norm)

    # Candidate initial guess: rotate cam0 rays by R_c0_c1 into cam1.
    xn = undistort_points(cand_xy, params.K0, params.D0, model=cfg.distortion_model0, R=params.R_c0_c1)
    cguess = distort_points(xn, params.K1, params.D1, model=cfg.distortion_model1)
    if len(pyr0) > 2:
        s = 4.0  # scale of pyramid level 2
        res_c = klt(
            pyr0[2:], pyr1[2:], cand_xy / s, cguess / s, cand_valid,
            win=cfg.patch_size, iters=cfg.max_iteration, eps=cfg.track_precision,
        )
        # Non-final levels only refine the guess; validity checks belong
        # to the final level (run below at full resolution).
        cguess = res_c.pts * s
    sl = max(1, min(cfg.stereo_levels, len(pyr0)))
    if len(pyr0) > sl:
        # Candidate-only walk of the levels between the coarse pair and the
        # shared fine levels (with the default sl=1 this is level 1;
        # cfg.cand_level1=False skips it — see config.py).
        for lvl in range(min(2, len(pyr0)) - 1, sl - 1, -1):
            if lvl == 1 and not cfg.cand_level1:
                continue
            s = float(2 ** lvl)
            res_m = klt(
                pyr0[lvl:lvl + 1], pyr1[lvl:lvl + 1], cand_xy / s, cguess / s,
                cand_valid,
                win=cfg.patch_size, iters=cfg.max_iteration, eps=cfg.track_precision,
            )
            cguess = res_m.pts * s

    n_surv = pts_surv.shape[0]
    pts0 = jnp.concatenate([pts_surv, cand_xy], axis=0)
    guess = jnp.concatenate([surv_guess, cguess], axis=0)
    valid = jnp.concatenate([surv_valid, cand_valid], axis=0)
    sp_all = None
    rt2 = None
    me_all = None
    n_anchor = jnp.zeros((), jnp.int32)
    if _fused_stereo_active(cfg, img_shape):
        pts0, acc, res, rt2, sp_all, me_all = stereo_anchor_lr_fused(
            pyr0[0], pyr1[0], pts0, guess, valid,
            win=cfg.patch_size, iters=cfg.max_iteration, eps=cfg.track_precision,
            anchor_sp=anchor_sp,
            anchor_valid=surv_valid if anchor_sp is not None else None,
            anchor_radius=cfg.anchor_radius,
            norm=norm,
            anchor_norm=anchor_norm,
        )
        if acc is not None:
            n_anchor = jnp.sum(acc).astype(jnp.int32)
        if not _tmpl_carry_active(cfg):
            sp_all = None  # nothing maintains the carried templates
    elif _tmpl_carry_active(cfg):
        res, sp_all = optical_flow_lk_corr_l0(
            pyr0[0], pyr1[0], pts0, guess, valid,
            win=cfg.patch_size, iters=cfg.max_iteration, eps=cfg.track_precision,
            want_tmpl=True, norm=norm,
        )
    else:
        res = klt(
            pyr0[:sl], pyr1[:sl], pts0, guess, valid,
            win=cfg.patch_size, iters=cfg.max_iteration, eps=cfg.track_precision,
        )
    pts1 = res.pts
    ok = res.valid & valid
    ok = ok & (pts1[:, 0] >= 0) & (pts1[:, 0] <= W - 1) & (pts1[:, 1] >= 0) & (pts1[:, 1] <= H - 1)

    # Epipolar consistency with the known essential matrix — one pass over
    # the union (reference stereoMatch epipolar gate,
    # image_processor.cpp:585-617).
    un0 = undistort_points(pts0, params.K0, params.D0, model=cfg.distortion_model0)
    un1 = undistort_points(pts1, params.K1, params.D1, model=cfg.distortion_model1)
    p0h = jnp.concatenate([un0, jnp.ones_like(un0[:, :1])], axis=1)
    p1h = jnp.concatenate([un1, jnp.ones_like(un1[:, :1])], axis=1)
    line = p0h @ params.E.T
    dist = jnp.abs(jnp.sum(p1h * line, axis=1)) / jnp.sqrt(
        line[:, 0] ** 2 + line[:, 1] ** 2 + 1e-12
    )
    ok = ok & (dist <= cfg.stereo_threshold * params.norm_pixel_unit)

    # Cheirality along the baseline: the component of (un0 - un1) along the
    # predicted disparity direction must be non-negative (a point at
    # infinity has zero disparity; finite wall depths give strictly
    # positive).  Free, and kills the wrong locks that land PAST the
    # infinity point on the epipolar line.
    xn_inf = undistort_points(
        pts0, params.K0, params.D0, model=cfg.distortion_model0, R=params.R_c0_c1
    )  # normalized cam1 coords of the infinity point of each cam0 ray
    bdir = -params.t_c0_c1[:2]
    bnorm = jnp.sqrt(jnp.sum(bdir * bdir)) + 1e-12
    disp_along = ((xn_inf - un1) @ bdir) / bnorm
    ok = ok & (disp_along >= -0.5 * params.norm_pixel_unit)
    # Per-lane depth estimate (disp_along = |t_xy|/Z in normalized units) —
    # carried in TrackerState.depth for the translation-aware temporal
    # prediction next frame.  Clamp: unmatched/at-infinity lanes read 0.
    depth = jnp.where(
        ok, bnorm / jnp.maximum(disp_along, bnorm / 1000.0), 0.0
    ).astype(pts1.dtype)

    # Left-right consistency (see FrontendConfig.stereo_lr_threshold): track
    # the matched cam1 points back to cam0 at full resolution and require
    # the round trip to land on the original cam0 position.  A wrong lock
    # along the epipolar line tracks back to ITS OWN cam0 image, ~a blob
    # spacing away from pts0.
    if rt2 is not None:
        # Fused path: the round trip already ran inside
        # stereo_anchor_lr_fused (rt2 = +inf where the backward track is
        # invalid); fold its gate over the full union.
        ok = ok & (rt2 <= cfg.stereo_lr_threshold**2)
    elif cfg.stereo_lr_threshold > 0:
        # Unfused backward pass.  The DEFAULT scope is the full
        # survivor+candidate union (config.py stereo_lr_survivors=True):
        # survivors' carried disparity gets corrupted mid-life under
        # occlusion/texture-dropout, and the per-frame survivor round trip
        # is what catches it (130 s stress gate 0.036 -> 0.257 m without
        # it, measured before the GPU port).  stereo_lr_survivors=
        # False narrows the check to candidate lanes — a throughput-only
        # knob for benign scenes, measured UNSAFE at long horizon.  Static
        # slice — n_surv is a Python int.
        lo = 0 if cfg.stereo_lr_survivors else n_surv
        res_b = klt(
            pyr1[:1], pyr0[:1], pts1[lo:], pts0[lo:], ok[lo:],
            win=cfg.patch_size, iters=cfg.max_iteration, eps=cfg.track_precision,
        )
        rt2_u = jnp.sum((res_b.pts - pts0[lo:]) ** 2, axis=1)
        ok_lr = ok[lo:] & res_b.valid & (rt2_u <= cfg.stereo_lr_threshold**2)
        ok = jnp.concatenate([ok[:lo], ok_lr], axis=0)

    tmpl = (None, None) if sp_all is None else (sp_all[:n_surv], sp_all[n_surv:])
    me = (None, None) if me_all is None else (me_all[:n_surv], me_all[n_surv:])
    return (
        (pts0[:n_surv], pts1[:n_surv], ok[:n_surv], depth[:n_surv]),
        (pts1[n_surv:], ok[n_surv:], depth[n_surv:]),
        tmpl,
        n_anchor,
        me,
    )


def _allocate_new_features(
    state: TrackerState,
    cand_xy: jnp.ndarray,
    cand_score: jnp.ndarray,
    cand_pts1: jnp.ndarray,
    cand_ok: jnp.ndarray,
    cfg: FrontendConfig,
    img_shape: Tuple[int, int],
    fill_to: int,
    cand_tmpl: jnp.ndarray | None = None,
    cand_depth: jnp.ndarray | None = None,
    cand_snr: jnp.ndarray | None = None,
):
    """Fill under-populated grids with stereo-matched candidates (reference
    addNewFeatures / initializeFirstFrame fill, image_processor.cpp:735-750).
    ``fill_to``: per-grid target population (grid_min_feature_num)."""
    N = cfg.max_features

    # Fill grids that are below the target population.
    pool_grid = _grid_code(state.pts0, img_shape, cfg)
    pool_count = jnp.zeros((cfg.num_grids,), jnp.int32).at[
        jnp.where(state.fid >= 0, pool_grid, cfg.num_grids)
    ].add(1, mode="drop")
    vacancy = jnp.maximum(fill_to - pool_count, 0)  # (G,)

    cgrid = _grid_code(cand_xy, img_shape, cfg)
    crank = _rank_within_group(cgrid, -cand_score, cand_ok, cfg.num_grids)
    accept = cand_ok & (crank < vacancy[cgrid])

    # Allocate accepted candidates into free pool slots.
    free = state.fid < 0
    free_rank = jnp.cumsum(free) - 1
    slot_of_rank = jnp.full((N,), N, jnp.int32).at[
        jnp.where(free, free_rank, N)
    ].set(jnp.arange(N, dtype=jnp.int32), mode="drop")
    n_free = jnp.sum(free)
    acc_rank = jnp.cumsum(accept) - 1
    target = jnp.where(
        accept & (acc_rank < n_free), slot_of_rank[jnp.clip(acc_rank, 0, N - 1)], N
    )

    new_fid = state.next_fid + acc_rank.astype(jnp.int32)
    pts0 = state.pts0.at[target].set(cand_xy, mode="drop")
    pts1 = state.pts1.at[target].set(cand_pts1, mode="drop")
    fid = state.fid.at[target].set(new_fid, mode="drop")
    lifetime = state.lifetime.at[target].set(1, mode="drop")
    response = state.response.at[target].set(cand_score.astype(state.response.dtype), mode="drop")
    tmpl = state.tmpl
    if cand_tmpl is not None:
        tmpl = tmpl.at[target].set(cand_tmpl.astype(tmpl.dtype), mode="drop")
    depth = state.depth
    if cand_depth is not None:
        depth = depth.at[target].set(cand_depth.astype(depth.dtype), mode="drop")
    anchor = state.anchor
    if cand_tmpl is not None:
        # The candidate's interpolated stereo template IS its birth-time
        # appearance at its birth position — the anchor.
        anchor = anchor.at[target].set(cand_tmpl.astype(anchor.dtype), mode="drop")
    snr = state.snr
    if cand_snr is not None:
        snr = snr.at[target].set(cand_snr.astype(snr.dtype), mode="drop")
    n_added = jnp.sum(accept & (acc_rank < n_free)).astype(jnp.int32)

    return state._replace(
        pts0=pts0, pts1=pts1, fid=fid, lifetime=lifetime, response=response,
        next_fid=state.next_fid + n_added, tmpl=tmpl, depth=depth, anchor=anchor,
        snr=snr,
    )


def _prune_grid_features(state: TrackerState, cfg: FrontendConfig, img_shape):
    """Cap each grid at grid_max_feature_num, keeping the longest-lived
    (reference pruneGridFeatures, image_processor.cpp:758-768)."""
    grid = _grid_code(state.pts0, img_shape, cfg)
    rank = _rank_within_group(grid, -state.lifetime, state.fid >= 0, cfg.num_grids)
    keep = rank < cfg.grid_max_feature_num
    return state._replace(fid=jnp.where(keep, state.fid, -1))


def _publish(state: TrackerState, params: FrontendParams, cfg: FrontendConfig, dtype) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Undistort to normalized coordinates and emit the measurement set
    (reference publish, image_processor.cpp:1137-1182)."""
    un0 = undistort_points(state.pts0, params.K0, params.D0, model=cfg.distortion_model0)
    un1 = undistort_points(state.pts1, params.K1, params.D1, model=cfg.distortion_model1)
    uv = jnp.concatenate([un0, un1], axis=1).astype(dtype)
    return state.fid, uv, state.fid >= 0


def frontend_step(
    state: TrackerState,
    pyr0_prev: Sequence[jnp.ndarray],
    pyr0_curr: Sequence[jnp.ndarray],
    pyr1_curr: Sequence[jnp.ndarray],
    mean_gyro: jnp.ndarray,  # (3,) mean IMU angular velocity over the frame
    dt: jnp.ndarray,  # () time since previous frame
    is_first: jnp.ndarray,  # () bool
    params: FrontendParams,
    cfg: FrontendConfig,
    cam_vel: jnp.ndarray | None = None,  # (3,) cam0-frame linear velocity
):
    """One stereo frame through the tracker.  Returns (state, FrameOutput).

    ``cam_vel``: optional cam0-frame linear velocity (from the filter's
    velocity estimate, see vio._run_frontend) enabling the translation-aware
    temporal prediction; None keeps the reference's rotation-only warp."""
    with matmul_precision_scope(cfg.matmul_precision):
        return _frontend_step_impl(
            state, pyr0_prev, pyr0_curr, pyr1_curr, mean_gyro, dt,
            is_first, params, cfg, cam_vel,
        )


def _frontend_step_impl(
    state: TrackerState,
    pyr0_prev: Sequence[jnp.ndarray],
    pyr0_curr: Sequence[jnp.ndarray],
    pyr1_curr: Sequence[jnp.ndarray],
    mean_gyro: jnp.ndarray,
    dt: jnp.ndarray,
    is_first: jnp.ndarray,
    params: FrontendParams,
    cfg: FrontendConfig,
    cam_vel: jnp.ndarray | None = None,
):
    img_shape = pyr0_curr[0].shape
    H, W = img_shape
    before_tracking = jnp.sum(state.fid >= 0)

    # --- Track existing features cam0 prev -> curr (trackFeatures). ---
    w_cam = params.R_imu_cam0 @ mean_gyro
    R_p_c = so3_exp(w_cam * dt).T
    if cam_vel is None:
        # IMU-predicted homography warp K R_p_c K^-1 (the reference's
        # rotation-only predictFeatureTracking, image_processor.cpp:321-350).
        fx, fy, cx, cy = params.K0[0], params.K0[1], params.K0[2], params.K0[3]
        Km = jnp.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], state.pts0.dtype)
        Kinv = jnp.array(
            [[1 / fx, 0, -cx / fx], [0, 1 / fy, -cy / fy], [0, 0, 1]], state.pts0.dtype
        )
        Hm = Km @ R_p_c @ Kinv
        ph = jnp.concatenate([state.pts0, jnp.ones_like(state.pts0[:, :1])], axis=1)
        warped = ph @ Hm.T
        guess = warped[:, :2] / warped[:, 2:3]
        depth_ratio = jnp.ones_like(state.depth)
    else:
        # Translation-aware geometric prediction (no reference equivalent —
        # the reference compensates rotation only and relies on its 4-level
        # pyramid to absorb translation flow).  Each track's last stereo
        # depth back-projects it to a 3D point in the previous cam0 frame;
        # the camera moves cam_vel*dt; reproject through the full lens
        # model.  Depth-unknown tracks (depth=0) fall back to rotation-only
        # via an effectively infinite depth.
        xn = undistort_points(
            state.pts0, params.K0, params.D0, model=cfg.distortion_model0
        )
        z0 = jnp.where(state.depth > 0.3, state.depth, 1e6)
        X = jnp.concatenate([xn, jnp.ones_like(xn[:, :1])], axis=1) * z0[:, None]
        Xp = (X - cam_vel * dt) @ R_p_c.T
        zc = jnp.maximum(Xp[:, 2], 0.3)
        guess = distort_points(
            Xp[:, :2] / zc[:, None], params.K0, params.D0,
            model=cfg.distortion_model0,
        )
        # Stereo disparity scales as 1/Z: pre-scale the carried disparity
        # by the predicted depth change (ratio ~1 for depth-unknown lanes).
        depth_ratio = jnp.clip(z0 / zc, 0.5, 2.0)

    active = state.fid >= 0
    norm, anchor_norm = _norms(cfg)
    klt = _klt_fn(cfg.klt_impl, norm)
    tl = max(1, min(cfg.temporal_levels, len(pyr0_prev)))
    if _tmpl_carry_active(cfg):
        # The carried patches are bit-identical to what extraction at
        # (pyr0_prev[0], state.pts0) would produce (tested) — the merged
        # stereo call computed them from the same image at the same points.
        res, _ = optical_flow_lk_corr_l0(
            pyr0_prev[0], pyr0_curr[0], state.pts0, guess, active,
            win=cfg.patch_size, iters=cfg.max_iteration, eps=cfg.track_precision,
            tmpl_sp=state.tmpl, norm=norm,
        )
    else:
        res = klt(
            pyr0_prev[:tl], pyr0_curr[:tl], state.pts0, guess, active,
            win=cfg.patch_size, iters=cfg.max_iteration, eps=cfg.track_precision,
        )
    tracked_pts0 = res.pts
    tracked = active & res.valid
    tracked = tracked & (tracked_pts0[:, 0] >= 0) & (tracked_pts0[:, 0] <= W - 1)
    tracked = tracked & (tracked_pts0[:, 1] >= 0) & (tracked_pts0[:, 1] <= H - 1)

    # --- Anchor refinement (FrontendConfig.anchor_refine): re-align the
    # track against its birth template so frame-to-frame sub-pixel bias
    # cannot accumulate; accept small converged corrections only.  With the
    # fused stereo configuration this runs INSIDE the merged stereo call
    # (sharing its patch extraction); the standalone call remains for the
    # unfused configurations.
    fused = _fused_stereo_active(cfg, img_shape)
    anchor_on = cfg.anchor_refine and _tmpl_carry_active(cfg)
    n_anchor = jnp.zeros((), jnp.int32)
    if anchor_on and not fused:
        res_a, _ = optical_flow_lk_corr_l0(
            pyr0_curr[0], pyr0_curr[0], tracked_pts0, tracked_pts0, tracked,
            win=cfg.patch_size, iters=cfg.max_iteration, eps=cfg.track_precision,
            tmpl_sp=state.anchor, norm=anchor_norm,
        )
        corr2 = jnp.sum((res_a.pts - tracked_pts0) ** 2, axis=1)
        accept = tracked & res_a.valid & (corr2 <= cfg.anchor_radius**2)
        tracked_pts0 = jnp.where(accept[:, None], res_a.pts, tracked_pts0)
        n_anchor = jnp.sum(accept).astype(jnp.int32)

    after_tracking = jnp.sum(tracked)

    # --- Detect new-feature candidates away from the tracked features
    # (detection runs before the stereo gate so the candidate match can
    # share the fine-level KLT call below; a cell whose track is about to
    # die by the stereo gate refills next frame).  In the fused case
    # detection sees the pre-anchor positions (<= anchor_radius px off —
    # grid cells are ~100 px, occupancy cells 16 px). ---
    cand_xy, cand_score, cand_valid = _detect_candidates(
        tracked_pts0, tracked, pyr0_curr[0], cfg, img_shape
    )

    # --- Stereo match on the current pair: surviving tracks (carried
    # disparity guess, finest two levels) and candidates (extrinsic guess,
    # full pyramid) in one merged fine-level pass (anchor refinement and
    # the LR round trip fused in, where configured). ---
    disparity_guess = tracked_pts0 + (state.pts1 - state.pts0) * depth_ratio[:, None]
    (
        (tracked_pts0, pts1, matched, surv_depth),
        (cand_pts1, cand_ok, cand_depth),
        (surv_tmpl, cand_tmpl),
        n_anchor_fused,
        (surv_snr, cand_snr),
    ) = _stereo_match_merged(
        pyr0_curr, pyr1_curr, tracked_pts0, disparity_guess, tracked,
        cand_xy, cand_valid, params, cfg, img_shape,
        anchor_sp=state.anchor if (anchor_on and fused) else None,
    )
    n_anchor = n_anchor + n_anchor_fused  # at most one side is nonzero
    after_matching = jnp.sum(matched)

    # --- Optional temporal 2-pt RANSAC on both cameras (trackFeatures
    # steps 2-3; disabled by default, as in the shipping reference). ---
    if cfg.ransac_enabled:
        key = jax.random.fold_in(jax.random.PRNGKey(17), state.next_fid)
        w_cam1 = params.R_imu_cam1 @ mean_gyro
        R1_p_c = so3_exp(w_cam1 * dt).T
        in0 = two_point_ransac(
            state.pts0, tracked_pts0, matched, R_p_c, params.K0, params.D0,
            key, cfg.distortion_model0, cfg.ransac_threshold,
        )
        in1 = two_point_ransac(
            state.pts1, pts1, matched, R1_p_c, params.K1, params.D1,
            jax.random.fold_in(key, 1), cfg.distortion_model1, cfg.ransac_threshold,
        )
        matched = matched & in0 & in1

    surv = jnp.where(is_first, jnp.zeros_like(matched), matched)
    state = state._replace(
        pts0=jnp.where(surv[:, None], tracked_pts0, state.pts0),
        pts1=jnp.where(surv[:, None], pts1, state.pts1),
        fid=jnp.where(surv, state.fid, -1),
        lifetime=jnp.where(surv, state.lifetime + 1, 0),
        depth=jnp.where(surv, surv_depth, 0.0),
        tmpl=state.tmpl if surv_tmpl is None else jnp.where(
            surv[:, None, None], surv_tmpl.astype(state.tmpl.dtype), state.tmpl
        ),
        snr=state.snr if surv_snr is None else jnp.where(
            surv, surv_snr.astype(state.snr.dtype), jnp.zeros_like(state.snr)
        ),
    )

    # --- Fill under-populated grids with matched candidates; prune. ---
    state = _allocate_new_features(
        state, cand_xy, cand_score, cand_pts1, cand_ok, cfg, img_shape,
        cfg.grid_min_feature_num, cand_tmpl=cand_tmpl, cand_depth=cand_depth,
        cand_snr=cand_snr,
    )
    state = _prune_grid_features(state, cfg, img_shape)

    fid, uv, valid = _publish(state, params, cfg, uv_dtype(state))
    out = FrameOutput(
        fid=fid, uv=uv, valid=valid,
        before_tracking=before_tracking,
        after_tracking=after_tracking,
        after_matching=after_matching,
        after_ransac=jnp.sum(valid),
        anchor_accepted=n_anchor,
        quality=state.snr,
    )
    return state, out


def uv_dtype(state: TrackerState):
    return state.pts0.dtype


def pyramids_for(img: jnp.ndarray, cfg: FrontendConfig):
    """Image pyramid for the tracker.  With cfg.presmooth the FULL-RES
    level is the 5-tap binomial prefilter of the input (sensor-noise
    robustness; see FrontendConfig.presmooth) while coarse levels keep the
    exact OpenCV pyrDown chain built from the raw image (their decimation
    already averages noise down)."""
    pyr = build_pyramid(img, cfg.pyramid_levels)
    if cfg.presmooth:
        pyr = [smooth5(img)] + pyr[1:]
    return tuple(pyr)


def feature_lifetime_statistics(state: TrackerState):
    """Lifetime statistics over the live pool (the reference's disabled
    featureLifetimeStatistics, image_processor.cpp:1184-1211, kept for the
    same diagnostic purpose)."""
    import numpy as np

    lt = np.asarray(state.lifetime)[np.asarray(state.fid) >= 0]
    if lt.size == 0:
        return {"count": 0}
    return {
        "count": int(lt.size),
        "mean": float(lt.mean()),
        "median": float(np.median(lt)),
        "max": int(lt.max()),
        "histogram": np.bincount(lt).tolist(),
    }
