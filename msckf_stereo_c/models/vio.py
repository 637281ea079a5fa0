"""Full VIO system: front-end tracker + MSCKF back-end in one scanned step.

The reference's ``cg::System`` facade (system.cpp:11-56) forwards callbacks
between the ImageProcessor and MsckfVio on the host; here the whole
image -> features -> filter pipeline for a frame is a single jitted program,
and whole sequences run as ``lax.scan`` over stacked image tensors (chunked
by the host driver to bound memory).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FilterConfig, FrontendConfig, StereoCalib, matmul_precision_scope
from .frontend import (
    FrontendParams,
    TrackerState,
    frontend_step,
    init_tracker_state,
    make_frontend_params,
    pyramids_for,
)
from .msckf import FrameFeatures, MsckfParams, filter_step, make_params
from .propagation import ImuBatch
from .runner import apply_gravity_init, pack_imu_batches
from .state import FilterState, init_filter_state
from ..utils.quaternion import jpl_to_rot


class VioState(NamedTuple):
    tracker: TrackerState
    filt: FilterState
    pyr0_prev: Tuple[jnp.ndarray, ...]
    prev_time: jnp.ndarray  # () frontend previous frame time; <0 before first


def init_vio_state(
    fcfg: FrontendConfig,
    mcfg: FilterConfig,
    calib: StereoCalib,
    img_shape: Tuple[int, int],
    image_dtype=jnp.float32,
    filter_dtype=jnp.float64,
) -> VioState:
    H, W = img_shape
    dummy = jnp.zeros((H, W), image_dtype)
    return VioState(
        tracker=init_tracker_state(fcfg, image_dtype),
        filt=init_filter_state(mcfg, calib, filter_dtype),
        pyr0_prev=pyramids_for(dummy, fcfg),
        prev_time=jnp.asarray(-1.0, filter_dtype),
    )


def _run_frontend(
    state: VioState,
    img0: jnp.ndarray,
    img1: jnp.ndarray,
    time,
    imu: ImuBatch,
    fparams: FrontendParams,
    fcfg: FrontendConfig,
):
    """Shared frontend preamble of ``vio_step`` and ``vio_step_internals``:
    pyramids, per-frame mean gyro, frame dt, tracker step, FrameFeatures
    packing.  One implementation so the differential-debug path can never
    silently diverge from the live path."""
    fdtype = state.filt.P.dtype
    # The pyramid decimation GEMMs belong to the front-end precision scope
    # (frontend_step scopes its own body).
    with matmul_precision_scope(fcfg.matmul_precision):
        pyr0 = pyramids_for(img0, fcfg)
        pyr1 = pyramids_for(img1, fcfg)

    n_valid = jnp.maximum(jnp.sum(imu.valid), 1)
    mean_gyro = jnp.sum(
        jnp.where(imu.valid[:, None], imu.gyro, 0.0), axis=0
    ) / n_valid.astype(imu.gyro.dtype)

    is_first = state.prev_time < 0
    dt = jnp.where(is_first, jnp.zeros_like(state.prev_time), time - state.prev_time)

    # The filter's velocity estimate (world frame, at the previous frame's
    # state) rotated into cam0 enables the tracker's translation-aware
    # prediction — without it, translation-induced flow (fx*v*dt/Z) can
    # exceed the KLT search radius at close range / fast motion.
    cam_vel = None
    if fcfg.translation_seed:
        R_wi = jpl_to_rot(state.filt.imu.q)
        cam_vel = fparams.R_imu_cam0 @ (R_wi @ state.filt.imu.v).astype(img0.dtype)

    tracker, out = frontend_step(
        state.tracker,
        state.pyr0_prev,
        pyr0,
        pyr1,
        mean_gyro.astype(img0.dtype),
        dt.astype(img0.dtype),
        is_first,
        fparams,
        fcfg,
        cam_vel=cam_vel,
    )

    frame = FrameFeatures(
        time=jnp.asarray(time, fdtype),
        fid=out.fid,
        uv=out.uv.astype(fdtype),
        valid=out.valid,
        quality=out.quality.astype(fdtype),
    )
    return tracker, out, frame, pyr0


def vio_step(
    state: VioState,
    img0: jnp.ndarray,
    img1: jnp.ndarray,
    time,
    imu: ImuBatch,
    fparams: FrontendParams,
    mparams: MsckfParams,
    fcfg: FrontendConfig,
    mcfg: FilterConfig,
    method: str = "qr",
):
    """One stereo frame end-to-end (stereo_callback + backend_callback)."""
    fdtype = state.filt.P.dtype
    tracker, out, frame, pyr0 = _run_frontend(
        state, img0, img1, time, imu, fparams, fcfg
    )
    filt, pose = filter_step(state.filt, frame, imu, mparams, mcfg, method=method)

    new_state = VioState(
        tracker=tracker,
        filt=filt,
        pyr0_prev=pyr0,
        prev_time=jnp.asarray(time, fdtype),
    )
    return new_state, (pose, out)


def vio_step_internals(
    state: VioState,
    img0: jnp.ndarray,
    img1: jnp.ndarray,
    time,
    imu: ImuBatch,
    fparams: FrontendParams,
    mparams: MsckfParams,
    fcfg: FrontendConfig,
    mcfg: FilterConfig,
    method: str = "qr",
) -> dict:
    """Differential-debug view of one frame: runs the frontend exactly as
    ``vio_step`` would (same ``_run_frontend`` helper), then returns
    ``msckf.filter_internals`` — the update-phase tensors (Jacobian blocks,
    projected rows, gating scores) the filter would consume — without
    advancing any state.  The fixed-shape analog of the reference's frame-9
    Jacobian dump (msckf_vio.cpp:719-723); driven by
    ``apps/run_euroc.py --dump-filter-frame``."""
    from .msckf import filter_internals

    _, out, frame, _ = _run_frontend(state, img0, img1, time, imu, fparams, fcfg)
    internals = filter_internals(state.filt, frame, imu, mparams, mcfg, method=method)
    internals["frontend_fid"] = out.fid
    internals["frontend_uv"] = out.uv
    internals["frontend_valid"] = out.valid
    return internals


@partial(jax.jit, static_argnames=("fcfg", "mcfg", "method"))
def _vio_chunk(state, imgs0, imgs1, times, imu, fparams, mparams, fcfg, mcfg, method):
    def step(s, xs):
        i0, i1, t, b = xs
        return vio_step(s, i0, i1, t, b, fparams, mparams, fcfg, mcfg, method)

    return jax.lax.scan(step, state, (imgs0, imgs1, times, imu))


@dataclasses.dataclass
class VioResult:
    times: np.ndarray
    positions: np.ndarray
    quats_xyzw: np.ndarray
    pos_cov: np.ndarray  # (T, 3, 3) body-frame position covariance
    num_tracks: np.ndarray
    tracking: dict
    final_state: VioState
    # Published per-frame feature measurements (ids / normalized stereo uv /
    # validity) — the inputs the keyframe-BA refinement tier re-associates
    # into tracks (parallel/refine.py).
    fid: Optional[np.ndarray] = None  # (T, N) int32
    uv: Optional[np.ndarray] = None  # (T, N, 4)
    valid: Optional[np.ndarray] = None  # (T, N) bool
    # Filled only when run_vio_sequence(internals_at=N): the frame-N
    # differential-debug tensors from vio_step_internals.
    internals: Optional[dict] = None


def run_vio_sequence(
    fcfg: FrontendConfig,
    mcfg: FilterConfig,
    calib: StereoCalib,
    frame_t: np.ndarray,
    images0: np.ndarray,  # (T, H, W)
    images1: np.ndarray,
    imu_t: np.ndarray,
    imu_gyro: np.ndarray,
    imu_acc: np.ndarray,
    image_dtype=jnp.float32,
    filter_dtype=jnp.float64,
    method: str = "qr",
    chunk: Optional[int] = None,
    state: Optional[VioState] = None,
    internals_at: Optional[int] = None,
    prev_frame_t: Optional[float] = None,
) -> VioResult:
    """Host driver: chunked scan over the image sequence (the reference's
    per-image while loop, apps/run_euroc_single_thread.cpp:189-324).

    ``internals_at=N`` additionally captures the frame-N update-phase
    tensors (vio_step_internals) in ``result.internals`` — the analog of
    the reference's frame-9 Jacobian dump (msckf_vio.cpp:719-723).
    Cost note: a mid-chunk ``internals_at`` forces a chunk boundary there,
    splitting one chunk into two odd-length chunks — two extra
    ``_vio_chunk`` compilations (over a minute each on the GPU).  Pick N on
    an existing ``chunk`` multiple when compile time matters.

    When resuming with ``state`` from an earlier call, pass
    ``prev_frame_t`` = the last already-processed frame's timestamp so the
    IMU stream between the calls is packed (with host-exact dt) instead of
    dropped."""
    import dataclasses as _dc

    fcfg = _dc.replace(
        fcfg,
        distortion_model0=calib.cam0.distortion_model,
        distortion_model1=calib.cam1.distortion_model,
    )
    fparams = make_frontend_params(calib, image_dtype)
    mparams = make_params(mcfg, calib, filter_dtype)
    H, W = images0.shape[1:]
    if state is None:
        state = init_vio_state(fcfg, mcfg, calib, (H, W), image_dtype, filter_dtype)
        n0 = min(mcfg.imu_init_samples, imu_t.shape[0])
        state = state._replace(
            filt=apply_gravity_init(state.filt, imu_gyro[:n0], imu_acc[:n0])
        )

    batches = pack_imu_batches(
        imu_t, imu_gyro, imu_acc, frame_t, mcfg.max_imu_per_frame,
        prev_frame_t=prev_frame_t,
    )

    T = frame_t.shape[0]
    chunk = chunk or T
    poses, fronts = [], []
    internals = None
    bounds = list(range(0, T, chunk))
    if internals_at is not None and 0 <= internals_at < T:
        # Force a chunk boundary so the pre-frame state is available.
        bounds = sorted(set(bounds) | {internals_at})
    for j, s0 in enumerate(bounds):
        s1 = bounds[j + 1] if j + 1 < len(bounds) else T
        if internals_at is not None and s0 == internals_at:
            internals = jax.device_get(
                vio_step_internals(
                    state,
                    jnp.asarray(images0[s0], image_dtype),
                    jnp.asarray(images1[s0], image_dtype),
                    jnp.asarray(frame_t[s0], filter_dtype),
                    jax.tree.map(lambda x: jnp.asarray(x[s0]), batches),
                    fparams, mparams, fcfg, mcfg, method,
                )
            )
        state, (pose, front) = _vio_chunk(
            state,
            jnp.asarray(images0[s0:s1], image_dtype),
            jnp.asarray(images1[s0:s1], image_dtype),
            jnp.asarray(frame_t[s0:s1], filter_dtype),
            jax.tree.map(lambda x: x[s0:s1], batches),
            fparams,
            mparams,
            fcfg,
            mcfg,
            method,
        )
        poses.append(jax.device_get(pose))
        fronts.append(jax.device_get(front))

    def cat(objs, field):
        return np.concatenate([np.asarray(getattr(o, field)) for o in objs], axis=0)

    return VioResult(
        times=cat(poses, "time"),
        positions=cat(poses, "p"),
        quats_xyzw=cat(poses, "q_xyzw"),
        pos_cov=cat(poses, "p_cov"),
        num_tracks=cat(poses, "num_tracks"),
        tracking={
            "before_tracking": cat(fronts, "before_tracking"),
            "after_tracking": cat(fronts, "after_tracking"),
            "after_matching": cat(fronts, "after_matching"),
            "after_ransac": cat(fronts, "after_ransac"),
        },
        final_state=state,
        fid=cat(fronts, "fid"),
        uv=cat(fronts, "uv"),
        valid=cat(fronts, "valid"),
        internals=internals,
    )
