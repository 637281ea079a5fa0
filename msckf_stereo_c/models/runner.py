"""Host-side sequence runner: packs per-frame IMU batches, initializes
gravity/bias, and drives the jitted filter over a whole sequence with
``lax.scan`` (optionally chunked).

Replaces the reference's EuRoC driver loop (apps/run_euroc_single_thread.cpp:
189-324) — but where the reference interleaves callbacks frame by frame on
the host, here the whole sequence (or a chunk of it) is one device program.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FilterConfig, StereoCalib
from .msckf import FrameFeatures, MsckfParams, PoseOutput, filter_step, make_params
from .propagation import ImuBatch, initialize_gravity_bias
from .state import FilterState, init_filter_state


def pack_imu_batches(
    imu_t: np.ndarray,
    imu_gyro: np.ndarray,
    imu_acc: np.ndarray,
    frame_t: np.ndarray,
    max_per_frame: int,
    dtype=np.float64,
    prev_frame_t: Optional[float] = None,
) -> ImuBatch:
    """Slice the IMU stream into per-frame fixed-size batches.

    Frame k gets samples with t in (frame_{k-1}, frame_k].  For the leading
    frame the boundary is ``prev_frame_t`` (the previous chunk's last frame
    when resuming a chunked run) — or, when None (a fresh sequence), the
    frame's own timestamp: the filter's first step pins its clock to the
    first image (msckf_vio.cpp:314-317), so pre-first-image samples are
    no-ops and are not packed at all.  Valid samples are packed FIRST in
    each batch (required by the propagation's masked-step semantics).

    Also emits host-exact float64 per-sample deltas (``ImuBatch.dt``,
    chained across frames and across the capped-overflow gap) so device
    propagation never subtracts near-equal absolute times — the f32 device
    path would otherwise lose ~1e-5 s per step at EuRoC-length timestamps
    (see ImuBatch)."""
    T = frame_t.shape[0]
    L = max_per_frame
    out_t = np.zeros((T, L), dtype)
    out_g = np.zeros((T, L, 3), dtype)
    out_a = np.zeros((T, L, 3), dtype)
    out_v = np.zeros((T, L), bool)
    out_dt = np.zeros((T, L), dtype)

    if prev_frame_t is None:
        # Unknown starting clock (fresh sequence OR a resume without the
        # boundary timestamp): frame 0 keeps the old semantics — it packs
        # everything up to its own timestamp and its dt slots carry the
        # sentinel -1 ("derive t - state.time on device"), as does the
        # first consumed slot after it.  From then on the chain is
        # deterministic (state time = last consumed sample) and exact.
        first_bound = -np.inf
        t_carry = None  # chain not anchored yet
    else:
        first_bound = prev_frame_t
        # The resumed filter clock = last sample consumed by the previous
        # chunk (propagation advances to the last sample <= frame time).
        j = int(np.searchsorted(imu_t, prev_frame_t, side="right"))
        t_carry = float(imu_t[j - 1]) if j > 0 else float(prev_frame_t)
    lo = np.searchsorted(imu_t, np.concatenate([[first_bound], frame_t[:-1]]), side="right")
    hi = np.searchsorted(imu_t, frame_t, side="right")
    for k in range(T):
        a, b = lo[k], hi[k]
        m = min(b - a, L)
        if b - a > L:
            # Cap: keep the most recent samples (the first kept sample's dt
            # spans the dropped-samples gap).
            a = b - L
        out_t[k, :m] = imu_t[a : a + m]
        out_g[k, :m] = imu_gyro[a : a + m]
        out_a[k, :m] = imu_acc[a : a + m]
        out_v[k, :m] = True
        if m == 0:
            continue
        tt = np.asarray(imu_t[a : a + m], np.float64)
        if k == 0 and prev_frame_t is None:
            out_dt[k, :m] = -1.0  # whole row: device derives vs state time
        elif t_carry is None:
            out_dt[k, 0] = -1.0  # first consumed slot after the blind row
            out_dt[k, 1:m] = np.diff(tt)
            t_carry = float(tt[-1])
        else:
            out_dt[k, :m] = np.diff(np.concatenate([[t_carry], tt]))
            t_carry = float(tt[-1])
    return ImuBatch(
        time=jnp.asarray(out_t),
        gyro=jnp.asarray(out_g),
        acc=jnp.asarray(out_a),
        valid=jnp.asarray(out_v),
        dt=jnp.asarray(out_dt),
    )


def apply_gravity_init(state: FilterState, gyro_window, acc_window) -> FilterState:
    """Set q0/bias/gravity from a static IMU window
    (reference initializeGravityAndBias, msckf_vio.cpp:209-241).

    jitted: eager per-primitive dispatch costs seconds apiece through this
    environment's remote compile helper."""

    @jax.jit
    def _init(state, gyro, acc):
        q0, bg, gravity = initialize_gravity_bias(gyro, acc)
        imu = state.imu._replace(q=q0, bg=bg, q_null=q0)
        return state._replace(imu=imu, gravity=gravity)

    return _init(
        state,
        jnp.asarray(gyro_window, state.P.dtype),
        jnp.asarray(acc_window, state.P.dtype),
    )


@dataclasses.dataclass
class SequenceResult:
    times: np.ndarray  # (T,)
    positions: np.ndarray  # (T, 3)
    quats_xyzw: np.ndarray  # (T, 4) Hamilton body->world
    num_cams: np.ndarray
    num_tracks: np.ndarray
    final_state: FilterState


@partial(jax.jit, static_argnames=("cfg", "method"))
def _run_chunk(state, frames: FrameFeatures, imu: ImuBatch, params: MsckfParams, cfg, method):
    def step(s, xs):
        frame, batch = xs
        return filter_step(s, frame, batch, params, cfg, method=method)

    return jax.lax.scan(step, state, (frames, imu))


def run_sequence(
    cfg: FilterConfig,
    calib: StereoCalib,
    frame_t: np.ndarray,
    fid: np.ndarray,  # (T, F)
    uv: np.ndarray,  # (T, F, 4)
    valid: np.ndarray,  # (T, F)
    imu_t: np.ndarray,
    imu_gyro: np.ndarray,
    imu_acc: np.ndarray,
    dtype=jnp.float64,
    method: str = "qr",
    chunk: Optional[int] = None,
    state: Optional[FilterState] = None,
    quality: Optional[np.ndarray] = None,  # (T, F) tracking-SNR proxy
) -> SequenceResult:
    """Run the back-end over a full sequence of frontend feature frames."""
    params = make_params(cfg, calib, dtype)
    if state is None:
        state = init_filter_state(cfg, calib, dtype)
        # Gravity/bias init from the first imu_init_samples (the reference
        # waits for 200 samples before processing frames).
        n0 = min(cfg.imu_init_samples, imu_t.shape[0])
        state = apply_gravity_init(state, imu_gyro[:n0], imu_acc[:n0])

    batches = pack_imu_batches(imu_t, imu_gyro, imu_acc, frame_t, cfg.max_imu_per_frame)
    frames = FrameFeatures(
        time=jnp.asarray(frame_t, dtype),
        fid=jnp.asarray(fid, jnp.int32),
        uv=jnp.asarray(uv, dtype),
        valid=jnp.asarray(valid),
        quality=None if quality is None else jnp.asarray(quality, dtype),
    )

    T = frame_t.shape[0]
    chunk = chunk or T
    outs = []
    for s0 in range(0, T, chunk):
        s1 = min(s0 + chunk, T)
        sl = lambda x: x[s0:s1]
        state, out = _run_chunk(
            state,
            jax.tree.map(sl, frames),
            jax.tree.map(sl, batches),
            params,
            cfg,
            method,
        )
        outs.append(jax.device_get(out))

    def cat(field):
        return np.concatenate([np.asarray(getattr(o, field)) for o in outs], axis=0)

    return SequenceResult(
        times=cat("time"),
        positions=cat("p"),
        quats_xyzw=cat("q_xyzw"),
        num_cams=cat("num_cams"),
        num_tracks=cat("num_tracks"),
        final_state=state,
    )
