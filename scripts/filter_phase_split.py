"""Per-phase cost of the filter step at the bench's true operating point.

Times the bench's exact scanned program (B sequences vmapped, frontend
stubbed like split_bench's "filter" mode) with the filter truncated after
successive phases; differences between consecutive rows isolate each phase.

FPS_BATCH / FPS_FRAMES env knobs."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig, FrontendConfig
from msckf_stereo_c.models.frontend import make_frontend_params, pyramids_for
from msckf_stereo_c.models.msckf import (
    FrameFeatures,
    _online_reset,
    _prune_cam_states,
    _publish,
    _remove_lost_features,
    make_params,
)
from msckf_stereo_c.models.augmentation import add_feature_observations, augment_state
from msckf_stereo_c.models.propagation import propagate
from msckf_stereo_c.models.runner import apply_gravity_init, pack_imu_batches
from msckf_stereo_c.models.vio import VioState, init_vio_state
from msckf_stereo_c.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
from msckf_stereo_c.sim.render import render_stereo_sequence

fcfg = FrontendConfig(temporal_levels=1)
mcfg = FilterConfig(ns_iters=int(os.environ.get("FPS_NS_ITERS", "10")))
dtype = jnp.float32
B = int(os.environ.get("FPS_BATCH", "16"))
n_frames = int(os.environ.get("FPS_FRAMES", "50"))

traj = make_circle_trajectory(duration=max(4.0, n_frames * 0.05 + 2.0))
landmarks = make_wall_landmarks(num=600, radius=8.0, seed=1)
imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
frame_idx = np.arange(0, traj.t.shape[0], 10)[:n_frames]
img0, img1 = render_stereo_sequence(traj, landmarks, frame_idx, r_wall=8.0)
frame_t = traj.t[frame_idx]

fparams = make_frontend_params(EUROC_CALIB, jnp.float32)
mparams = make_params(mcfg, EUROC_CALIB, dtype)
state0 = init_vio_state(fcfg, mcfg, EUROC_CALIB, img0.shape[1:], jnp.float32, dtype)
state0 = state0._replace(filt=apply_gravity_init(state0.filt, imu.gyro[:200], imu.acc[:200]))
batches = pack_imu_batches(imu.t, imu.gyro, imu.acc, frame_t, mcfg.max_imu_per_frame, np.float32)
d_img0 = jnp.asarray(img0, jnp.float32)
d_img1 = jnp.asarray(img1, jnp.float32)
d_t = jnp.asarray(frame_t, dtype)
d_b = jax.tree.map(jnp.asarray, batches)
states0 = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), state0)

PHASES = ("none", "prop", "aug", "lost", "prune", "full")


def filter_prefix(state, frame, imu_b, upto):
    with jax.default_matmul_precision("float32"):
        first = state.next_sid == 0
        state = state._replace(
            imu=state.imu._replace(time=jnp.where(first, frame.time, state.imu.time))
        )
        state = propagate(state, imu_b, mparams.Q_imu)
        if upto == "prop":
            return state
        state = augment_state(state, frame.time)
        state = add_feature_observations(state, frame.fid, frame.uv, frame.valid)
        if upto == "aug":
            return state
        state = _remove_lost_features(state, mparams, "schur", mcfg.max_update_tracks, mcfg.ns_iters)
        if upto == "lost":
            return state
        state = jax.lax.cond(
            state.num_cams >= mcfg.max_cam_state_size,
            lambda s: _prune_cam_states(s, mparams, "schur", mcfg.max_update_tracks, mcfg.ns_iters),
            lambda s: s,
            state,
        )
        if upto == "prune":
            return state
        _publish(state, frame.time, mparams)
        return _online_reset(state, mparams)


def vio_step_variant(state, img0a, img1a, t, imu_b, upto):
    fdtype = state.filt.P.dtype
    pyr0 = pyramids_for(img0a, fcfg)
    pyr1 = pyramids_for(img1a, fcfg)
    tracker = state.tracker
    N = tracker.fid.shape[0]
    out_fid = jnp.arange(N, dtype=jnp.int32)
    out_uv = jnp.tile(pyr0[0][:1, :4] * 1e-5, (N, 1)).astype(img0a.dtype)
    frame = FrameFeatures(
        time=jnp.asarray(t, fdtype), fid=out_fid, uv=out_uv.astype(fdtype),
        valid=jnp.ones((N,), bool),
    )
    filt = state.filt if upto == "none" else filter_prefix(state.filt, frame, imu_b, upto)
    new_state = VioState(
        tracker=tracker, filt=filt, pyr0_prev=pyr0, prev_time=jnp.asarray(t, fdtype)
    )
    return new_state, filt.imu.p


def make_run(upto):
    def seq_scan(state, i0s, i1s, ts, bs):
        def step(s, xs):
            i0, i1, t, b = xs
            return vio_step_variant(s, i0, i1, t, b, upto)

        return jax.lax.scan(step, state, (i0s, i1s, ts, bs))

    return jax.jit(jax.vmap(seq_scan, in_axes=(0, None, None, None, None)))


prev = None
for upto in PHASES:
    run = make_run(upto)
    t0 = time.time()
    st, res = run(states0, d_img0, d_img1, d_t, d_b)
    jax.block_until_ready(st.filt.P)
    compile_t = time.time() - t0
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        st, res = run(states0, d_img0, d_img1, d_t, d_b)
    jax.block_until_ready(st.filt.P)
    dt_ms = (time.time() - t0) / reps / n_frames * 1000
    delta = "" if prev is None else f"  (+{dt_ms - prev:6.2f} ms)"
    print(f"{upto:8s} {dt_ms:7.2f} ms/frame (B={B})  [compile {compile_t:.0f}s]{delta}", flush=True)
    prev = dt_ms
