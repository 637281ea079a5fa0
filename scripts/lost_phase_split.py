"""Sub-split of the _remove_lost_features phase (the dominant filter cost):
motion-check / triangulation / jacobian-blocks / gating / EKF-update, each
timed cumulatively inside the bench's scanned program (frontend stubbed).

LPS_BATCH / LPS_FRAMES env knobs."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig, FrontendConfig
from msckf_stereo_c.models.frontend import make_frontend_params, pyramids_for
from msckf_stereo_c.models.msckf import FrameFeatures, make_params
from msckf_stereo_c.models.augmentation import add_feature_observations, augment_state
from msckf_stereo_c.models.propagation import propagate
from msckf_stereo_c.models.runner import apply_gravity_init, pack_imu_batches
from msckf_stereo_c.models.triangulation import check_motion_tracks, triangulate_tracks
from msckf_stereo_c.models.update import (
    measurement_update_schur,
    schur_gating,
    track_blocks,
)
from msckf_stereo_c.models.vio import VioState, init_vio_state
from msckf_stereo_c.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
from msckf_stereo_c.sim.render import render_stereo_sequence

fcfg = FrontendConfig(temporal_levels=1)
mcfg = FilterConfig(ns_iters=int(os.environ.get("FPS_NS_ITERS", "10")))
dtype = jnp.float32
B = int(os.environ.get("LPS_BATCH", "16"))
n_frames = int(os.environ.get("LPS_FRAMES", "50"))

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

PHASES = ("aug", "mot", "tri", "blk", "gate", "upd")


def dep(state, x):
    """Fold x into the carried state so XLA cannot DCE it."""
    f = state.filt
    return state._replace(
        filt=f._replace(imu=f.imu._replace(p=f.imu.p + jnp.sum(x) * 1e-30))
    )


def lost_prefix(state, params, upto):
    tracks = state.tracks
    active = tracks.fid >= 0
    newest = state.num_cams - 1
    observed_now = tracks.obs_valid[:, jnp.maximum(newest, 0)] & (state.num_cams > 0)
    lost = active & ~observed_now
    n_obs = jnp.sum(tracks.obs_valid, axis=1)
    candidates = lost & (n_obs >= 3)

    # Mirrors the shipped order: compact to max_update_tracks slots BEFORE
    # the motion check / triangulation (msckf._compact_candidates).
    from msckf_stereo_c.models.msckf import _compact_candidates

    idx = _compact_candidates(candidates, mcfg.max_update_tracks)
    obs = tracks.obs[idx]
    obs_valid = tracks.obs_valid[idx]
    initialized = tracks.initialized[idx]

    motion_ok = check_motion_tracks(
        obs, obs_valid, state.cams.q, state.cams.p,
        params.feature_translation_threshold,
    )
    if upto == "mot":
        return state, motion_ok.astype(state.P.dtype)
    tri = triangulate_tracks(
        obs, obs_valid, state.cams.q, state.cams.p,
        params.R_c0_c1, params.t_c0_c1,
    )
    init_ok = jnp.where(initialized, True, motion_ok & tri.valid)
    pos = jnp.where(initialized[:, None], tracks.pos[idx], tri.pos_w)
    if upto == "tri":
        return state, pos

    use = candidates[idx] & init_ok
    dof = jnp.clip(n_obs[idx] - 1, 1, 99)
    obs_mask = obs_valid & use[:, None]

    blocks = track_blocks(
        pos, obs, obs_mask, state.cams, state.gravity,
        params.R_c0_c1, params.t_c0_c1,
    )
    if upto == "blk":
        return state, blocks.H_x
    gamma = schur_gating(blocks, state.P, params.sigma2, mcfg.ns_iters)
    if upto == "gate":
        return state, gamma
    use = use & (gamma < params.chi2_table[dof])
    return measurement_update_schur(state, blocks, use, params.sigma2, mcfg.ns_iters), jnp.zeros((), state.P.dtype)


def vio_step_variant(state, img0a, img1a, t, imu_b, upto):
    fdtype = state.filt.P.dtype
    pyr0 = pyramids_for(img0a, fcfg)
    pyr1 = pyramids_for(img1a, fcfg)
    tracker = state.tracker
    N = tracker.fid.shape[0]
    frame = FrameFeatures(
        time=jnp.asarray(t, fdtype),
        fid=jnp.arange(N, dtype=jnp.int32),
        uv=jnp.tile(pyr0[0][:1, :4] * 1e-5, (N, 1)).astype(fdtype),
        valid=jnp.ones((N,), bool),
    )
    with jax.default_matmul_precision("float32"):
        filt = state.filt
        first = filt.next_sid == 0
        filt = filt._replace(imu=filt.imu._replace(time=jnp.where(first, frame.time, filt.imu.time)))
        filt = propagate(filt, imu_b, mparams.Q_imu)
        filt = augment_state(filt, frame.time)
        filt = add_feature_observations(filt, frame.fid, frame.uv, frame.valid)
        if upto != "aug":
            filt, x = lost_prefix(filt, mparams, upto)
            filt = filt._replace(imu=filt.imu._replace(p=filt.imu.p + jnp.sum(x) * 1e-30))
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
