"""Where does the bench frame time go?  Times the bench's exact scanned
program (B sequences vmapped, images shared) in three variants: full,
frontend-only (filter stubbed), filter-only (frontend stubbed) — the
difference isolates each half at the true operating point.

SPLIT_KLT=corr|gemm, SPLIT_BATCH, SPLIT_FRAMES env knobs."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig, FrontendConfig
from msckf_stereo_c.models.frontend import frontend_step, make_frontend_params, pyramids_for
from msckf_stereo_c.models.msckf import FrameFeatures, filter_step, make_params
from msckf_stereo_c.models.runner import apply_gravity_init, pack_imu_batches
from msckf_stereo_c.models.vio import VioState, init_vio_state
from msckf_stereo_c.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
from msckf_stereo_c.sim.render import render_stereo_sequence

fcfg = FrontendConfig(
    temporal_levels=2, klt_impl=os.environ.get("SPLIT_KLT", FrontendConfig.klt_impl)
)
mcfg = FilterConfig()
dtype = jnp.float32
B = int(os.environ.get("SPLIT_BATCH", "16"))
n_frames = int(os.environ.get("SPLIT_FRAMES", "50"))

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


def vio_step_variant(state, img0, img1, t, imu_b, mode):
    fdtype = state.filt.P.dtype
    pyr0 = pyramids_for(img0, fcfg)
    pyr1 = pyramids_for(img1, fcfg)
    n_valid = jnp.maximum(jnp.sum(imu_b.valid), 1)
    mean_gyro = jnp.sum(jnp.where(imu_b.valid[:, None], imu_b.gyro, 0.0), axis=0) / n_valid.astype(imu_b.gyro.dtype)
    is_first = state.prev_time < 0
    dt = jnp.where(is_first, jnp.zeros_like(state.prev_time), t - state.prev_time)

    if mode in ("full", "frontend"):
        tracker, out = frontend_step(
            state.tracker, state.pyr0_prev, pyr0, pyr1,
            mean_gyro.astype(img0.dtype), dt.astype(img0.dtype), is_first, fparams, fcfg,
        )
    else:  # filter-only: fabricated measurements that still depend on inputs
        tracker = state.tracker
        N = tracker.fid.shape[0]
        out_fid = jnp.arange(N, dtype=jnp.int32)
        out_uv = jnp.tile(pyr0[0][:1, :4] * 1e-5, (N, 1)).astype(img0.dtype)
        out = (out_fid, out_uv, jnp.ones((N,), bool))

    if mode in ("full", "filter"):
        if mode == "full":
            fid, uv, valid = out.fid, out.uv, out.valid
        else:
            fid, uv, valid = out
        frame = FrameFeatures(
            time=jnp.asarray(t, fdtype), fid=fid, uv=uv.astype(fdtype), valid=valid
        )
        filt, pose = filter_step(state.filt, frame, imu_b, mparams, mcfg, method="schur")
        result = pose.p
    else:
        filt = state.filt
        result = out.uv[:1, :3] if mode == "frontend" else None

    new_state = VioState(
        tracker=tracker, filt=filt, pyr0_prev=pyr0, prev_time=jnp.asarray(t, fdtype)
    )
    return new_state, result


def make_run(mode):
    def seq_scan(state, i0s, i1s, ts, bs):
        def step(s, xs):
            i0, i1, t, b = xs
            return vio_step_variant(s, i0, i1, t, b, mode)

        return jax.lax.scan(step, state, (i0s, i1s, ts, bs))

    return jax.jit(jax.vmap(seq_scan, in_axes=(0, None, None, None, None)))


for mode in ("full", "frontend", "filter"):
    run = make_run(mode)
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
    print(f"{mode:10s} {dt_ms:7.2f} ms/frame (B={B})  [compile {compile_t:.0f}s]", flush=True)
