"""Frontend stage split at the bench operating point (B sequences vmapped,
shared images): times the scanned frontend with individual stages disabled
to attribute cost.  Stages: temporal KLT, stereo KLT, candidate add (FAST +
cond stereo KLT), publish undistort.

Variants:
  full        - frontend_step as shipped
  noklt       - temporal KLT returns the IMU-warp guess directly
  nostereo    - stereo match returns carried disparity (no KLT, no gate)
  noadd       - _add_new_features skipped entirely
  nopub       - publish returns pixel coords (no undistort)
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import msckf_stereo_c.models.frontend as fe
from msckf_stereo_c.config import EUROC_CALIB, FrontendConfig
from msckf_stereo_c.models.frontend import init_tracker_state, make_frontend_params, pyramids_for
from msckf_stereo_c.ops.klt import KltResult
from msckf_stereo_c.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
from msckf_stereo_c.sim.render import render_stereo_sequence

# tmpl_carry off: the carry path calls optical_flow_lk_corr_l0 directly,
# which would bypass the _klt_fn/_stereo_match_merged monkeypatches and
# make the ablations misattribute cost (profile numbers are therefore for
# the carry-disabled pipeline; the carry saves ~one extract kernel/frame).
fcfg = FrontendConfig(temporal_levels=1, tmpl_carry=False)
B = int(os.environ.get("SPLIT_BATCH", "16"))
n_frames = int(os.environ.get("SPLIT_FRAMES", "50"))

traj = make_circle_trajectory(duration=max(4.0, n_frames * 0.05 + 2.0))
landmarks = make_wall_landmarks(num=600, radius=8.0, seed=1)
imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
frame_idx = np.arange(0, traj.t.shape[0], 10)[:n_frames]
img0, img1 = render_stereo_sequence(traj, landmarks, frame_idx, r_wall=8.0)
frame_t = traj.t[frame_idx].astype(np.float32)

fparams = make_frontend_params(EUROC_CALIB, jnp.float32)
d_img0 = jnp.asarray(img0, jnp.float32)
d_img1 = jnp.asarray(img1, jnp.float32)
d_t = jnp.asarray(frame_t)

_orig_klt_fn = fe._klt_fn
_orig_stereo = fe._stereo_match_merged
_orig_detect = fe._detect_candidates
_orig_alloc = fe._allocate_new_features
_orig_publish = fe._publish


def identity_klt(levels0, levels1, pts0, guess, valid, win, iters, eps):
    return KltResult(pts=guess, valid=valid)


def run_variant(name):
    fe._klt_fn = _orig_klt_fn
    fe._stereo_match_merged = _orig_stereo
    fe._detect_candidates = _orig_detect
    fe._allocate_new_features = _orig_alloc
    fe._publish = _orig_publish
    if name == "noklt":
        fe._klt_fn = lambda impl, norm="none": identity_klt
    elif name == "nostereo":
        fe._stereo_match_merged = (
            lambda pyr0, pyr1, pts_surv, surv_guess, surv_valid, cand_xy, cand_valid, params, cfg, shape, anchor_sp=None: (
                (pts_surv, surv_guess, surv_valid,
                 jnp.zeros(surv_valid.shape, pts_surv.dtype)),
                (cand_xy, cand_valid, jnp.zeros(cand_valid.shape, cand_xy.dtype)),
                (None, None),
                jnp.zeros((), jnp.int32),
                (None, None),
            )
        )
    elif name == "noadd":
        fe._detect_candidates = lambda pts0, pts_valid, img_top, cfg, shape: (
            jnp.zeros((cfg.num_grids * cfg.grid_max_feature_num, 2), jnp.float32),
            jnp.zeros((cfg.num_grids * cfg.grid_max_feature_num,), jnp.float32),
            jnp.zeros((cfg.num_grids * cfg.grid_max_feature_num,), bool),
        )
        fe._allocate_new_features = (
            lambda state, cand_xy, cand_score, cand_pts1, cand_ok, cfg, shape, fill_to, cand_tmpl=None: state
        )
    elif name == "nopub":
        fe._publish = lambda state, params, cfg, dtype: (
            state.fid,
            jnp.concatenate([state.pts0, state.pts1], axis=1).astype(dtype),
            state.fid >= 0,
        )

    def seq_scan(tstate, i0s, i1s, ts):
        def step(carry, xs):
            ts_, prev_t, pyr_prev = carry
            i0, i1, t = xs
            pyr0 = pyramids_for(i0, fcfg)
            pyr1 = pyramids_for(i1, fcfg)
            is_first = prev_t < 0
            dt = jnp.where(is_first, 0.0, t - prev_t)
            ts_, out = fe.frontend_step(
                ts_, pyr_prev, pyr0, pyr1, jnp.zeros(3, jnp.float32), dt,
                is_first, fparams, fcfg,
            )
            return (ts_, t, pyr0), out.after_ransac

        (ts_, _, _), counts = jax.lax.scan(
            step, (tstate, jnp.float32(-1.0), jax.tree.map(jnp.zeros_like, pyramids_for(i0s[0], fcfg))), (i0s, i1s, ts)
        )
        return ts_, counts

    run = jax.jit(jax.vmap(seq_scan, in_axes=(0, None, None, None)))
    t0 = init_tracker_state(fcfg, jnp.float32)
    bts = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), t0)
    t_start = time.time()
    st, counts = run(bts, d_img0, d_img1, d_t)
    jax.block_until_ready(counts)
    compile_t = time.time() - t_start
    reps = 3
    t_start = time.time()
    for _ in range(reps):
        st, counts = run(bts, d_img0, d_img1, d_t)
    jax.block_until_ready(counts)
    ms = (time.time() - t_start) / reps / n_frames * 1000
    print(
        f"{name:10s} {ms:7.2f} ms/frame  tracks@end={int(np.asarray(counts)[0,-1])}  [compile {compile_t:.0f}s]",
        flush=True,
    )


for v in ("full", "noklt", "nostereo", "noadd", "nopub"):
    run_variant(v)
