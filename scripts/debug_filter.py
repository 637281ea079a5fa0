"""Step-by-step filter debugging on synthetic data (no scan, eager prints)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"
import jax

from msckf_stereo_c.device import select_platform, setup_compile_cache  # noqa: E402

select_platform("cpu")
setup_compile_cache()
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig
from msckf_stereo_c.models import (
    FrameFeatures,
    apply_gravity_init,
    init_filter_state,
    make_params,
    pack_imu_batches,
)
from msckf_stereo_c.models.augmentation import add_feature_observations, augment_state
from msckf_stereo_c.models.msckf import _remove_lost_features, _prune_cam_states
from msckf_stereo_c.models.propagation import propagate
from msckf_stereo_c.models.triangulation import triangulate_tracks
from msckf_stereo_c.models.update import gating_scores, track_jacobians
from msckf_stereo_c.sim import (
    make_circle_trajectory,
    make_landmarks,
    project_tracks,
    synthesize_imu,
)

cfg = FilterConfig(max_cam_state_size=8, max_tracks=48, max_imu_per_frame=12)
traj = make_circle_trajectory(duration=6.0)
landmarks = make_landmarks(num=300)
imu = synthesize_imu(traj, gyro_noise=1e-6, acc_noise=1e-6, seed=0)
feats = project_tracks(traj, landmarks, max_features=32, pixel_noise=0.0)

params = make_params(cfg, EUROC_CALIB, jnp.float64)
state = init_filter_state(cfg, EUROC_CALIB, jnp.float64)
state = apply_gravity_init(state, imu.gyro[:200], imu.acc[:200])
batches = pack_imu_batches(imu.t, imu.gyro, imu.acc, feats.t, cfg.max_imu_per_frame)

T = len(feats.t)
for k in range(min(T, 40)):
    frame = FrameFeatures(
        time=jnp.asarray(feats.t[k]),
        fid=jnp.asarray(feats.fid[k], jnp.int32),
        uv=jnp.asarray(feats.uv[k]),
        valid=jnp.asarray(feats.valid[k]),
    )
    batch = jax.tree.map(lambda x: x[k], batches)

    first = state.next_sid == 0
    state = state._replace(
        imu=state.imu._replace(time=jnp.where(first, frame.time, state.imu.time))
    )
    state = propagate(state, batch, params.Q_imu)
    state = augment_state(state, frame.time)
    state = add_feature_observations(state, frame.fid, frame.uv, frame.valid)

    active = state.tracks.fid >= 0
    n_active = int(jnp.sum(active))
    newest = state.num_cams - 1
    observed_now = state.tracks.obs_valid[:, newest]
    lost = active & ~observed_now
    n_obs = jnp.sum(state.tracks.obs_valid, axis=1)
    cand = lost & (n_obs >= 3)

    if int(jnp.sum(cand)) > 0:
        tri = triangulate_tracks(
            state.tracks.obs, state.tracks.obs_valid, state.cams.q, state.cams.p,
            params.R_c0_c1, params.t_c0_c1,
        )
        ok = np.asarray(tri.valid & cand)
        cidx = np.flatnonzero(np.asarray(cand))
        for ci in cidx[:3]:
            lm = int(state.tracks.fid[ci])
            print(
                f"  tri track slot {ci} lm {lm}: pos={np.asarray(tri.pos_w[ci]).round(3)}"
                f" true={landmarks[lm].round(3)} valid={bool(tri.valid[ci])}"
                f" nobs={int(n_obs[ci])}"
            )
        jacs = track_jacobians(
            tri.pos_w, state.tracks.obs, state.tracks.obs_valid & cand[:, None],
            state.cams, state.gravity, params.R_c0_c1, params.t_c0_c1,
        )
        gamma = gating_scores(jacs, state.P, params.sigma2)
        dof = jnp.clip(n_obs - 1, 1, 99)
        thr = params.chi2_table[dof]
        print(
            "  gating gamma:", np.asarray(gamma)[cidx[:5]].round(2),
            "thr:", np.asarray(thr)[cidx[:5]].round(2),
        )

    state = _remove_lost_features(state, params, "qr")
    state = jax.lax.cond(
        state.num_cams >= cfg.max_cam_state_size,
        lambda s: _prune_cam_states(s, params, "qr"),
        lambda s: s,
        state,
    )
    gt = traj.p[feats.frame_index[k]]
    est = np.asarray(state.imu.p)
    print(
        f"frame {k}: cams={int(state.num_cams)} active={n_active} lost={int(jnp.sum(lost))}"
        f" cand={int(jnp.sum(cand))} est={est.round(3)} gt={gt.round(3)}"
        f" err={np.linalg.norm(est - gt):.4f}"
    )
