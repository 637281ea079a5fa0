"""Template carry (FrontendConfig.tmpl_carry): the temporal KLT reusing the
merged stereo call's template patches must be BIT-IDENTICAL to re-extracting
them — same image, same positions, same interpolation code path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.config import EUROC_CALIB, FrontendConfig
from msckf_stereo_c.models.frontend import (
    FrameOutput,
    frontend_step,
    init_tracker_state,
    make_frontend_params,
    pyramids_for,
)
from msckf_stereo_c.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
from msckf_stereo_c.sim.render import render_stereo_sequence


def _run(cfg, img0, img1, times):
    params = make_frontend_params(EUROC_CALIB, jnp.float32)
    state = init_tracker_state(cfg, jnp.float32)

    @jax.jit
    def seq(state, i0s, i1s, ts):
        def step(carry, xs):
            st, prev_t, pyr_prev = carry
            i0, i1, t = xs
            pyr0 = pyramids_for(i0, cfg)
            pyr1 = pyramids_for(i1, cfg)
            is_first = prev_t < 0
            dt = jnp.where(is_first, 0.0, t - prev_t)
            st, out = frontend_step(
                st, pyr_prev, pyr0, pyr1, jnp.zeros(3, jnp.float32), dt,
                is_first, params, cfg,
            )
            return (st, t, pyr0), out

        init_pyr = jax.tree.map(jnp.zeros_like, pyramids_for(i0s[0], cfg))
        (st, _, _), outs = jax.lax.scan(step, (state, jnp.float32(-1.0), init_pyr), (i0s, i1s, ts))
        return st, outs

    return seq(state, img0, img1, times)


def test_tmpl_carry_bit_identical():
    traj = make_circle_trajectory(duration=2.5)
    landmarks = make_wall_landmarks(num=300, radius=8.0, seed=1)
    frame_idx = np.arange(0, traj.t.shape[0], 10)[:8]
    img0, img1 = render_stereo_sequence(traj, landmarks, frame_idx, r_wall=8.0)
    img0 = jnp.asarray(img0, jnp.float32)
    img1 = jnp.asarray(img1, jnp.float32)
    times = jnp.asarray(traj.t[frame_idx], jnp.float32)

    base = FrontendConfig(max_features=64, klt_impl="corr", temporal_levels=1, stereo_levels=1)
    st_on, out_on = _run(dataclasses.replace(base, tmpl_carry=True), img0, img1, times)
    st_off, out_off = _run(dataclasses.replace(base, tmpl_carry=False), img0, img1, times)

    assert int(np.asarray(out_on.after_ransac)[-1]) > 20  # tracking is live
    np.testing.assert_array_equal(np.asarray(out_on.fid), np.asarray(out_off.fid))
    np.testing.assert_array_equal(np.asarray(out_on.valid), np.asarray(out_off.valid))
    np.testing.assert_array_equal(np.asarray(out_on.uv), np.asarray(out_off.uv))
