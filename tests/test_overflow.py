"""Deviation-knob overflow stress (PARITY.md deviations table).

Two measured deviations cap per-frame work with restore knobs:
  * FilterConfig.max_update_tracks (default 32): update candidates beyond
    the cap are dropped from the EKF update ONLY — their map entries leave
    exactly as if gated out.
  * FrontendConfig.cand_budget (default 48): new-feature candidates beyond
    the budget wait; short grids refill on the next frame.

Round-1 gap: no test created >cap simultaneous track deaths or >budget
worthy candidates, so the deferred-overflow semantics were unexercised."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig, FrontendConfig
from msckf_stereo_c.io import evaluate_ate
from msckf_stereo_c.models.frontend import (
    frontend_step,
    init_tracker_state,
    make_frontend_params,
    pyramids_for,
)
from msckf_stereo_c.models.runner import run_sequence
from msckf_stereo_c.sim import (
    make_circle_trajectory,
    make_landmarks,
    make_wall_landmarks,
    project_tracks,
    synthesize_imu,
)
from msckf_stereo_c.sim.render import render_stereo_sequence


def test_mass_track_death_update_cap():
    """A frame where every live track dies at once (3-frame blackout) puts
    ~40 candidates in front of an 8-slot update cap.  The overflow must be
    dropped from the update only: the map is still fully cleaned, the filter
    stays finite, and accuracy stays inside the gate with AND without the
    cap."""
    traj = make_circle_trajectory(duration=8.0)
    lms = make_landmarks(num=500, seed=1)
    imu = synthesize_imu(traj, gyro_noise=1e-4, acc_noise=1e-3, seed=0)
    feats = project_tracks(traj, lms, max_features=48, pixel_noise=0.3, seed=2)

    valid = feats.valid.copy()
    death_frame = 80
    # Number of tracks that will die simultaneously at the blackout.
    n_live = int(feats.valid[death_frame - 1].sum())
    assert n_live > 32, f"scenario too weak: only {n_live} live tracks"
    valid[death_frame : death_frame + 3] = False

    base = FilterConfig(max_cam_state_size=8, max_tracks=64, max_imu_per_frame=12)
    results = {}
    for cap in (8, 0):  # 8 = heavily over-subscribed cap; 0 = uncapped
        cfg = dataclasses.replace(base, max_update_tracks=cap)
        res = run_sequence(
            cfg, EUROC_CALIB, feats.t, feats.fid, feats.uv, valid,
            imu.t, imu.gyro, imu.acc, method="cholesky",
        )
        assert np.isfinite(res.positions).all()
        # Map hygiene: at the frame after the mass death no stale track from
        # before the blackout survives — overflow candidates left the map
        # even though only `cap` of them reached the EKF update.
        # (The run ended at T; check the final map only holds tracks started
        # after the blackout: their count is bounded by the slots seen since.)
        gt_idx = feats.frame_index
        ate = evaluate_ate(res.times, res.positions, traj.t[gt_idx], traj.p[gt_idx])
        assert ate.rmse < 0.13, f"cap={cap}: ATE {ate.rmse}"
        results[cap] = res

    # After the mass death both runs recover to a comparable live-track
    # population (the cap affects which updates land, never map occupancy;
    # exact equality does not hold — an 8-slot cap also binds during normal
    # churn in the prune phase).
    assert abs(
        int(results[8].num_tracks[-1]) - int(results[0].num_tracks[-1])
    ) <= 4


def test_mass_death_map_cleanup():
    """Direct map-hygiene probe: run up to the frame right after the mass
    death and assert every pre-blackout track left the map even with a tiny
    update cap."""
    traj = make_circle_trajectory(duration=6.0)
    lms = make_landmarks(num=500, seed=1)
    imu = synthesize_imu(traj, gyro_noise=1e-4, acc_noise=1e-3, seed=0)
    feats = project_tracks(traj, lms, max_features=48, pixel_noise=0.3, seed=2)

    death_frame = 60
    pre_fids = set(feats.fid[death_frame - 1][feats.valid[death_frame - 1]].tolist())
    assert len(pre_fids) > 32

    valid = feats.valid.copy()
    valid[death_frame:] = False  # permanent blackout; stop soon after

    cfg = FilterConfig(
        max_cam_state_size=8, max_tracks=64, max_imu_per_frame=12,
        max_update_tracks=4,
    )
    stop = death_frame + 2
    res = run_sequence(
        cfg, EUROC_CALIB, feats.t[:stop], feats.fid[:stop], feats.uv[:stop],
        valid[:stop], imu.t, imu.gyro, imu.acc, method="cholesky",
    )
    final_fids = np.asarray(res.final_state.tracks.fid)
    leftover = pre_fids.intersection(final_fids[final_fids >= 0].tolist())
    assert not leftover, f"stale tracks survived the capped mass death: {leftover}"


def test_candidate_budget_overflow_refill():
    """First frame demands 60 candidates (20 grids x grid_max 3...4) against
    a 48-slot budget; short grids must refill within the next frames and the
    steady-state population must match the unbudgeted run."""
    traj = make_circle_trajectory(duration=2.5)
    landmarks = make_wall_landmarks(num=900, radius=8.0, seed=3)
    frame_idx = np.arange(0, traj.t.shape[0], 10)[:5]
    img0, img1 = render_stereo_sequence(traj, landmarks, frame_idx, r_wall=8.0)
    img0 = jnp.asarray(img0, jnp.float32)
    img1 = jnp.asarray(img1, jnp.float32)
    times = jnp.asarray(traj.t[frame_idx], jnp.float32)

    params = make_frontend_params(EUROC_CALIB, jnp.float32)

    def run(cfg):
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
            (st, _, _), outs = jax.lax.scan(
                step, (state, jnp.float32(-1.0), init_pyr), (i0s, i1s, ts)
            )
            return st, outs

        return seq(state, img0, img1, times)

    base = FrontendConfig(max_features=96)
    _, out_cap = run(dataclasses.replace(base, cand_budget=48))
    _, out_un = run(dataclasses.replace(base, cand_budget=0))

    n_cap = np.asarray(out_cap.valid).sum(axis=1)
    n_un = np.asarray(out_un.valid).sum(axis=1)
    # The unbudgeted run seeds more features on frame 1 (budget binds).
    assert n_un[0] > n_cap[0], (n_un[0], n_cap[0])
    assert n_un[0] > 48  # >48 worthy candidates genuinely existed
    # Refill: by the 3rd frame the budgeted run catches up (within a couple
    # of features — per-frame stereo-match luck).
    assert n_cap[2] >= n_un[2] - 3, (n_cap[2], n_un[2])
    assert n_cap[-1] >= n_un[-1] - 3, (n_cap[-1], n_un[-1])
