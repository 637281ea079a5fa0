"""Failure-recovery tier: the uncertainty watchdog (_online_reset,
reference onlineReset msckf_vio.cpp:1186-1236) and the manual reset
(reset_filter, reference resetCallback msckf_vio.cpp:243-304).

Round-1 gap: both paths existed as lax.cond branches / helpers but no test
ever executed them.

PROCESS ISOLATION: see tests/_isolation.py — the real tests run in a fresh
subprocess; in the parent suite they skip."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _isolation import isolate_module

_IN_CHILD, _child_only, test_recovery_module_in_subprocess = isolate_module(
    __file__, "MSCKF_RECOVERY_CHILD"
)

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig
from msckf_stereo_c.io import evaluate_ate
from msckf_stereo_c.models.msckf import (
    FrameFeatures,
    _online_reset,
    filter_step,
    init_state,
    make_params,
    reset_filter,
)
from msckf_stereo_c.models.propagation import ImuBatch
from msckf_stereo_c.models.runner import run_sequence
from msckf_stereo_c.models.state import initial_cov_diag
from msckf_stereo_c.sim import (
    make_circle_trajectory,
    make_landmarks,
    project_tracks,
    synthesize_imu,
)

CFG = FilterConfig(max_cam_state_size=6, max_tracks=48, max_imu_per_frame=12)


def _dirty_state(cfg=CFG, dtype=jnp.float64):
    """A state that has visibly drifted from init: active cams, live tracks,
    inflated covariance."""
    s = init_state(cfg, EUROC_CALIB, dtype)
    K, M = s.tracks.obs_valid.shape
    tracks = s.tracks._replace(
        fid=jnp.arange(K, dtype=jnp.int32),
        obs_valid=jnp.ones((K, M), bool),
        initialized=jnp.ones((K,), bool),
    )
    P = s.P + 0.5 * jnp.eye(s.P.shape[0], dtype=dtype)
    return s._replace(
        num_cams=jnp.asarray(3, jnp.int32),
        P=P,
        tracks=tracks,
        next_sid=jnp.asarray(7, jnp.int32),
        imu=s.imu._replace(p=jnp.asarray([1.0, 2.0, 3.0], dtype)),
    )


@_child_only
def test_online_reset_unit():
    """The watchdog branch itself: fires iff a position std exceeds the
    threshold (and the threshold is enabled)."""
    params = make_params(CFG, EUROC_CALIB, jnp.float64)
    s = _dirty_state()

    # Position stds sqrt(0.5) ~ 0.707 < 8.0 default threshold: no reset.
    kept = jax.jit(_online_reset)(s, params)
    assert int(kept.online_reset_count) == 0
    assert int(kept.num_cams) == 3

    # Same state against a 0.5 threshold: reset fires.
    params_low = params._replace(position_std_threshold=jnp.asarray(0.5, jnp.float64))
    r = jax.jit(_online_reset)(s, params_low)
    assert int(r.online_reset_count) == 1
    assert int(r.num_cams) == 0
    assert not bool(np.asarray(r.tracks.obs_valid).any())
    assert (np.asarray(r.tracks.fid) == -1).all()
    np.testing.assert_allclose(
        np.asarray(r.P), np.diag(initial_cov_diag(CFG, CFG.state_dim))
    )
    # IMU pose survives the reset (the reference keeps imu_state, wiping
    # only cams/features/covariance).
    np.testing.assert_allclose(np.asarray(r.imu.p), [1.0, 2.0, 3.0])

    # threshold <= 0 disables the watchdog entirely.
    params_off = params._replace(position_std_threshold=jnp.asarray(-1.0, jnp.float64))
    off = jax.jit(_online_reset)(s, params_off)
    assert int(off.online_reset_count) == 0


@_child_only
def test_online_reset_fires_and_recovers_end_to_end():
    """Feature blackout drives position covariance past the threshold; the
    watchdog must fire inside the scanned filter program and the filter must
    re-converge once features return (reference onlineReset is the automatic
    variant of resetCallback)."""
    traj = make_circle_trajectory(duration=10.0)
    lms = make_landmarks(num=400, seed=1)
    imu = synthesize_imu(traj, gyro_noise=1e-4, acc_noise=1e-3, seed=0)
    feats = project_tracks(traj, lms, max_features=40, pixel_noise=0.3, seed=2)

    # Blackout: no measurements for frames [60, 110) = 2.5 s.  With initial
    # velocity cov 0.25 the position std grows ~ 0.5 t ~ 1.25 m >> 0.6 m.
    # (0.6, not lower: right after a reset the covariance re-grows at the
    # same ~0.5 t rate until the first post-reset updates land ~0.3 s in,
    # and a marginal threshold would re-fire forever.)
    valid = feats.valid.copy()
    valid[60:110] = False

    cfg = dataclasses.replace(CFG, position_std_threshold=0.6)
    # chunk=50: one compiled 50-frame chunk program reused 4x.
    res = run_sequence(
        cfg, EUROC_CALIB, feats.t, feats.fid, feats.uv, valid,
        imu.t, imu.gyro, imu.acc, method="cholesky", chunk=50,
    )
    assert int(res.final_state.online_reset_count) >= 1
    assert np.isfinite(res.positions).all()
    # Window refilled after the blackout: tracking resumed.
    assert int(res.num_cams[-1]) >= cfg.max_cam_state_size - 2
    assert int(res.final_state.num_cams) > 0
    assert int(jnp.sum(res.final_state.tracks.fid >= 0)) > 10
    # Post-recovery trajectory is locally consistent: aligned ATE of the
    # tail segment stays bounded even though the global frame drifted
    # during the blackout.
    tail = slice(130, None)
    gt_idx = feats.frame_index[tail]
    ate = evaluate_ate(res.times[tail], res.positions[tail], traj.t[gt_idx], traj.p[gt_idx])
    assert ate.rmse < 0.15, f"post-reset tail ATE {ate.rmse}"

    # Control: same world without blackout never resets.
    res0 = run_sequence(
        cfg, EUROC_CALIB, feats.t, feats.fid, feats.uv, feats.valid,
        imu.t, imu.gyro, imu.acc, method="cholesky", chunk=50,
    )
    assert int(res0.final_state.online_reset_count) == 0


@_child_only
def test_reset_filter_manual():
    """reset_filter rebuilds the init state (keeping gravity) and the filter
    runs cleanly afterwards."""
    params = make_params(CFG, EUROC_CALIB, jnp.float64)
    s = _dirty_state()
    s = s._replace(gravity=jnp.asarray([0.01, -0.02, -9.79], jnp.float64))

    r = reset_filter(s, CFG, EUROC_CALIB)
    fresh = init_state(CFG, EUROC_CALIB, jnp.float64)
    np.testing.assert_allclose(np.asarray(r.gravity), [0.01, -0.02, -9.79])
    # Everything except gravity matches a fresh init.
    fresh_cmp = fresh._replace(gravity=r.gravity)
    for a, b in zip(jax.tree.leaves(r), jax.tree.leaves(fresh_cmp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # And the reset state is runnable.
    L = CFG.max_imu_per_frame
    imu = ImuBatch(
        time=jnp.linspace(0.01, 0.05, L),
        gyro=jnp.zeros((L, 3)),
        acc=jnp.asarray(np.tile([0.0, 0.0, 9.81], (L, 1))),
        valid=jnp.ones((L,), bool),
    )
    F = 8
    frame = FrameFeatures(
        time=jnp.asarray(0.05),
        fid=jnp.arange(F, dtype=jnp.int32),
        uv=jnp.zeros((F, 4)),
        valid=jnp.ones((F,), bool),
    )
    s2, pose = jax.jit(
        lambda s, f, b: filter_step(s, f, b, params, CFG, method="cholesky")
    )(r, frame, imu)
    assert np.isfinite(np.asarray(pose.p)).all()
    assert int(s2.num_cams) == 1
