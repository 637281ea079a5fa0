"""Translation-aware temporal prediction (FrontendConfig.translation_seed).

The reference's rotation-only warp (predictFeatureTracking,
image_processor.cpp:321-350) leaves translation-induced optical flow
(fx*v*dt/Z) entirely to the KLT search, which the 4-level pyramid absorbs;
this engine's IMU-seeded single-level tracker must PREDICT it instead —
round 3 measured 0.59 m ATE / 9% scale error on the stress/wall-8 scene
without it.  This test drives a fast lateral translation past a close wall
(~14 px/frame translation flow, beyond the single-level search radius) and
asserts the velocity-seeded tracker holds where rotation-only collapses.
"""
import dataclasses

from _isolation import isolate_module

import jax.numpy as jnp
import numpy as np
import pytest

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig, FrontendConfig
from msckf_stereo_c.io import evaluate_ate
from msckf_stereo_c.models.vio import run_vio_sequence
from msckf_stereo_c.sim.render_jax import JaxRenderer, StressEvents
from msckf_stereo_c.sim.trajectory import (
    GRAVITY,
    SimTrajectory,
    _compose_rotations,
    make_wall_landmarks,
    synthesize_imu,
)


_IN_CHILD, _child_only, test_translation_seed_module_in_subprocess = isolate_module(
    __file__, "MSCKF_TRSEED_CHILD"
)


def make_lateral_trajectory(
    duration=4.0, speed=2.5, x0=4.0, imu_rate=200.0, t_static=1.5, t_ramp=0.5
):
    """Straight lateral dolly: constant attitude (camera looking at the wall
    along world +x), speed ramping to ``speed`` along world y — maximal
    translation flow with zero rotation flow."""
    n = int(duration * imu_rate) + 1
    t = np.arange(n) / imu_rate
    u = np.maximum(t - t_static, 0.0)
    s = (t >= t_static).astype(float)
    ex = np.exp(-u / t_ramp)
    dy = speed * (1.0 - ex)
    y = speed * (u + t_ramp * (ex - 1.0)) - 0.5 * duration * speed * 0.5
    ddy = s * speed * ex / t_ramp
    p = np.stack([np.full(n, x0), y, np.zeros(n)], axis=1)
    v = np.stack([np.zeros(n), dy, np.zeros(n)], axis=1)
    a_w = np.stack([np.zeros(n), ddy, np.zeros(n)], axis=1)
    R_w_b = _compose_rotations(np.zeros(n), np.zeros(n), np.zeros(n))
    g_w = np.array([0.0, 0.0, -GRAVITY])
    acc = np.einsum("nij,nj->ni", R_w_b, a_w - g_w)
    return SimTrajectory(t=t, p=p, v=v, R_w_b=R_w_b, gyro=np.zeros((n, 3)), acc=acc)


@pytest.fixture(scope="module")
def lateral_scene():
    traj = make_lateral_trajectory()
    lms = make_wall_landmarks(num=500, radius=8.0, z_min=-3.0, z_max=3.0, seed=1)
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    idx = np.arange(0, traj.t.shape[0], 10)
    renderer = JaxRenderer(lms, EUROC_CALIB, r_wall=8.0)
    img0, img1 = renderer.render_sequence(traj, idx, StressEvents.nominal(len(idx)))
    return traj, imu, idx, img0, img1


def _run(lateral_scene, translation_seed: bool):
    traj, imu, idx, img0, img1 = lateral_scene
    fcfg = FrontendConfig(translation_seed=translation_seed)
    mcfg = FilterConfig(ns_iters=10)
    res = run_vio_sequence(
        fcfg, mcfg, EUROC_CALIB,
        traj.t[idx], img0, img1, imu.t, imu.gyro, imu.acc,
        filter_dtype=jnp.float32, method="schur", chunk=len(idx),
    )
    ate = evaluate_ate(res.times, res.positions, traj.t[idx], traj.p[idx])
    # Steady-state tracking (skip the static-init frames).
    tracks = int(res.tracking["after_tracking"][35:].min())
    return float(ate.rmse), tracks


@_child_only
def test_translation_seed_survives_fast_lateral_motion(lateral_scene):
    ate_on, tracks_on = _run(lateral_scene, True)
    assert ate_on < 0.06, f"seeded lateral ATE {ate_on:.4f} m"
    assert tracks_on > 25, tracks_on


@_child_only
def test_rotation_only_prediction_collapses_without_seed(lateral_scene):
    """Documents WHY the seed exists: the same scene with the reference's
    rotation-only warp loses most temporal tracks and degrades badly."""
    ate_on, tracks_on = _run(lateral_scene, True)
    ate_off, tracks_off = _run(lateral_scene, False)
    assert ate_off > 3.0 * ate_on or tracks_on > 1.5 * tracks_off, (
        ate_on, ate_off, tracks_on, tracks_off
    )
