"""SNR-adaptive observation noise (FilterConfig.noise_adaptive).

The reference's observation noise is one static scalar
(/root/reference/msckf_core/src/msckf_vio.cpp:44); here each track's noise
variance inflates by clip(ref / mean_quality, 1, cap) where quality is the
frontend-published template min-eig — implemented as sqrt-weight scaling of
the per-track Jacobian blocks (exactly per-track R = c*I, see
models/msckf.py:_gate_and_update).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig
from msckf_stereo_c.io import evaluate_ate
from msckf_stereo_c.models import run_sequence
from msckf_stereo_c.models.msckf import _snr_weights
from msckf_stereo_c.sim import (
    make_circle_trajectory,
    make_landmarks,
    project_tracks,
    synthesize_imu,
)

CFG = FilterConfig(max_cam_state_size=8, max_tracks=48, max_imu_per_frame=12)


def test_snr_weights_math():
    cfg = dataclasses.replace(
        CFG, noise_adaptive=True, noise_snr_ref=40.0, noise_inflation_cap=16.0
    )
    quality = jnp.asarray(
        [
            [80.0, 80.0, 0.0],   # strong texture -> no inflation
            [10.0, 10.0, 10.0],  # weak -> inflation 4
            [0.0, 0.0, 0.0],     # unknown -> neutral
            [1e-3, 1e-3, 0.0],   # ~zero -> capped at 16
        ]
    )
    mask = jnp.asarray(
        [[True, True, False], [True, True, True], [True, True, True], [True, True, False]]
    )
    w = np.asarray(_snr_weights(quality, mask, cfg))
    np.testing.assert_allclose(w, [1.0, 0.25, 1.0, 1.0 / 16.0], rtol=1e-6)


def _world(seed=0):
    traj = make_circle_trajectory(duration=8.0)
    landmarks = make_landmarks(num=300)
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=seed)
    feats = project_tracks(traj, landmarks, max_features=32, pixel_noise=0.2)
    return traj, imu, feats


@pytest.mark.parametrize("method", ["qr", "schur"])
def test_strong_texture_is_noop(method):
    """With every published quality at/above the reference the weights are
    exactly 1 — the adaptive path must reproduce the static-noise filter
    (both linear algebras; tolerance covers XLA refusing/reassociating the
    recompiled program with the extra *1.0 multiplies — measured 3e-12)."""
    traj, imu, feats = _world()
    quality = np.full(feats.fid.shape, 100.0)
    base = run_sequence(
        CFG, EUROC_CALIB, feats.t, feats.fid, feats.uv, feats.valid,
        imu.t, imu.gyro, imu.acc, method=method,
    )
    cfg_a = dataclasses.replace(CFG, noise_adaptive=True, noise_snr_ref=40.0)
    ada = run_sequence(
        cfg_a, EUROC_CALIB, feats.t, feats.fid, feats.uv, feats.valid,
        imu.t, imu.gyro, imu.acc, method=method, quality=quality,
    )
    np.testing.assert_allclose(base.positions, ada.positions, atol=1e-8)


def test_downweights_corrupted_tracks():
    """Corrupt a subset of tracks with a large constant measurement bias
    (the persistent wrong-lock/low-SNR failure mode) and mark exactly those
    tracks weak: the adaptive filter must beat the static filter on the
    same data."""
    traj, imu, feats = _world(seed=2)
    rng = np.random.default_rng(5)
    uv = np.array(feats.uv)
    T, F, _ = uv.shape
    bad = rng.random(F) < 0.3
    # Constant normalized-coordinate bias per bad track (~9 px at EuRoC
    # focal length) — chi2 gating alone does not reliably kill a
    # CONSISTENT bias because the triangulation absorbs most of it.
    bias = rng.normal(0.0, 0.02, (F, 4)) * bad[:, None]
    uv = uv + bias[None, :, :]
    quality = np.where(bad[None, :], 2.0, 100.0) * np.ones((T, 1))

    static = run_sequence(
        CFG, EUROC_CALIB, feats.t, feats.fid, uv, feats.valid,
        imu.t, imu.gyro, imu.acc, method="schur",
    )
    cfg_a = dataclasses.replace(
        CFG, noise_adaptive=True, noise_snr_ref=40.0, noise_inflation_cap=16.0
    )
    ada = run_sequence(
        cfg_a, EUROC_CALIB, feats.t, feats.fid, uv, feats.valid,
        imu.t, imu.gyro, imu.acc, method="schur", quality=quality,
    )
    gt = traj.p[feats.frame_index]
    ate_s = evaluate_ate(static.times, static.positions, feats.t, gt).rmse
    ate_a = evaluate_ate(ada.times, ada.positions, feats.t, gt).rmse
    # Downweighting must measurably beat the static filter on the same
    # (heavily corrupted: ~9 px consistent bias on 30% of tracks) data.
    assert ate_a < 0.75 * ate_s, (ate_a, ate_s)
