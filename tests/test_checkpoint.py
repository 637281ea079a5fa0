"""Checkpoint/resume: a run split by a save/load round-trip must produce the
identical trajectory as an uninterrupted run."""
import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig
from msckf_stereo_c.io.checkpoint import load_state, save_state
from msckf_stereo_c.models import run_sequence
from msckf_stereo_c.models.state import init_filter_state
from msckf_stereo_c.sim import (
    make_circle_trajectory,
    make_landmarks,
    project_tracks,
    synthesize_imu,
)

CFG = FilterConfig(max_cam_state_size=6, max_tracks=40, max_imu_per_frame=12)


def test_checkpoint_roundtrip_resume(tmp_path):
    traj = make_circle_trajectory(duration=5.0)
    landmarks = make_landmarks(num=250)
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    feats = project_tracks(traj, landmarks, max_features=24, pixel_noise=0.2)

    args = (feats.t, feats.fid, feats.uv, feats.valid, imu.t, imu.gyro, imu.acc)
    full = run_sequence(CFG, EUROC_CALIB, *args, method="schur")

    # First half, checkpoint, restore into a fresh template, second half.
    T = len(feats.t)
    h = T // 2
    first = run_sequence(
        CFG, EUROC_CALIB, feats.t[:h], feats.fid[:h], feats.uv[:h], feats.valid[:h],
        imu.t, imu.gyro, imu.acc, method="schur",
    )
    ckpt = str(tmp_path / "state.npz")
    save_state(ckpt, first.final_state)

    template = init_filter_state(CFG, EUROC_CALIB, jnp.float64)
    restored = load_state(ckpt, template)
    second = run_sequence(
        CFG, EUROC_CALIB, feats.t[h:], feats.fid[h:], feats.uv[h:], feats.valid[h:],
        imu.t, imu.gyro, imu.acc, method="schur", state=restored,
    )

    resumed = np.concatenate([first.positions, second.positions])
    np.testing.assert_allclose(resumed, full.positions, atol=1e-12)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    import pytest

    s1 = init_filter_state(CFG, EUROC_CALIB, jnp.float64)
    ckpt = str(tmp_path / "s.npz")
    save_state(ckpt, s1)
    other = init_filter_state(
        FilterConfig(max_cam_state_size=4, max_tracks=40), EUROC_CALIB, jnp.float64
    )
    with pytest.raises((ValueError, KeyError)):
        load_state(ckpt, other)
