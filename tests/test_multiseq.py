"""Sharded multi-sequence execution must reproduce per-sequence results."""
import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig
from msckf_stereo_c.models import run_sequence
from msckf_stereo_c.parallel.multiseq import run_multi_sequence
from msckf_stereo_c.sim import (
    make_circle_trajectory,
    make_landmarks,
    project_tracks,
    synthesize_imu,
)

CFG = FilterConfig(max_cam_state_size=6, max_tracks=40, max_imu_per_frame=12)


def test_multi_sequence_matches_individual_runs():
    traj = make_circle_trajectory(duration=4.0)
    landmarks = make_landmarks(num=250)

    seqs = []
    for seed in range(3):  # 3 sequences -> padded to 8 devices internally
        imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=seed)
        feats = project_tracks(traj, landmarks, max_features=24, pixel_noise=0.2, seed=seed + 10)
        seqs.append((imu, feats))

    # Individual runs (same dtype/method as the sharded path).
    singles = [
        run_sequence(
            CFG, EUROC_CALIB, f.t, f.fid, f.uv, f.valid, i.t, i.gyro, i.acc,
            dtype=jnp.float32, method="schur",
        )
        for i, f in seqs
    ]

    B = len(seqs)
    frame_t = np.stack([f.t for _, f in seqs])
    fid = np.stack([f.fid for _, f in seqs])
    uv = np.stack([f.uv for _, f in seqs])
    valid = np.stack([f.valid for _, f in seqs])
    imu_t = np.stack([i.t for i, _ in seqs])
    gyro = np.stack([i.gyro for i, _ in seqs])
    acc = np.stack([i.acc for i, _ in seqs])

    states, poses, metrics = run_multi_sequence(
        CFG, EUROC_CALIB, frame_t, fid, uv, valid, imu_t, gyro, acc,
        dtype=jnp.float32, method="schur",
    )

    for b in range(B):
        np.testing.assert_allclose(
            np.asarray(poses.p[b]), singles[b].positions, atol=1e-4,
        )
    assert metrics["total_tracks"] > 0
