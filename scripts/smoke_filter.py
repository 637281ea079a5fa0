"""Smoke-run the filter on a synthetic trajectory (CPU, f64)."""
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

import numpy as np

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig
from msckf_stereo_c.models import run_sequence
from msckf_stereo_c.sim import (
    make_circle_trajectory,
    make_landmarks,
    project_tracks,
    synthesize_imu,
)

import time

cfg = FilterConfig(max_cam_state_size=8, max_tracks=48, max_imu_per_frame=12)

traj = make_circle_trajectory(duration=8.0)
landmarks = make_landmarks(num=300)
imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
feats = project_tracks(traj, landmarks, max_features=32, pixel_noise=0.2)

# Prepend a static window for gravity init: the filter assumes the first 200
# samples average to gravity; our trajectory starts moving, so instead pass
# true values directly by synthesizing a static prefix.
t0 = time.time()
res = run_sequence(
    cfg,
    EUROC_CALIB,
    feats.t,
    feats.fid,
    feats.uv,
    feats.valid,
    imu.t,
    imu.gyro,
    imu.acc,
    method="qr",
)
print("run time", time.time() - t0)

from msckf_stereo_c.io import evaluate_ate

gt = traj.p[feats.frame_index]
print("frames:", len(feats.t))
print("num_cams:", res.num_cams[:20], "...", res.num_cams[-5:])
print("num_tracks:", res.num_tracks[-5:])
ate = evaluate_ate(res.times, res.positions, feats.t, gt)
print(f"ATE RMSE: {ate.rmse:.4f} m  mean {ate.mean:.4f}  max {ate.max:.4f}  pairs {ate.num_pairs}")
