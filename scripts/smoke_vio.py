"""Smoke-run the FULL pipeline (rendered images -> frontend -> filter)."""
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

import time

import numpy as np

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig, FrontendConfig
from msckf_stereo_c.io import evaluate_ate
from msckf_stereo_c.models.vio import run_vio_sequence
from msckf_stereo_c.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
from msckf_stereo_c.sim.render import render_stereo_sequence

fcfg = FrontendConfig(max_features=64)
mcfg = FilterConfig(max_cam_state_size=8, max_tracks=80, max_imu_per_frame=12)

traj = make_circle_trajectory(duration=6.0)
landmarks = make_wall_landmarks(num=500, radius=8.0, seed=1)
imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
frame_idx = np.arange(0, traj.t.shape[0], 10)

t0 = time.time()
img0, img1 = render_stereo_sequence(traj, landmarks, frame_idx, r_wall=8.0)
print(f"rendered {len(frame_idx)} stereo frames in {time.time()-t0:.1f}s")

t0 = time.time()
res = run_vio_sequence(
    fcfg, mcfg, EUROC_CALIB,
    traj.t[frame_idx], img0, img1,
    imu.t, imu.gyro, imu.acc,
    chunk=40,
)
print(f"vio run in {time.time()-t0:.1f}s")
print("tracking counters (last 5):")
for k, v in res.tracking.items():
    print(" ", k, v[-5:])
print("num_tracks:", res.num_tracks[-5:])

gt = traj.p[frame_idx]
ate = evaluate_ate(res.times, res.positions, traj.t[frame_idx], gt)
print(f"FULL-PIPELINE ATE RMSE: {ate.rmse:.4f} m  mean {ate.mean:.4f}  max {ate.max:.4f}")
