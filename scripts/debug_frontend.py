"""Debug the frontend stages in isolation on rendered frames."""
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

from msckf_stereo_c.config import EUROC_CALIB, FrontendConfig
from msckf_stereo_c.models.frontend import (
    _stereo_match,
    make_frontend_params,
    pyramids_for,
)
from msckf_stereo_c.ops.fast import detect_grid_corners
from msckf_stereo_c.ops.klt import optical_flow_pyr_lk
from msckf_stereo_c.ops.camera import undistort_points, distort_points
from msckf_stereo_c.sim import make_circle_trajectory, make_landmarks
from msckf_stereo_c.sim.render import render_stereo_sequence, _distort_project

fcfg = FrontendConfig()
traj = make_circle_trajectory(duration=4.0)
landmarks = make_landmarks(num=500, seed=1)
frame_idx = np.array([300, 310])
img0, img1 = render_stereo_sequence(traj, landmarks, frame_idx)
params = make_frontend_params(EUROC_CALIB, jnp.float32)

pyr0 = pyramids_for(jnp.asarray(img0[0]), fcfg)
pyr1 = pyramids_for(jnp.asarray(img1[0]), fcfg)

# 1. FAST detection
corners = detect_grid_corners(pyr0[0], float(fcfg.fast_threshold), fcfg.detector_cell)
n_det = int(jnp.sum(corners.valid))
print(f"FAST corners: {n_det}")
xy = np.asarray(corners.xy)[np.asarray(corners.valid)]
print("sample corners:", xy[:5])

# Ground-truth projections of landmarks into cam0/cam1 for frame 0.
i = frame_idx[0]
R_wb, p_b = traj.R_w_b[i], traj.p[i]
T_ci0 = EUROC_CALIB.cam0.T_cam_imu_mat()
T01 = EUROC_CALIB.T_cam0_cam1_mat()
p_imu = (landmarks - p_b) @ R_wb.T
p_c0 = p_imu @ T_ci0[:3, :3].T + T_ci0[:3, 3]
p_c1 = p_c0 @ T01[:3, :3].T + T01[:3, 3]
vis = p_c0[:, 2] > 0.3
uv0 = np.zeros((len(landmarks), 2)); uv1 = np.zeros_like(uv0)
uv0[vis] = _distort_project(p_c0[vis], EUROC_CALIB.cam0.intrinsics, EUROC_CALIB.cam0.distortion_coeffs)
uv1[vis] = _distort_project(p_c1[vis], EUROC_CALIB.cam1.intrinsics, EUROC_CALIB.cam1.distortion_coeffs)

# match detected corners to nearest gt landmark projection
from scipy.spatial import cKDTree
tree = cKDTree(uv0[vis])
d, j = tree.query(xy[:20])
print("corner->landmark dist:", d.round(2))

# 2. stereo initial guess quality for TRUE cam0 projections of 20 visible landmarks
vis_ids = np.flatnonzero(vis & (uv0[:,0]>20)&(uv0[:,0]<730)&(uv0[:,1]>20)&(uv0[:,1]<460)&(uv1[:,0]>20)&(uv1[:,0]<730)&(uv1[:,1]>20)&(uv1[:,1]<460))[:30]
pts0 = jnp.asarray(uv0[vis_ids], jnp.float32)
gt1 = uv1[vis_ids]
xn = undistort_points(pts0, params.K0, params.D0, R=params.R_c0_c1)
guess = distort_points(xn, params.K1, params.D1)
print("stereo guess err vs gt cam1 px:", np.linalg.norm(np.asarray(guess)-gt1,axis=1).round(2)[:10])

# 3. full stereo match
pts1, ok = _stereo_match(pyr0, pyr1, pts0, jnp.ones(len(vis_ids), bool), params, fcfg, pyr0[0].shape)
print("stereo match ok:", int(jnp.sum(ok)), "/", len(vis_ids))
err1 = np.linalg.norm(np.asarray(pts1) - gt1, axis=1)
print("stereo match err px:", err1.round(2)[:10])

# 4. temporal KLT: track frame0 -> frame1 with true motion
i2 = frame_idx[1]
R_wb2, p_b2 = traj.R_w_b[i2], traj.p[i2]
p_imu2 = (landmarks - p_b2) @ R_wb2.T
p_c02 = p_imu2 @ T_ci0[:3, :3].T + T_ci0[:3, 3]
uv02 = np.zeros_like(uv0)
vis2 = p_c02[:, 2] > 0.3
uv02[vis2] = _distort_project(p_c02[vis2], EUROC_CALIB.cam0.intrinsics, EUROC_CALIB.cam0.distortion_coeffs)
gt_next = uv02[vis_ids]
pyr0b = pyramids_for(jnp.asarray(img0[1]), fcfg)
res = optical_flow_pyr_lk(pyr0, pyr0b, pts0, pts0, jnp.ones(len(vis_ids), bool), win=15, iters=30, eps=0.01)
print("temporal klt valid:", int(jnp.sum(res.valid)), "/", len(vis_ids))
errt = np.linalg.norm(np.asarray(res.pts) - gt_next, axis=1)
print("temporal klt err px:", errt.round(2)[:10], "| true motion px:", np.linalg.norm(gt_next-uv0[vis_ids],axis=1).round(1)[:5])
