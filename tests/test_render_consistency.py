"""Renderer ground-truth consistency (VERDICT round 2, next #2b).

Settles the round-2 open hypothesis that the screen-space Gaussian landmark
blobs might carry sub-pixel bias vs the geometric projection at long
baselines: render frames with a FLAT background (tex_scale=0), measure each
isolated blob's intensity centroid, and compare against the analytic
full-distortion projection of its landmark — in both cameras, at widely
separated viewpoints.  If the blobs are drawn where the projection says
(<0.15 px), any tracked-vs-projected residual measured by
scripts/track_bias_probe.py is attributable to the *tracker*, not the sim.
"""
import numpy as np
import pytest

from msckf_stereo_c.config import EUROC_CALIB
from msckf_stereo_c.sim.render_jax import JaxRenderer, StressEvents
from msckf_stereo_c.sim.trajectory import make_circle_trajectory, make_wall_landmarks

R_WALL = 8.0


def _project_px(lms, R_wb, p_b, T_ci, intr, dist):
    """Full radtan pixel projection (the renderer's lens model)."""
    R_ci, t_ci = T_ci[:3, :3], T_ci[:3, 3]
    p_imu = (lms - p_b) @ R_wb.T
    p_c = p_imu @ R_ci.T + t_ci
    z = p_c[:, 2]
    x = p_c[:, 0] / z
    y = p_c[:, 1] / z
    k1, k2, p1, p2 = dist
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    fx, fy, cx, cy = intr
    return np.stack([xd * fx + cx, yd * fy + cy], axis=1), z


@pytest.fixture(scope="module")
def rendered():
    calib = EUROC_CALIB
    traj = make_circle_trajectory(duration=25.0)
    lms = make_wall_landmarks(num=500, radius=R_WALL, z_min=-3.5, z_max=3.5, seed=1)
    renderer = JaxRenderer(lms, calib, r_wall=R_WALL)
    # Widely separated viewpoints (about a third of the orbit apart).
    idx = np.array([800, 2600, 4400])
    ev = StressEvents.nominal(len(idx))
    ev.tex_scale[:] = 0.0  # flat background: blobs only
    img0, img1 = renderer.render_sequence(traj, idx, ev)
    return calib, traj, lms, idx, img0, img1


def _centroid_errors(img, lms, R_wb, p_b, T_ci, cam):
    H, W = img.shape
    uv, z = _project_px(lms, R_wb, p_b, T_ci, cam.intrinsics, cam.distortion_coeffs)
    vis = (z > 0.5) & (uv[:, 0] > 12) & (uv[:, 0] < W - 13)
    vis &= (uv[:, 1] > 12) & (uv[:, 1] < H - 13)
    # Isolated blobs only (no neighbor within 14 px contaminating the window).
    ids = np.flatnonzero(vis)
    d = np.linalg.norm(uv[ids, None, :] - uv[None, ids, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    ids = ids[d.min(axis=1) > 14.0]
    errs = []
    r = 6
    for j in ids:
        ci = np.round(uv[j]).astype(int)
        win = img[ci[1] - r : ci[1] + r + 1, ci[0] - r : ci[0] + r + 1] - 70.0
        m = win.sum()
        if m < 20.0:  # too dim to localize (amp drawn low)
            continue
        gy, gx = np.mgrid[-r : r + 1, -r : r + 1]
        cx = (win * gx).sum() / m + ci[0]
        cy = (win * gy).sum() / m + ci[1]
        errs.append([cx - uv[j, 0], cy - uv[j, 1]])
    assert len(errs) >= 15
    return np.array(errs)


def test_blob_centers_match_projection_both_cams_long_baseline(rendered):
    calib, traj, lms, idx, img0, img1 = rendered
    T_ci0 = calib.cam0.T_cam_imu_mat()
    T_ci1 = calib.T_cam0_cam1_mat() @ T_ci0
    worst = 0.0
    mean_abs = []
    for k in range(len(idx)):
        R_wb, p_b = traj.R_w_b[idx[k]], traj.p[idx[k]]
        for img, T_ci, cam in (
            (np.asarray(img0[k]), T_ci0, calib.cam0),
            (np.asarray(img1[k]), T_ci1, calib.cam1),
        ):
            e = _centroid_errors(img, lms, R_wb, p_b, T_ci, cam)
            worst = max(worst, np.abs(e).max())
            mean_abs.append(np.abs(e).mean())
    # Centroid-of-truncated-Gaussian has a small inherent bias (<~0.05 px);
    # anything larger would indicate the renderer draws blobs off the
    # geometric projection.
    assert worst < 0.15, f"worst blob-center error {worst:.3f} px"
    assert np.mean(mean_abs) < 0.05


def test_blob_disparity_matches_projection(rendered):
    """Stereo disparity of the drawn blobs equals projected disparity —
    the scale-relevant channel (1% disparity error = 1% depth error)."""
    calib, traj, lms, idx, img0, img1 = rendered
    T_ci0 = calib.cam0.T_cam_imu_mat()
    T01 = calib.T_cam0_cam1_mat()
    T_ci1 = T01 @ T_ci0
    k = 1
    R_wb, p_b = traj.R_w_b[idx[k]], traj.p[idx[k]]
    e0 = _centroid_errors(np.asarray(img0[k]), lms, R_wb, p_b, T_ci0, calib.cam0)
    e1 = _centroid_errors(np.asarray(img1[k]), lms, R_wb, p_b, T_ci1, calib.cam1)
    # Per-camera centroid errors are independent bounds on the disparity
    # error of any jointly-visible blob.
    bound = np.abs(e0[:, 0]).max() + np.abs(e1[:, 0]).max()
    assert bound < 0.25, f"disparity error bound {bound:.3f} px"
