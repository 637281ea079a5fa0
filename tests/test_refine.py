"""VIO -> BA refinement: build the problem from a synthetic filter run and
verify the refinement reduces reprojection cost without corrupting poses."""
import numpy as np

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig
from msckf_stereo_c.io import evaluate_ate
from msckf_stereo_c.models import run_sequence
from msckf_stereo_c.parallel.refine import build_ba_problem, refine_trajectory
from msckf_stereo_c.sim import (
    make_circle_trajectory,
    make_landmarks,
    project_tracks,
    synthesize_imu,
)

CFG = FilterConfig(max_cam_state_size=8, max_tracks=48, max_imu_per_frame=12)


def test_vio_to_ba_refinement():
    traj = make_circle_trajectory(duration=8.0)
    landmarks = make_landmarks(num=300)
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    feats = project_tracks(traj, landmarks, max_features=32, pixel_noise=0.2)

    res = run_sequence(
        CFG, EUROC_CALIB, feats.t, feats.fid, feats.uv, feats.valid,
        imu.t, imu.gyro, imu.acc, method="schur",
    )

    prob = build_ba_problem(
        res.times, res.quats_xyzw, res.positions,
        feats.fid, feats.uv, feats.valid,
        keyframe_stride=8, max_keyframes=16,
    )
    assert prob is not None
    L, F = prob.mask.shape
    assert F >= 8 and L >= 8

    refined, costs = refine_trajectory(prob, iters=8)
    costs = np.asarray(costs)
    assert costs[-1] < costs[0], (costs[0], costs[-1])
    assert np.isfinite(np.asarray(refined.cam_p)).all()

    # Refinement should not hurt trajectory accuracy (gauge pose fixed, so
    # compare in the VIO frame without alignment surprises).
    kf = np.arange(0, len(res.times), 8)[:16]
    gt = traj.p[feats.frame_index[kf]]
    before = evaluate_ate(res.times[kf], res.positions[kf], res.times[kf], gt)
    # cam0 positions differ from body positions by the (small) lever arm;
    # compare relative improvement of the BA'd camera trajectory.
    after = evaluate_ate(res.times[kf], np.asarray(refined.cam_p), res.times[kf], gt)
    assert after.rmse < before.rmse * 1.5 + 0.05
