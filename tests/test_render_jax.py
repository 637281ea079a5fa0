"""Device renderer (sim/render_jax.py) vs the numpy oracle renderer
(sim/render.py), plus behavioral checks on the stress channels."""
import numpy as np

from msckf_stereo_c.sim import make_circle_trajectory, make_wall_landmarks
from msckf_stereo_c.sim.render import render_stereo_sequence
from msckf_stereo_c.sim.render_jax import JaxRenderer, StressEvents, make_stress_events


def test_jax_renderer_matches_numpy():
    traj = make_circle_trajectory(duration=3.0)
    lms = make_wall_landmarks(num=200, radius=8.0, seed=1)
    idx = np.array([320, 420])
    ref0, ref1 = render_stereo_sequence(traj, lms, idx, r_wall=8.0)

    r = JaxRenderer(lms, r_wall=8.0)
    img0, img1 = r.render_sequence(traj, idx)

    for ref, ours in ((ref0, img0), (ref1, img1)):
        diff = np.abs(ref.astype(np.float64) - ours.astype(np.float64))
        # f32 vs f64 trig/exp rounding: tiny almost everywhere; allow a few
        # pixels at blob borders/texture seams to disagree more.
        assert np.median(diff) < 0.05, np.median(diff)
        assert np.mean(diff < 0.5) > 0.995, np.mean(diff < 0.5)
        assert diff.max() < 30.0, diff.max()  # no structural mismatch


def test_stress_channels():
    traj = make_circle_trajectory(duration=3.0)
    lms = make_wall_landmarks(num=200, radius=8.0, seed=1)
    idx = np.array([350, 350, 350, 350])
    r = JaxRenderer(lms, r_wall=8.0)

    ev = StressEvents.nominal(4)
    # frame1: texture-poor; frame2: brightness shift; frame3: occluder.
    ev.tex_scale[1] = 0.15
    ev.blob_scale[1] = 0.35
    ev.gain[2] = 0.8
    ev.offset[2] = -15.0
    # Occluder 2 m in front of the camera position, toward the wall.
    p_b = traj.p[350]
    out_dir = p_b[:2] / np.linalg.norm(p_b[:2])
    ev.occ_pos[3] = [p_b[0] + 2.5 * out_dir[0], p_b[1] + 2.5 * out_dir[1], p_b[2]]
    ev.occ_radius[3] = 1.0

    img0, _ = r.render_sequence(traj, idx, ev)
    base, poor, dark, occ = img0

    assert poor.std() < 0.55 * base.std()  # texture-poor flattens the image
    assert dark.mean() < base.mean() - 20.0  # exposure drift
    # The occluder paints a flat 42-intensity region covering a real area.
    occ_frac = np.mean(np.abs(occ - 42.0) < 0.5)
    assert 0.02 < occ_frac < 0.9, occ_frac
    assert np.abs(base - occ).max() > 50.0


def test_make_stress_events_schedule():
    traj = make_circle_trajectory(duration=20.0)
    idx = np.arange(0, traj.t.shape[0], 10)
    ev = make_stress_events(traj, idx)
    T = len(idx)
    u = (traj.t[idx] - traj.t[idx[0]]) / (traj.t[idx[-1]] - traj.t[idx[0]])
    # Texture-poor windows hit their floor inside, recover outside.
    inside = (u > 0.25) & (u < 0.33)
    outside = (u < 0.18) | ((u > 0.39) & (u < 0.41))
    assert ev.tex_scale[inside].max() < 0.2
    assert ev.tex_scale[outside].min() > 0.95
    # Occluder active only in its window.
    occ_on = ev.occ_radius > 0
    assert occ_on.any()
    assert (u[occ_on] > 0.41).all() and (u[occ_on] < 0.57).all()
    # Exposure varies meaningfully.
    assert ev.gain.max() - ev.gain.min() > 0.3
