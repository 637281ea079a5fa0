"""Filter-consistency tests on synthetic trajectories (the reference has no
tests; its gate is the EuRoC ATE run — SURVEY.md §4.  Here the same gate runs
on simulated data with known ground truth)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig
from msckf_stereo_c.io import evaluate_ate
from msckf_stereo_c.models import run_sequence
from msckf_stereo_c.sim import (
    make_circle_trajectory,
    make_landmarks,
    project_tracks,
    synthesize_imu,
)

CFG = FilterConfig(max_cam_state_size=8, max_tracks=48, max_imu_per_frame=12)


def _make_world(duration=8.0, pixel_noise=0.2, gyro_noise=5e-4, acc_noise=5e-3, seed=0):
    traj = make_circle_trajectory(duration=duration)
    landmarks = make_landmarks(num=300)
    imu = synthesize_imu(traj, gyro_noise=gyro_noise, acc_noise=acc_noise, seed=seed)
    feats = project_tracks(traj, landmarks, max_features=32, pixel_noise=pixel_noise)
    return traj, imu, feats


@pytest.fixture(scope="module")
def world():
    return _make_world()


def _run(world, method="qr", **kw):
    traj, imu, feats = world
    return run_sequence(
        CFG, EUROC_CALIB, feats.t, feats.fid, feats.uv, feats.valid,
        imu.t, imu.gyro, imu.acc, method=method, **kw,
    )


def test_synthetic_ate_gate(world):
    """End-to-end gate: the filter must track a noisy synthetic trajectory to
    centimeter-level ATE (the EuRoC bar is 0.13 m over 144 s; this 8 s run
    must be well under that)."""
    traj, imu, feats = world
    res = _run(world)
    ate = evaluate_ate(res.times, res.positions, feats.t, traj.p[feats.frame_index])
    assert ate.num_pairs == len(feats.t)
    assert ate.rmse < 0.05, f"ATE RMSE too high: {ate.rmse}"


def test_qr_cholesky_equivalent(world):
    """The two measurement-compression paths are algebraically identical; the
    trajectories they produce must agree to fine tolerance."""
    res_qr = _run(world, method="qr")
    res_ch = _run(world, method="cholesky")
    diff = np.linalg.norm(res_qr.positions - res_ch.positions, axis=1)
    assert diff.max() < 1e-4, f"qr vs cholesky diverged: {diff.max()}"


def test_schur_equivalent(world):
    """The QR-free Schur path (the device fast path) is algebraically the same
    update and must reproduce the QR trajectory."""
    res_qr = _run(world, method="qr")
    res_sc = _run(world, method="schur")
    diff = np.linalg.norm(res_qr.positions - res_sc.positions, axis=1)
    assert diff.max() < 1e-4, f"qr vs schur diverged: {diff.max()}"


def test_f32_schur_accuracy(world):
    """The hardware path (float32 + schur) must stay within the ATE gate —
    this is the dtype/method combination bench.py and the GPU drivers run."""
    import jax.numpy as jnp

    traj, imu, feats = world
    res = _run(world, method="schur", dtype=jnp.float32)
    ate = evaluate_ate(res.times, res.positions, feats.t, traj.p[feats.frame_index])
    assert np.isfinite(res.positions).all()
    assert ate.rmse < 0.08, f"f32 ATE RMSE too high: {ate.rmse}"


def test_covariance_symmetric_psd(world):
    res = _run(world)
    P = np.asarray(res.final_state.P)
    np.testing.assert_allclose(P, P.T, atol=1e-10)
    n_act = 21 + 6 * int(res.final_state.num_cams)
    eigs = np.linalg.eigvalsh(P[:n_act, :n_act])
    assert eigs.min() > -1e-9, f"covariance not PSD: min eig {eigs.min()}"
    # Inactive block must stay exactly zero.
    assert np.all(P[n_act:, :] == 0) and np.all(P[:, n_act:] == 0)


def test_velocity_estimate(world):
    traj, imu, feats = world
    res = _run(world)
    # Speed is frame-invariant: compare norms.
    v_est = float(jnp.linalg.norm(res.final_state.imu.v))
    v_true = float(np.linalg.norm(traj.v[feats.frame_index[-1]]))
    assert abs(v_est - v_true) < 0.1, (v_est, v_true)


def test_gyro_bias_estimate():
    """With a deliberate gyro bias the filter must estimate it."""
    traj = make_circle_trajectory(duration=8.0)
    landmarks = make_landmarks(num=300)
    bias = np.array([0.02, -0.01, 0.015])
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, gyro_bias=bias, seed=3)
    feats = project_tracks(traj, landmarks, max_features=32, pixel_noise=0.2)
    res = run_sequence(
        CFG, EUROC_CALIB, feats.t, feats.fid, feats.uv, feats.valid,
        imu.t, imu.gyro, imu.acc,
    )
    bg = np.asarray(res.final_state.imu.bg)
    # The static init window absorbs the constant bias into b_g directly.
    np.testing.assert_allclose(bg, bias, atol=5e-3)


def test_chunked_run_matches_single(world):
    traj, imu, feats = world
    res_full = _run(world)
    res_chunk = _run(world, chunk=37)
    np.testing.assert_allclose(res_full.positions, res_chunk.positions, atol=1e-12)


def test_prune_update_camera_compaction_exact():
    """The camera-compacted gate+update used by the prune path (2 slots,
    rank-12 EKF update) must equal the full-width schur path exactly: same
    gating scores, same covariance, same corrected state."""
    from msckf_stereo_c.models.state import init_filter_state
    from msckf_stereo_c.models.update import (
        cam_cov_blocks,
        measurement_update_schur,
        measurement_update_schur_compact,
        schur_gating,
        schur_gating_compact,
        track_blocks,
    )

    cfg = CFG
    M = cfg.max_cam_state_size
    K = 16
    rng = np.random.default_rng(3)
    state = init_filter_state(cfg, EUROC_CALIB, jnp.float64)

    # Random PSD covariance, random camera ring, random observations.
    A = rng.normal(size=(state.P.shape[0], state.P.shape[0])) * 0.01
    P = jnp.asarray(A @ A.T + 1e-4 * np.eye(A.shape[0]))
    q = rng.normal(size=(M, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cams = state.cams._replace(
        q=jnp.asarray(q), p=jnp.asarray(rng.normal(size=(M, 3))),
        q_null=jnp.asarray(q), p_null=jnp.asarray(rng.normal(size=(M, 3)) * 0.1),
    )
    state = state._replace(P=P, cams=cams, num_cams=jnp.asarray(M, jnp.int32))

    slot_a, slot_b = jnp.asarray(2), jnp.asarray(7)
    cam_idx = jnp.stack([slot_a, slot_b])
    pos = jnp.asarray(rng.normal(size=(K, 3)) * 2 + np.array([0, 0, 5.0]))
    obs = jnp.asarray(rng.normal(size=(K, M, 4)) * 0.2)
    obs_mask = jnp.zeros((K, M), bool).at[:, cam_idx].set(True)
    use = jnp.asarray(rng.random(K) > 0.3)
    obs_mask = obs_mask & use[:, None]

    full = track_blocks(
        pos, obs, obs_mask, state.cams, state.gravity,
        jnp.eye(3, dtype=P.dtype), jnp.asarray([-0.1, 0.0, 0.0], P.dtype),
    )
    cams_c = state.cams._replace(
        q=state.cams.q[cam_idx], p=state.cams.p[cam_idx],
        q_null=state.cams.q_null[cam_idx], p_null=state.cams.p_null[cam_idx],
    )
    comp = track_blocks(
        pos, obs[:, cam_idx], obs_mask[:, cam_idx], cams_c, state.gravity,
        jnp.eye(3, dtype=P.dtype), jnp.asarray([-0.1, 0.0, 0.0], P.dtype),
    )

    sigma2 = jnp.asarray(0.035**2)
    g_full = schur_gating(full, P, sigma2)
    g_comp = schur_gating_compact(comp, cam_cov_blocks(P, cam_idx), sigma2)
    np.testing.assert_allclose(np.asarray(g_comp), np.asarray(g_full), rtol=1e-8, atol=1e-10)

    s_full = measurement_update_schur(state, full, use, sigma2)
    s_comp = measurement_update_schur_compact(state, comp, use, sigma2, cam_idx)
    np.testing.assert_allclose(np.asarray(s_comp.P), np.asarray(s_full.P), rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(np.asarray(s_comp.imu.p), np.asarray(s_full.imu.p), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(np.asarray(s_comp.imu.q), np.asarray(s_full.imu.q), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(s_comp.cams.p), np.asarray(s_full.cams.p), rtol=1e-6, atol=1e-12
    )


def test_matmul_precision_knob(world, tmp_path):
    """FilterConfig.matmul_precision plumbs through filter_step (the context
    manager accepts the value) and the YAML loader round-trips it.  On CPU
    the setting is numerically inert, so the trajectory must be unchanged."""
    from msckf_stereo_c.config import load_filter_config
    import dataclasses

    res_hi = _run(world, method="schur")
    cfg_tf = dataclasses.replace(CFG, matmul_precision="tensorfloat32")
    traj, imu, feats = world
    res_tf = run_sequence(
        cfg_tf, EUROC_CALIB, feats.t, feats.fid, feats.uv, feats.valid,
        imu.t, imu.gyro, imu.acc, method="schur",
    )
    np.testing.assert_allclose(res_tf.positions, res_hi.positions, rtol=0, atol=1e-12)

    p = tmp_path / "msckf.yaml"
    p.write_text("matmul_precision: bfloat16\nns_iters: 4\n")
    loaded = load_filter_config(str(p))
    assert loaded.matmul_precision == "bfloat16" and loaded.ns_iters == 4
