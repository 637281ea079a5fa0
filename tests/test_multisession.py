"""Multi-session map alignment (parallel/multisession.py; BASELINE
config 5).  Unit tests of the association/edge machinery on synthetic
geometry, plus the short end-to-end joint gate (two real VIO sessions,
distributed pose-graph solve on the 8-device CPU mesh).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from msckf_stereo_c.parallel.multisession import (
    SessionData,
    apply_rigid,
    build_joint_graph,
    intersession_edges,
    match_landmarks,
    optimize_joint,
    relative_prior,
)
from msckf_stereo_c.utils.quaternion import jpl_to_rot, rot_to_jpl


def _rigid(yaw, t):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]), np.asarray(t)


def test_match_landmarks_mutual_nn():
    rng = np.random.default_rng(0)
    lms = rng.uniform(-5, 5, (60, 3))
    R, t = _rigid(0.0, (0.0, 0.0, 0.0))
    # B sees a shuffled subset with small noise; 20 outliers far away.
    perm = rng.permutation(60)[:40]
    lms_b = lms[perm] + rng.normal(0, 0.02, (40, 3))
    outliers = rng.uniform(20, 30, (20, 3))
    all_b = np.concatenate([lms_b, outliers])
    ia, ib = match_landmarks(lms, all_b, radius=0.3)
    assert len(ia) >= 35
    assert np.all(ib < 40)  # no outlier matched
    np.testing.assert_array_equal(perm[ib], ia)


def _synthetic_sessions(yaw=0.5, offset=(1.0, -0.5, 0.2), n_kf=24, n_lm=80, seed=3):
    """Two noise-free synthetic sessions observing one landmark field; B's
    odometry frame is rigidly offset from A's by (yaw, offset)."""
    rng = np.random.default_rng(seed)
    lms_w = rng.uniform(-4, 4, (n_lm, 3))
    th = np.linspace(0, 2 * np.pi, n_kf, endpoint=False)

    def poses(radius, phase):
        p = np.stack(
            [radius * np.cos(th + phase), radius * np.sin(th + phase), 0.2 * np.sin(th)],
            axis=1,
        )
        qs = []
        for a in th:
            c, s = np.cos(a), np.sin(a)
            R = np.array([[-s, c, 0.0], [0.0, 0.0, 1.0], [c, s, 0.0]])
            qs.append(np.asarray(rot_to_jpl(jnp.asarray(R))))
        return np.stack(qs), p

    qA, pA = poses(3.0, 0.0)
    qB_w, pB_w = poses(2.5, 1.0)

    # Session B's odometry frame: x_A(=world) = R_ab x_B + t_ab.
    R_ab, t_ab = _rigid(yaw, offset)
    qB, pB = apply_rigid(R_ab.T, -R_ab.T @ t_ab, qB_w, pB_w)
    lms_b = (lms_w - t_ab) @ R_ab  # world -> B frame

    mask = rng.random((n_lm, n_kf)) < 0.6
    sessA = SessionData(kf_times=np.arange(n_kf) * 1.0, q=qA, p=pA,
                        landmarks=lms_w, lm_mask=mask)
    sessB = SessionData(kf_times=np.arange(n_kf) * 1.0 + 1e4, q=qB, p=pB,
                        landmarks=lms_b, lm_mask=mask)
    return sessA, sessB, (R_ab, t_ab), lms_w


def test_intersession_edges_recover_exact_transform():
    """With noise-free geometry the Kabsch edges must encode the exact
    inter-session transform: optimizing the joint graph from a WRONG prior
    must recover B's true world poses."""
    sessA, sessB, (R_ab, t_ab), _ = _synthetic_sessions()
    n_kf = sessA.q.shape[0]

    # Perfect association is known here (same landmark indexing).
    ia = ib = np.arange(sessB.landmarks.shape[0], dtype=np.int32)
    inter = intersession_edges(sessA, sessB, ia, ib, min_common=6, max_edges=48)
    assert len(inter[0]) >= 8

    # Corrupted prior: 6 degrees of yaw + 0.4 m off.
    Rn, tn = _rigid(0.10, (0.3, -0.25, 0.1))
    qB_bad, pB_bad = apply_rigid(Rn @ R_ab, Rn @ t_ab + tn, sessB.q, sessB.p)
    sessB_in_a = SessionData(sessB.kf_times, qB_bad, pB_bad,
                             sessB.landmarks, sessB.lm_mask)
    graph = build_joint_graph(sessA, sessB_in_a, inter)
    refined, costs = optimize_joint(graph, mesh=None, iters=15)

    # True B world poses.
    qB_w, pB_w = apply_rigid(R_ab, t_ab, sessB.q, sessB.p)
    p_opt = np.asarray(refined.p)[n_kf:]
    err_before = np.linalg.norm(pB_bad - pB_w, axis=1)
    err_after = np.linalg.norm(p_opt - pB_w, axis=1)
    assert err_before.max() > 0.3
    assert err_after.max() < 0.02, err_after.max()
    assert float(costs[-1]) < float(costs[0]) * 1e-3


def test_relative_prior_roundtrip():
    rng = np.random.default_rng(1)
    R_wa, _ = _rigid(0.3, (0, 0, 0))
    R_wb, _ = _rigid(-0.7, (0, 0, 0))
    ta, tb = rng.normal(0, 1, 3), rng.normal(0, 1, 3)
    R_ab, t_ab = relative_prior((R_wa, ta), (R_wb, tb))
    # Map a B-frame point through B->A then A->world; must equal B->world.
    x_b = rng.normal(0, 1, 3)
    x_w_direct = R_wb @ x_b + tb
    x_a = R_ab @ x_b + t_ab
    x_w_via_a = R_wa @ x_a + ta
    np.testing.assert_allclose(x_w_via_a, x_w_direct, atol=1e-12)


@pytest.mark.slow
def test_joint_gate_end_to_end():
    """Short two-session VIO run through the full multisession pipeline on
    the 8-device CPU mesh: the pose-graph solve must cut the joint ATE well
    below the prior-only alignment."""
    import sys, os

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    from multisession_gate import run_multisession

    # Operator-grade coarse prior (the gate's regime): the landmark tiers
    # recover coarse priors down to the maps' own accuracy floor (~0.06 m
    # here); a small prior is already AT that floor and cannot be improved
    # (docs/STRESS_NOTES.md round 5).
    out = run_multisession(
        duration=12.0, prior_yaw_deg=10.0, prior_trans_m=0.75,
        keyframe_stride=5, chunk=48, verbose=False,
    )
    assert out["joint_ate_after_graph"] < 0.5 * out["joint_ate_prior"], out
    assert out["joint_ate_after_graph"] < 0.13, out  # the BASELINE gate bar
    # The pose-graph tier must not degrade the global-alignment tier (it
    # may only add per-keyframe corrections on top of the Kabsch fit).
    assert out["joint_ate_after_graph"] <= out["joint_ate_global_align"] + 0.02, out
    assert out["mesh_devices"] == 8
