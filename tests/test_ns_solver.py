"""Newton–Schulz linear solver (the factorization-free path): unit tests
against exact inverses, and end-to-end equivalence of the ns-solver filter
against the Cholesky-solver filter on a synthetic world."""
import dataclasses

import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig
from msckf_stereo_c.models import run_sequence
from msckf_stereo_c.ops.linalg import ns_posdef_inverse
from msckf_stereo_c.sim import (
    make_circle_trajectory,
    make_landmarks,
    project_tracks,
    synthesize_imu,
)

CFG = FilterConfig(max_cam_state_size=8, max_tracks=48, max_imu_per_frame=12)


def test_ns_inverse_spd():
    """SPD matrices across a range of condition numbers (f64, tight)."""
    rng = np.random.default_rng(0)
    for n, cond in [(8, 1e1), (40, 1e3), (80, 1e5)]:
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        eigs = np.geomspace(1.0 / cond, 1.0, n)
        S = jnp.asarray(Q * eigs @ Q.T)
        X = ns_posdef_inverse(S, float(eigs[0]), iters=17)
        err = np.abs(np.asarray(X @ S) - np.eye(n)).max()
        # Attainable limit is ~ n * cond * eps_f64.
        assert err < max(n * cond * 2.3e-16 * 10, 1e-12), f"n={n} cond={cond}: |XS - I| = {err}"


def test_ns_inverse_psd_product():
    """The update path inverts sigma2 I + N P with N, P PSD — a non-normal
    matrix with real positive spectrum >= sigma2."""
    rng = np.random.default_rng(1)
    n, sigma2 = 48, 1.225e-3
    for k in range(3):
        A = rng.normal(size=(n, n // 2))
        N = A @ A.T  # rank-deficient PSD (inactive camera slots)
        N[: n // 4] = 0.0
        N[:, : n // 4] = 0.0
        B = rng.normal(size=(n, n))
        P = B @ B.T * 1e-3 + np.eye(n) * 1e-5
        M = jnp.asarray(sigma2 * np.eye(n) + N @ P)
        X = ns_posdef_inverse(M, sigma2, iters=16)
        err = np.abs(np.asarray(X @ M) - np.eye(n)).max()
        assert err < 1e-7, f"case {k}: |XM - I| = {err}"


def test_ns_inverse_batched():
    rng = np.random.default_rng(2)
    S = rng.normal(size=(5, 12, 12))
    S = S @ np.swapaxes(S, -1, -2) + 0.01 * np.eye(12)
    X = ns_posdef_inverse(jnp.asarray(S), 0.01, iters=16)
    err = np.abs(np.asarray(X @ S) - np.eye(12)).max()
    assert err < 1e-9, err


def test_ns_filter_matches_cholesky_filter():
    """Full filter on a synthetic world: the Newton–Schulz schur path must
    reproduce the exact-solver schur path (f64)."""
    traj = make_circle_trajectory(duration=8.0)
    landmarks = make_landmarks(num=300)
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    feats = project_tracks(traj, landmarks, max_features=32, pixel_noise=0.2)

    def run(cfg):
        return run_sequence(
            cfg, EUROC_CALIB, feats.t, feats.fid, feats.uv, feats.valid,
            imu.t, imu.gyro, imu.acc, method="schur",
        )

    res_exact = run(CFG)
    res_ns = run(dataclasses.replace(CFG, ns_iters=14))
    diff = np.linalg.norm(res_exact.positions - res_ns.positions, axis=1)
    assert diff.max() < 1e-4, f"ns vs cholesky diverged: {diff.max()}"
