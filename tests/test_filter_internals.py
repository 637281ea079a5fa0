"""Filter-internals differential dump (reference debug_msckfvio.txt frame-9
Jacobian dump, msckf_vio.cpp:719-723): run_vio_sequence(internals_at=N)
must expose the frame-N update tensors without perturbing the run."""
import numpy as np
import jax.numpy as jnp

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig, FrontendConfig
from msckf_stereo_c.models.vio import run_vio_sequence
from msckf_stereo_c.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu

FCFG = FrontendConfig(max_features=48)
MCFG = FilterConfig(max_cam_state_size=6, max_tracks=64, max_imu_per_frame=12)


def test_internals_dump():
    traj = make_circle_trajectory(duration=6.0)
    lms = make_wall_landmarks(num=300, radius=8.0, seed=1)
    imu = synthesize_imu(traj, gyro_noise=1e-4, acc_noise=1e-3, seed=0)
    idx = np.arange(0, traj.t.shape[0], 10)[:24]

    # Deterministic track death: blank the scene from frame N on (texture
    # and blobs to zero -> flat images -> the KLT min-eig gate kills every
    # track), so frame N's filter step is guaranteed a full candidate set.
    from msckf_stereo_c.sim.render_jax import JaxRenderer, StressEvents

    N = 20
    ev = StressEvents.nominal(len(idx))
    ev.tex_scale[N:] = 0.0
    ev.blob_scale[N:] = 0.0
    img0, img1 = JaxRenderer(lms, r_wall=8.0).render_sequence(traj, idx, ev)

    kw = dict(
        image_dtype=jnp.float32, filter_dtype=jnp.float64, method="qr", chunk=10
    )
    res = run_vio_sequence(
        FCFG, MCFG, EUROC_CALIB, traj.t[idx], img0, img1,
        imu.t, imu.gyro, imu.acc, internals_at=N, **kw,
    )
    d = res.internals
    assert d is not None

    K = MCFG.max_update_tracks
    M = MCFG.max_cam_state_size
    D = 21 + 6 * M
    assert d["H_x_blocks"].shape == (K, M, 4, 6)
    assert d["H_f_blocks"].shape == (K, M, 4, 3)
    assert d["H_o"].shape == (K, 4 * M, D)
    assert d["gamma_qr"].shape == (K,)

    # The dump frame must actually have update candidates, and the two
    # gating algebras must agree on them (same scores, same decisions).
    used = np.asarray(d["candidate_use"])
    assert used.any(), "dump frame has no lost-track candidates; move N"
    gq, gs = np.asarray(d["gamma_qr"]), np.asarray(d["gamma_schur"])
    np.testing.assert_allclose(gq[used], gs[used], rtol=1e-6, atol=1e-8)
    assert (np.asarray(d["gate_pass_qr"]) == np.asarray(d["gate_pass_schur"]))[used].all()

    # Nullspace-projection contract (featureJacobian, msckf_vio.cpp:756-766):
    # H_o^T H_o == H_x^T (I - P_f) H_x with P_f the projector onto col(H_f),
    # i.e. the dump carries exactly the feature-marginalized information.
    M4 = 4 * M
    D_ = D
    Hx_blocks = np.asarray(d["H_x_blocks"])  # (K, M, 4, 6)
    Hf_blocks = np.asarray(d["H_f_blocks"]).reshape(K, M4, 3)
    H_o = np.asarray(d["H_o"])
    r_blocks = np.asarray(d["r_blocks"]).reshape(K, M4)
    r_o = np.asarray(d["r_o"])
    for k in np.flatnonzero(used)[:4]:
        Hx = np.zeros((M4, D_))
        for m in range(M):
            Hx[4 * m : 4 * m + 4, 21 + 6 * m : 21 + 6 * m + 6] = Hx_blocks[k, m]
        Hf = Hf_blocks[k]
        P_f = Hf @ np.linalg.pinv(Hf)
        expected = Hx.T @ (np.eye(M4) - P_f) @ Hx
        np.testing.assert_allclose(H_o[k].T @ H_o[k], expected, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(
            r_o[k] @ r_o[k],
            r_blocks[k] @ (np.eye(M4) - P_f) @ r_blocks[k],
            rtol=1e-6, atol=1e-9,
        )

    # The dump must not perturb the run: same poses with and without.
    res2 = run_vio_sequence(
        FCFG, MCFG, EUROC_CALIB, traj.t[idx], img0, img1,
        imu.t, imu.gyro, imu.acc, **kw,
    )
    np.testing.assert_array_equal(res.positions, res2.positions)
