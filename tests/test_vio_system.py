"""Full-system tests: vio_step jit/vmap sanity and batched==single equivalence
(the bench and multi-sequence paths rely on vmapped frontend internals —
sorts, searchsorted, scatters — behaving identically under vmap)."""
import jax
import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig, FrontendConfig
from msckf_stereo_c.models.frontend import make_frontend_params
from msckf_stereo_c.models.msckf import make_params
from msckf_stereo_c.models.propagation import ImuBatch
from msckf_stereo_c.models.vio import init_vio_state, vio_step
from msckf_stereo_c.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
from msckf_stereo_c.sim.render import render_stereo_sequence

FCFG = FrontendConfig(max_features=48)
MCFG = FilterConfig(max_cam_state_size=6, max_tracks=64, max_imu_per_frame=10)


def _setup():
    traj = make_circle_trajectory(duration=3.0)
    lms = make_wall_landmarks(num=300, radius=8.0, seed=1)
    imu = synthesize_imu(traj, gyro_noise=1e-4, acc_noise=1e-3, seed=0)
    idx = np.array([300, 310, 320])
    img0, img1 = render_stereo_sequence(traj, lms, idx, r_wall=8.0)
    return traj, imu, idx, img0, img1


def test_vio_step_batched_matches_single():
    traj, imu, idx, img0, img1 = _setup()
    fparams = make_frontend_params(EUROC_CALIB, jnp.float32)
    mparams = make_params(MCFG, EUROC_CALIB, jnp.float64)
    state = init_vio_state(FCFG, MCFG, EUROC_CALIB, img0.shape[1:], jnp.float32, jnp.float64)

    L = MCFG.max_imu_per_frame
    def mk_imu(k):
        t0 = traj.t[idx[k]]
        return ImuBatch(
            time=jnp.asarray(t0 - 0.05 + np.arange(1, L + 1) * 0.005),
            gyro=jnp.asarray(imu.gyro[idx[k] - L + 1 : idx[k] + 1]),
            acc=jnp.asarray(imu.acc[idx[k] - L + 1 : idx[k] + 1]),
            valid=jnp.ones(L, bool),
        )

    step = jax.jit(
        lambda s, i0, i1, t, b: vio_step(s, i0, i1, t, b, fparams, mparams, FCFG, MCFG, "schur")
    )

    # Single-sequence run of 3 frames.
    s = state
    singles = []
    for k in range(3):
        s, (pose, out) = step(
            s, jnp.asarray(img0[k]), jnp.asarray(img1[k]), jnp.asarray(traj.t[idx[k]]), mk_imu(k)
        )
        singles.append((pose, out))

    # Batched run (B=2, identical inputs) must agree elementwise.
    B = 2
    bstate = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), state)
    bstep = jax.jit(jax.vmap(step, in_axes=(0, None, None, None, None)))
    bs = bstate
    for k in range(3):
        bs, (bpose, bout) = bstep(
            bs, jnp.asarray(img0[k]), jnp.asarray(img1[k]), jnp.asarray(traj.t[idx[k]]), mk_imu(k)
        )
        pose, out = singles[k]
        for b in range(B):
            np.testing.assert_allclose(
                np.asarray(bpose.p[b]), np.asarray(pose.p), atol=1e-12
            )
            np.testing.assert_array_equal(np.asarray(bout.fid[b]), np.asarray(out.fid))

    # Sanity on the single run: tracker found features and filter moved on.
    assert int(singles[-1][1].after_ransac) > 10
    assert int(singles[-1][0].num_cams) == 3
