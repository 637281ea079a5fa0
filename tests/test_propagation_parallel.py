"""The log-depth (prefix-scan) IMU propagation must reproduce the
sequential scan exactly (f64, tight tolerance), including masked samples,
non-increasing timestamps, and diverged FEJ shadows."""
import jax
import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig
from msckf_stereo_c.models.propagation import (
    ImuBatch,
    propagate,
    propagate_sequential,
)
from msckf_stereo_c.models.msckf import make_params
from msckf_stereo_c.models.state import init_filter_state


def _random_state(cfg, rng, dtype):
    state = init_filter_state(cfg, EUROC_CALIB, dtype)
    q = rng.normal(size=4)
    q = q / np.linalg.norm(q)
    qn = q + rng.normal(size=4) * 0.01  # diverged FEJ shadow
    qn = qn / np.linalg.norm(qn)
    imu = state.imu._replace(
        q=jnp.asarray(q, dtype),
        v=jnp.asarray(rng.normal(size=3), dtype),
        p=jnp.asarray(rng.normal(size=3), dtype),
        bg=jnp.asarray(rng.normal(size=3) * 0.01, dtype),
        ba=jnp.asarray(rng.normal(size=3) * 0.05, dtype),
        q_null=jnp.asarray(qn, dtype),
        v_null=jnp.asarray(rng.normal(size=3), dtype),
        p_null=jnp.asarray(rng.normal(size=3), dtype),
        time=jnp.asarray(10.0, dtype),
    )
    D = state.P.shape[0]
    A = rng.normal(size=(D, D)) * 0.01
    P = jnp.asarray(A @ A.T + np.eye(D) * 0.1, dtype)
    return state._replace(
        imu=imu, P=P, gravity=jnp.asarray([0.0, 0.0, -9.81], dtype)
    )


def _batch(rng, L, dtype, mask_pattern):
    t = 10.0 + np.cumsum(rng.uniform(0.003, 0.007, L))
    valid = np.ones(L, bool)
    if mask_pattern == "trailing":
        valid[L - 4 :] = False
    elif mask_pattern == "interleaved":
        valid[[2, 5, 9]] = False
    elif mask_pattern == "nonincreasing":
        t[3] = t[2] - 0.001  # sequential scan skips it; valid stays True
    elif mask_pattern == "all_masked":
        valid[:] = False
    return ImuBatch(
        time=jnp.asarray(t, dtype),
        gyro=jnp.asarray(rng.normal(size=(L, 3)) * 0.3, dtype),
        acc=jnp.asarray(rng.normal(size=(L, 3)) + [0, 0, 9.81], dtype),
        valid=jnp.asarray(valid),
    )


def test_parallel_matches_sequential():
    cfg = FilterConfig(max_cam_state_size=8, max_tracks=16, max_imu_per_frame=16)
    params = make_params(cfg, EUROC_CALIB, jnp.float64)
    rng = np.random.default_rng(3)
    for pattern in ("full", "trailing", "interleaved", "nonincreasing", "all_masked"):
        state = _random_state(cfg, rng, jnp.float64)
        batch = _batch(rng, 16, jnp.float64, pattern)
        ref = jax.jit(propagate_sequential)(state, batch, params.Q_imu)
        par = jax.jit(propagate)(state, batch, params.Q_imu)
        for name in ("q", "v", "p", "q_null", "v_null", "p_null", "time"):
            a = np.asarray(getattr(ref.imu, name))
            b = np.asarray(getattr(par.imu, name))
            np.testing.assert_allclose(b, a, rtol=1e-11, atol=1e-11, err_msg=f"{pattern}:{name}")
        np.testing.assert_allclose(
            np.asarray(par.P), np.asarray(ref.P), rtol=1e-9, atol=1e-11,
            err_msg=f"{pattern}:P",
        )


def test_parallel_matches_sequential_f32_zero_gyro():
    """Small-angle branch + dt=0 no-op exactness in the hardware dtype."""
    cfg = FilterConfig(max_cam_state_size=8, max_tracks=16, max_imu_per_frame=12)
    params = make_params(cfg, EUROC_CALIB, jnp.float32)
    rng = np.random.default_rng(4)
    state = _random_state(cfg, rng, jnp.float32)
    t = 10.0 + np.cumsum(rng.uniform(0.003, 0.007, 12))
    batch = ImuBatch(
        time=jnp.asarray(t, jnp.float32),
        gyro=jnp.zeros((12, 3), jnp.float32),  # exercises the small-gyro branch
        acc=jnp.asarray(np.tile([0.1, -0.2, 9.7], (12, 1)), jnp.float32),
        valid=jnp.asarray(np.ones(12, bool)),
    )
    ref = jax.jit(propagate_sequential)(state, batch, params.Q_imu)
    par = jax.jit(propagate)(state, batch, params.Q_imu)
    np.testing.assert_allclose(np.asarray(par.imu.p), np.asarray(ref.imu.p), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np.asarray(par.P), np.asarray(ref.P), rtol=2e-4, atol=2e-6)
