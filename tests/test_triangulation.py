"""Triangulation unit tests against known geometry."""
import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.models.triangulation import triangulate_track, triangulate_tracks
from msckf_stereo_c.utils.quaternion import rot_to_jpl

RNG = np.random.default_rng(7)

# Simple stereo rig: cam1 10 cm to the right of cam0 (p_c1 = p_c0 - (0.1,0,0)).
R01 = jnp.eye(3, dtype=jnp.float64)
T01 = jnp.asarray([-0.1, 0.0, 0.0], jnp.float64)


def _camera_ring(M=6, radius=2.0):
    """Cameras on an arc looking at the origin region."""
    qs, ps = [], []
    for i in range(M):
        a = 0.3 * i
        p = np.array([radius * np.sin(a), 0.3 * i * 0.1, -radius * np.cos(a)])
        # world->cam rotation: look along +z toward scene center-ish; use
        # small yaw so views differ.
        c, s = np.cos(0.1 * i), np.sin(0.1 * i)
        R = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        qs.append(np.asarray(rot_to_jpl(jnp.asarray(R))))
        ps.append(p)
    return jnp.asarray(qs), jnp.asarray(ps)


def _observe(p_w, cam_q, cam_p):
    from msckf_stereo_c.utils.quaternion import jpl_to_rot

    R_w_c0 = jpl_to_rot(cam_q)
    p_c0 = jnp.einsum("mij,mj->mi", R_w_c0, p_w[None] - cam_p)
    p_c1 = jnp.einsum("ij,mj->mi", R01, p_c0) + T01
    uv0 = p_c0[:, :2] / p_c0[:, 2:3]
    uv1 = p_c1[:, :2] / p_c1[:, 2:3]
    return jnp.concatenate([uv0, uv1], axis=1)


def test_triangulate_perfect():
    cam_q, cam_p = _camera_ring()
    p_true = jnp.asarray([0.5, 0.3, 1.5])
    obs = _observe(p_true, cam_q, cam_p)
    valid = jnp.ones(6, bool)
    res = triangulate_track(obs, valid, cam_q, cam_p, R01, T01)
    assert bool(res.valid)
    np.testing.assert_allclose(np.asarray(res.pos_w), np.asarray(p_true), atol=1e-5)


def test_triangulate_masked_observations():
    cam_q, cam_p = _camera_ring()
    p_true = jnp.asarray([0.2, -0.4, 1.2])
    obs = _observe(p_true, cam_q, cam_p)
    # Only slots 1, 3, 4 observe.
    valid = jnp.asarray([False, True, False, True, True, False])
    obs = obs * valid[:, None]
    res = triangulate_track(obs, valid, cam_q, cam_p, R01, T01)
    assert bool(res.valid)
    assert int(res.base_slot) == 1
    np.testing.assert_allclose(np.asarray(res.pos_w), np.asarray(p_true), atol=1e-5)


def _depths(p_w, cam_q, cam_p):
    from msckf_stereo_c.utils.quaternion import jpl_to_rot

    R_w_c0 = jpl_to_rot(cam_q)
    p_c0 = jnp.einsum("mij,mj->mi", R_w_c0, p_w[None] - cam_p)
    return p_c0[:, 2]


def test_triangulate_noisy_batch():
    cam_q, cam_p = _camera_ring()
    cands = jnp.asarray(RNG.uniform(-0.5, 0.5, (50, 3)) + np.array([0, 0, 1.5]))
    # Keep only points genuinely in front of every camera (the cheirality
    # gate must reject the others — that is separately tested below).
    vis = np.array([bool(jnp.all(_depths(p, cam_q, cam_p) > 0.3)) for p in cands])
    pts = cands[np.flatnonzero(vis)[:10]]
    obs = jnp.stack([_observe(p, cam_q, cam_p) for p in pts])
    obs = obs + 1e-4 * jnp.asarray(RNG.standard_normal(obs.shape))
    valid = jnp.ones((10, 6), bool)
    res = triangulate_tracks(obs, valid, cam_q, cam_p, R01, T01)
    assert bool(jnp.all(res.valid))
    err = np.linalg.norm(np.asarray(res.pos_w) - np.asarray(pts), axis=1)
    assert err.max() < 5e-3, err


def test_triangulate_behind_camera_invalid():
    cam_q, cam_p = _camera_ring()
    # A point behind the cameras produces an invalid (cheirality) solution.
    p_bad = jnp.asarray([0.0, 0.0, -5.0])
    # Fabricate observations from a *different* geometry so LM converges
    # somewhere behind at least one camera: use reversed rays.
    obs = -_observe(jnp.asarray([0.0, 0.0, 2.0]), cam_q, cam_p)
    valid = jnp.ones(6, bool)
    res = triangulate_track(obs, valid, cam_q, cam_p, R01, T01)
    # Either LM fails the cheirality gate or lands on a genuinely valid
    # geometric interpretation; with mirrored rays it must fail.
    assert not bool(res.valid)
