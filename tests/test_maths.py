"""Unit tests for the quaternion / Lie-group core against closed forms and
scipy.spatial.transform oracles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from msckf_stereo_c.utils import (
    jpl_to_rot,
    quat_identity,
    quat_multiply,
    quat_normalize,
    rot_from_two_vectors,
    rot_to_jpl,
    rotation_angle,
    skew,
    small_angle_quaternion,
    so3_exp,
    so3_log,
)

RNG = np.random.default_rng(0)


def random_rotations(n):
    return Rotation.random(n, random_state=42)


def test_skew():
    v = jnp.array([1.0, 2.0, 3.0])
    w = jnp.array([-0.5, 0.1, 2.0])
    np.testing.assert_allclose(skew(v) @ w, jnp.cross(v, w), atol=1e-12)
    # batched
    vs = jnp.asarray(RNG.normal(size=(7, 3)))
    ws = jnp.asarray(RNG.normal(size=(7, 3)))
    np.testing.assert_allclose(
        jnp.einsum("bij,bj->bi", skew(vs), ws), jnp.cross(vs, ws), atol=1e-12
    )


def test_so3_exp_log_roundtrip():
    phis = RNG.normal(size=(50, 3))
    R = so3_exp(jnp.asarray(phis))
    # against scipy: Rotation.from_rotvec uses the same exp map
    R_ref = Rotation.from_rotvec(phis).as_matrix()
    np.testing.assert_allclose(np.asarray(R), R_ref, atol=1e-12)
    phi_back = so3_log(R)
    np.testing.assert_allclose(np.asarray(phi_back), phis, atol=1e-9)


def test_so3_exp_small_angle():
    phi = jnp.array([1e-12, -2e-12, 1e-13])
    R = so3_exp(phi)
    np.testing.assert_allclose(np.asarray(R), np.eye(3) + np.asarray(skew(phi)), atol=1e-15)
    # gradient must be finite at zero
    g = jax.jacobian(lambda p: so3_exp(p).sum())(jnp.zeros(3))
    assert np.all(np.isfinite(np.asarray(g)))


def test_jpl_quaternion_rotation_consistency():
    """C(q) for JPL [x,y,z,w] equals the transpose of the Hamilton rotation
    matrix of the same components (JPL world->body vs Hamilton body->world)."""
    rots = random_rotations(20)
    q_ham = rots.as_quat()  # scipy: Hamilton [x,y,z,w], R maps body->world
    C = np.asarray(jpl_to_rot(jnp.asarray(q_ham)))
    np.testing.assert_allclose(C, rots.as_matrix().transpose(0, 2, 1), atol=1e-12)


def test_rot_to_jpl_roundtrip():
    rots = random_rotations(200)
    Rm = rots.as_matrix().transpose(0, 2, 1)  # world->body matrices
    q = rot_to_jpl(jnp.asarray(Rm))
    C = jpl_to_rot(q)
    np.testing.assert_allclose(np.asarray(C), Rm, atol=1e-10)


def test_quat_multiply_composition():
    """JPL product: C(q (x) p) = C(q) C(p)."""
    q = quat_normalize(jnp.asarray(RNG.normal(size=(10, 4))))
    p = quat_normalize(jnp.asarray(RNG.normal(size=(10, 4))))
    lhs = jpl_to_rot(quat_multiply(q, p))
    rhs = jnp.einsum("bij,bjk->bik", jpl_to_rot(q), jpl_to_rot(p))
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), atol=1e-12)


def test_quat_identity():
    np.testing.assert_allclose(np.asarray(jpl_to_rot(quat_identity())), np.eye(3), atol=1e-15)


def test_small_angle_quaternion():
    d = jnp.array([1e-3, -2e-3, 0.5e-3])
    q = small_angle_quaternion(d)
    # C(dq) matches exp(-[d]x) to O(|d|^3) (the construction uses
    # sin(theta/2) ~ theta/2, same as the reference implementation).
    np.testing.assert_allclose(
        np.asarray(jpl_to_rot(q)), np.asarray(so3_exp(-d)), atol=1e-8
    )
    # large angle branch keeps unit norm
    big = jnp.array([3.0, -4.0, 5.0])
    np.testing.assert_allclose(float(jnp.linalg.norm(small_angle_quaternion(big))), 1.0, atol=1e-12)


def test_rot_from_two_vectors():
    a = jnp.asarray(RNG.normal(size=(25, 3)))
    b = jnp.asarray(RNG.normal(size=(25, 3)))
    R = rot_from_two_vectors(a, b)
    an = a / jnp.linalg.norm(a, axis=-1, keepdims=True)
    bn = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
    np.testing.assert_allclose(np.asarray(jnp.einsum("bij,bj->bi", R, an)), np.asarray(bn), atol=1e-10)
    # proper rotations
    det = np.linalg.det(np.asarray(R))
    np.testing.assert_allclose(det, np.ones(25), atol=1e-10)


def test_rotation_angle():
    phis = RNG.normal(size=(30, 3))
    R = so3_exp(jnp.asarray(phis))
    expected = np.linalg.norm(phis, axis=-1)
    expected = np.where(expected > np.pi, 2 * np.pi - expected % (2 * np.pi), expected)
    got = np.asarray(rotation_angle(R))
    np.testing.assert_allclose(got, expected, atol=1e-8)


def test_everything_jits():
    f = jax.jit(lambda q, p: quat_multiply(q, p))
    q = quat_normalize(jnp.asarray(RNG.normal(size=4)))
    np.testing.assert_allclose(np.asarray(f(q, q)), np.asarray(quat_multiply(q, q)), atol=1e-12)
