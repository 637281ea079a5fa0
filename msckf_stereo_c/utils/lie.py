"""SO(3)/SE(3) primitives (pure jnp, batch-friendly, jit-safe).

Equivalents of the reference's vikit_cg kinematics helpers
(``skew_symmetric``, ``rodrigues``, ``from_two_vector`` — see
/root/reference/msckf_core/src/msckf_vio.cpp:420,236 and
image_processor.cpp:882 for usage sites).  All branch decisions use
``jnp.where`` so everything vmaps and jits without data-dependent control
flow.
"""
from __future__ import annotations

import jax.numpy as jnp


def skew(v: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix [v]x such that [v]x w = v x w. Batched."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula: axis-angle vector -> rotation matrix (batched).

    Uses the Taylor-safe form A = sin(t)/t, B = (1-cos(t))/t^2 with series
    fallbacks near t=0 so gradients are stable.
    """
    theta_sq = jnp.sum(phi * phi, axis=-1)
    # Guard sqrt's input (not just its output) so gradients stay finite at 0;
    # series fallbacks: A ~ 1 - t^2/6, B ~ 1/2 - t^2/24.
    small = theta_sq < 1e-16
    safe_sq = jnp.where(small, 1.0, theta_sq)
    safe_t = jnp.sqrt(safe_sq)
    A = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(safe_t) / safe_t)
    B = jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(safe_t)) / safe_sq)
    K = skew(phi)
    eye = jnp.eye(3, dtype=phi.dtype)
    return eye + A[..., None, None] * K + B[..., None, None] * (K @ K)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> axis-angle vector (principal branch, batched).

    atan2-based: theta = atan2(|w|/2, (tr-1)/2) with w the skew part, which
    keeps both value AND gradient finite at the identity (the arccos form
    has an infinite derivative at tr=3, poisoning autodiff through
    converged residuals).  Angles near pi (where w -> 0 again) are outside
    this engine's use (inter-keyframe rotations)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    nsq = jnp.sum(w * w, axis=-1)  # = 4 sin^2(theta)
    small = nsq < 1e-24
    s = 0.5 * jnp.sqrt(jnp.where(small, 1.0, nsq))  # sin(theta), guarded
    c = 0.5 * (tr - 1.0)  # cos(theta)
    theta = jnp.arctan2(s, c)
    # generic: theta / (2 sin theta); series: 1/2 + theta^2/12 with
    # theta^2 ~ nsq/4 (gradient-safe polynomial in nsq).
    scale = jnp.where(small, 0.5 + nsq / 48.0, theta / jnp.where(small, 1.0, 2.0 * s))
    return w * scale[..., None]


def rotation_angle(R: jnp.ndarray) -> jnp.ndarray:
    """Angle of the rotation (AngleAxis().angle() equivalent), batched."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return jnp.arccos(jnp.clip(0.5 * (tr - 1.0), -1.0, 1.0))


def rot_from_two_vectors(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix R with R @ normalize(a) = normalize(b).

    Mirrors the reference's ``cg::from_two_vector`` used in gravity
    alignment (msckf_vio.cpp:236).  Implemented via Rodrigues on the
    axis = a x b; stable for nearly-aligned vectors (falls back to identity)
    — antiparallel inputs are not used by the engine.
    """
    an = a / jnp.linalg.norm(a, axis=-1, keepdims=True)
    bn = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
    v = jnp.cross(an, bn)
    c = jnp.sum(an * bn, axis=-1)
    K = skew(v)
    eye = jnp.eye(3, dtype=a.dtype)
    denom = 1.0 + c
    safe = jnp.abs(denom) > 1e-12
    factor = jnp.where(safe, 1.0 / jnp.where(safe, denom, 1.0), 0.0)
    return eye + K + (K @ K) * factor[..., None, None]


def se3_inverse(R: jnp.ndarray, t: jnp.ndarray):
    """Inverse of the transform x -> R x + t, as (R^T, -R^T t). Batched."""
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, t)


def se3_compose(Ra, ta, Rb, tb):
    """Compose transforms: (Ra,ta) then applied after (Rb,tb):
    x -> Ra (Rb x + tb) + ta. Batched."""
    return Ra @ Rb, jnp.einsum("...ij,...j->...i", Ra, tb) + ta
