"""Small-matrix linear algebra helpers.

XLA expands generic ``linalg.solve`` into an LU decomposition that is far
slower than closed forms for tiny systems.  The LM triangulation and KLT kernels only ever solve 2x2 / 3x3
SPD systems, so closed-form adjugate solves are both faster and fully
batched/vmappable."""
from __future__ import annotations

import jax.numpy as jnp


def solve3x3(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Closed-form solve of A x = b for 3x3 A (batched over leading dims).

    Uses the adjugate; the caller is responsible for A being reasonably
    conditioned (the LM damping term guarantees this in triangulation)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]

    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10

    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)

    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) * inv_det
    x1 = (c10 * b0 + c11 * b1 + c12 * b2) * inv_det
    x2 = (c20 * b0 + c21 * b1 + c22 * b2) * inv_det
    return jnp.stack([x0, x1, x2], axis=-1)


def inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of 3x3 matrices (batched over leading dims)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]

    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10

    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = (1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1e-30))[..., None, None]
    adj = jnp.stack(
        [
            jnp.stack([c00, c01, c02], axis=-1),
            jnp.stack([c10, c11, c12], axis=-1),
            jnp.stack([c20, c21, c22], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det


def ns_posdef_inverse(M: jnp.ndarray, min_eig, iters: int = 14) -> jnp.ndarray:
    """Inverse of a matrix with real positive spectrum via scaled
    Newton–Schulz iteration — pure batched matmuls, no factorization.

    Where XLA lowers Cholesky / triangular solves to column-sequential
    loops (~n small ops each), they dominate the filter's frame time even
    though their FLOPs are negligible.  This replaces them with
    ``2*iters`` batched matmuls.

    Applicable when the spectrum of ``M`` is real and ``>= min_eig > 0``:
    SPD matrices (gating systems ``sigma2 I + H P H^T``) and PSD products
    shifted by a known floor (``sigma2 I + N P`` with N, P PSD — similar to
    a PSD matrix, eigenvalues >= sigma2).

    Scaled iteration: with ``X0 = I/c`` (``c >= rho(M)`` from the row-sum
    norm) the spectrum of ``X M`` lies in ``[m, 1]``; each step pre-scales by
    ``2/(1+m)`` then applies ``X <- X (2I - M X)``, mapping the bound to
    ``m <- 4m/(1+m)^2`` (quadrupling small ``m`` — half the iterations of
    plain Newton–Schulz, then quadratic once ``m ~ 1``).  14 iterations
    cover ``c/min_eig`` up to ~1e7, beyond f32 solve accuracy anyway.

    ``min_eig`` may be a scalar or a batched array matching ``M``'s batch
    dims.  Batched over any leading dims."""
    n = M.shape[-1]
    dtype = M.dtype
    eye = jnp.eye(n, dtype=dtype)
    c = jnp.max(jnp.sum(jnp.abs(M), axis=-1), axis=-1)  # (...,) >= rho(M)
    c = jnp.maximum(c, jnp.asarray(min_eig, dtype))
    m = jnp.asarray(min_eig, dtype) / c  # (...,) lower bound of spec(X0 M)
    X = eye * (1.0 / c)[..., None, None]
    for _ in range(iters):
        s = 2.0 / (1.0 + m)
        X = X * s[..., None, None]
        T = M @ X
        X = 2.0 * X - X @ T
        sm = s * m
        m = sm * (2.0 - sm)
    return X


def solve2x2(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Closed-form solve for 2x2 systems (batched). Used by the KLT kernel."""
    a, bb = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = a * d - bb * c
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
    x0 = (d * b[..., 0] - bb * b[..., 1]) * inv_det
    x1 = (-c * b[..., 0] + a * b[..., 1]) * inv_det
    return jnp.stack([x0, x1], axis=-1)
