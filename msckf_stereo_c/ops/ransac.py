"""Two-point translation RANSAC for temporal outlier rejection.

Re-design of the reference's ``twoPointRansac``
(image_processor.cpp:911-1135; its call sites are commented out at
:482-493, so the frontend flag ``ransac_enabled`` defaults to off for
behavioral parity — the model ships because the reference ships it).

Model: with the IMU rotation compensated, the epipolar constraint reduces
to ``coeff_i . t = 0`` with ``coeff_i = [dy_i, -dx_i, x1 y2 - y1 x2]``; two
point pairs determine the translation direction.  Instead of the
reference's sequential hypothesize-verify loop, ALL hypotheses are drawn
up front and scored in one batched shot (hypotheses x points), then the
best (largest inlier set, reference selection rule) wins — no
data-dependent iteration."""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .camera import undistort_points
from .linalg import solve2x2

_NUM_HYPOTHESES = 16  # >= ceil(log(1-0.99)/log(1-0.49)) = 7; extra is free


def two_point_ransac(
    pts1: jnp.ndarray,  # (N, 2) previous-frame pixels
    pts2: jnp.ndarray,  # (N, 2) current-frame pixels
    valid: jnp.ndarray,  # (N,)
    R_p_c: jnp.ndarray,  # (3,3) rotation previous -> current cam frame
    intrinsics: jnp.ndarray,
    dist: jnp.ndarray,
    key: jnp.ndarray,
    model: str = "radtan",
    inlier_error: float = 3.0,
) -> jnp.ndarray:
    """Returns the refined inlier mask (subset of ``valid``)."""
    dtype = pts1.dtype
    N = pts1.shape[0]

    npu = 2.0 / (intrinsics[0] + intrinsics[1])

    p1 = undistort_points(pts1, intrinsics, dist, model=model)
    p2 = undistort_points(pts2, intrinsics, dist, model=model)
    # Rotation compensation (homogeneous, no re-normalization — reference
    # keeps pt_hc[0], pt_hc[1] verbatim).
    p1h = jnp.concatenate([p1, jnp.ones_like(p1[:, :1])], axis=1)
    p1r = (p1h @ R_p_c.T)[:, :2]

    # Scale normalization over the valid points (rescalePoints).
    vf = valid.astype(dtype)
    norms = jnp.linalg.norm(p1r, axis=1) + jnp.linalg.norm(p2, axis=1)
    n_valid = jnp.maximum(jnp.sum(vf), 1.0)
    sf = (2.0 * n_valid) / jnp.maximum(jnp.sum(norms * vf), 1e-12) * jnp.sqrt(2.0)
    p1s = p1r * sf
    p2s = p2 * sf
    npu = npu * sf

    diff = p1s - p2s
    dist_pt = jnp.linalg.norm(diff, axis=1)
    raw = valid & (dist_pt <= 50.0 * npu)
    raw_cnt = jnp.sum(raw)
    mean_dist = jnp.sum(jnp.where(raw, dist_pt, 0.0)) / jnp.maximum(
        raw_cnt.astype(dtype), 1.0
    )

    # Epipolar coefficients.
    coeff = jnp.stack(
        [
            diff[:, 1],
            -diff[:, 0],
            p1s[:, 0] * p2s[:, 1] - p1s[:, 1] * p2s[:, 0],
        ],
        axis=1,
    )  # (N, 3)

    # --- Batched hypotheses: sample index pairs among raw inliers. ---
    H = _NUM_HYPOTHESES
    # Rank-based sampling that only lands on raw inliers (reference's
    # offset trick, vectorized): order raw-first, draw within the count.
    order = jnp.argsort(~raw)
    k1, k2 = jax.random.split(key)
    u1 = jax.random.randint(k1, (H,), 0, 1 << 30) % jnp.maximum(raw_cnt, 1)
    du = 1 + jax.random.randint(k2, (H,), 0, 1 << 30) % jnp.maximum(raw_cnt - 1, 1)
    u2 = (u1 + du) % jnp.maximum(raw_cnt, 1)
    i1 = order[u1]
    i2 = order[u2]

    c1 = coeff[i1]  # (H, 3)
    c2 = coeff[i2]
    # Pick the base column with the smallest l1 norm; solve for the other 2.
    l1 = jnp.abs(c1) + jnp.abs(c2)  # (H, 3)
    base = jnp.argmin(l1, axis=1)  # (H,)

    def solve_for(base_col, a_col, b_col):
        A = jnp.stack([c1[:, a_col], c1[:, b_col]], axis=1)
        A = jnp.stack([A, jnp.stack([c2[:, a_col], c2[:, b_col]], axis=1)], axis=1)
        b = -jnp.stack([c1[:, base_col], c2[:, base_col]], axis=1)
        return solve2x2(A, b)  # (H, 2)

    s0 = solve_for(0, 1, 2)
    s1 = solve_for(1, 0, 2)
    s2 = solve_for(2, 0, 1)
    one = jnp.ones((H,), dtype)
    m0 = jnp.stack([one, s0[:, 0], s0[:, 1]], axis=1)
    m1 = jnp.stack([s1[:, 0], one, s1[:, 1]], axis=1)
    m2 = jnp.stack([s2[:, 0], s2[:, 1], one], axis=1)
    models = jnp.where(
        (base == 0)[:, None], m0, jnp.where((base == 1)[:, None], m1, m2)
    )  # (H, 3)

    err = jnp.abs(coeff @ models.T)  # (N, H)
    inl = raw[:, None] & (err < inlier_error * npu)  # (N, H)
    counts = jnp.sum(inl, axis=0)  # (H,)
    ok_h = counts >= 0.2 * N
    counts = jnp.where(ok_h, counts, 0)
    best = jnp.argmax(counts)
    ransac_mask = inl[:, best] & (counts[best] > 0)

    # Degenerate motion: no translation — fall back to a distance gate
    # (reference msckf-style early-out).
    degen_mask = raw & (dist_pt <= inlier_error * npu)

    out = jnp.where(mean_dist < npu, degen_mask, ransac_mask)
    # Too few raw inliers: everything out.
    return jnp.where(raw_cnt < 3, jnp.zeros_like(out), out)
