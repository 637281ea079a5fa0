"""Pyramidal Lucas–Kanade as batched GEMMs.

The gather-based KLT (``klt.py``) bilinearly samples the moving patch with
4 gathers per pixel per iteration.  This implementation extracts one ``S x S`` *search patch* per feature per level
up front (the only gather-like step, done once), and then expresses every
bilinear resampling inside the iteration loop as a separable pair of
interpolation matrices with tent-function weights:

    sampled(15x15) = W_y(fy) @ search(SxS) @ W_x(fx)^T

so the 30 LK iterations are nothing but small batched matmuls + 2x2 solves
with no data-dependent memory access.  Numerics match
``klt.py`` exactly (same inverse-compositional scheme, same template
gradients, same convergence test); equivalence is asserted in tests.

The search radius bounds how far an iterate may move from its initial guess
per level (clamped); the IMU-seeded guesses the frontend provides keep real
corrections well inside it (reference seeds the same way,
image_processor.cpp:394-410,542-548).
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from .klt import KltResult, _MIN_EIG_THRESHOLD
from .linalg import solve2x2

# Search radius beyond the window per level.  Radius 5 was measured
# throughput-neutral but broke the fast-motion ATE gate (level-1 residual
# corrections exceed 5 px when un-modeled translation is large); 9 keeps
# the reference-like basin with no measured cost.
_SEARCH_RADIUS = 9
# Compute dtype for the resampling GEMMs ("float32" or "bfloat16"): bf16
# halves the operand bytes; sampling error ~0.4% of dynamic range,
# accumulation in f32 (preferred_element_type).  Accuracy impact is validated by the e2e
# ATE gates before flipping the default (MSCKF_KLT_BF16=1 opts in).
import os as _os

_COMPUTE_DTYPE = (
    jnp.bfloat16 if _os.environ.get("MSCKF_KLT_BF16", "0") == "1" else jnp.float32
)


def _sample(Wy, patch, Wx):
    """sampled = Wy @ patch @ Wx^T with the configured compute dtype."""
    c = _COMPUTE_DTYPE
    out = jnp.einsum(
        "nij,njk,nlk->nil",
        Wy.astype(c), patch.astype(c), Wx.astype(c),
        preferred_element_type=jnp.float32,
    )
    return out.astype(patch.dtype)


def _tent_weights(frac_origin: jnp.ndarray, out_size: int, in_size: int, dtype):
    """(out_size, in_size) matrix W with W[i, j] = tent(j - (frac_origin + i)):
    selecting rows [frac_origin, frac_origin + out_size) of a length-in_size
    signal by linear interpolation.  Batched over leading dims of
    ``frac_origin``."""
    i = jax.lax.broadcasted_iota(jnp.int32, (out_size, in_size), 0).astype(dtype)
    j = jax.lax.broadcasted_iota(jnp.int32, (out_size, in_size), 1).astype(dtype)
    d = j - (frac_origin[..., None, None] + i)
    return jnp.maximum(0.0, 1.0 - jnp.abs(d))


def _extract_patches(img: jnp.ndarray, centers: jnp.ndarray, S: int):
    """(N, S, S) patches whose integer origin is centers - S//2 clamped to the
    image; returns (patches, origins)."""
    H, W = img.shape
    org = jnp.floor(centers) - (S // 2)
    org = jnp.clip(org, 0, jnp.array([W - S, H - S], img.dtype))
    org_i = org.astype(jnp.int32)

    def one(o):
        return jax.lax.dynamic_slice(img, (o[1], o[0]), (S, S))

    return jax.vmap(one)(org_i), org


def _track_level_gemm(img_prev, img_curr, pts_prev, pts_curr0, win, iters, eps, final_level):
    """One pyramid level for all N features (batched)."""
    dtype = img_prev.dtype
    H, W = img_prev.shape
    P = win
    # Clamp the search patch to the level size (tiny coarse levels).
    S = min(win + 2 * _SEARCH_RADIUS + 2, H, W)

    # --- Template (+gradient) from the previous image: (P+2)^2 super-patch.
    # The (P+2) interpolated rows start at fractional offset frac + T//2 - 8
    # inside the raw patch; the last bilinear pair needs index up to
    # T//2 + 9, so T - T//2 >= 10 -> T = P + 4.
    T = P + 4
    if S < P + 2 or min(H, W) < T:
        # Level too small to track; pass the guess through.
        return pts_curr0, jnp.ones(pts_curr0.shape[0], bool)
    tpatch, torg = _extract_patches(img_prev, pts_prev, T)
    # The (P+2)-window is centered: its first sample sits at pts - (P+2-1)/2.
    first = pts_prev - (P + 1) / 2.0 - torg  # fractional origin inside tpatch
    Wy_t = _tent_weights(first[:, 1], P + 2, T, dtype)
    Wx_t = _tent_weights(first[:, 0], P + 2, T, dtype)
    sp = _sample(Wy_t, tpatch, Wx_t)  # (N, P+2, P+2)
    templ = sp[:, 1:-1, 1:-1].reshape(-1, P * P)
    gx = 0.5 * (sp[:, 1:-1, 2:] - sp[:, 1:-1, :-2]).reshape(-1, P * P)
    gy = 0.5 * (sp[:, 2:, 1:-1] - sp[:, :-2, 1:-1]).reshape(-1, P * P)

    G = jnp.stack(
        [
            jnp.stack([jnp.sum(gx * gx, -1), jnp.sum(gx * gy, -1)], -1),
            jnp.stack([jnp.sum(gx * gy, -1), jnp.sum(gy * gy, -1)], -1),
        ],
        -2,
    )  # (N, 2, 2)
    tr = G[:, 0, 0] + G[:, 1, 1]
    det = G[:, 0, 0] * G[:, 1, 1] - G[:, 0, 1] * G[:, 1, 0]
    disc = jnp.sqrt(jnp.maximum(0.25 * tr * tr - det, 0.0))
    min_eig = (0.5 * tr - disc) / (P * P)
    good = min_eig > _MIN_EIG_THRESHOLD

    # --- Search patch from the current image around the initial guess.
    spatch, sorg = _extract_patches(img_curr, pts_curr0, S)

    lo = jnp.asarray(0.0, dtype)
    hi = jnp.asarray(S - P - 1.0, dtype)

    def cond(carry):
        _, converged, it = carry
        return (it < iters) & ~jnp.all(converged)

    def body(carry):
        pts, converged, it = carry
        first = pts - (P - 1) / 2.0 - sorg  # fractional window origin in patch
        fx = jnp.clip(first[:, 0], lo, hi)
        fy = jnp.clip(first[:, 1], lo, hi)
        Wy = _tent_weights(fy, P, S, dtype)
        Wx = _tent_weights(fx, P, S, dtype)
        patch = _sample(Wy, spatch, Wx).reshape(-1, P * P)
        dI = templ - patch
        b = jnp.stack([jnp.sum(dI * gx, -1), jnp.sum(dI * gy, -1)], -1)
        delta = solve2x2(G, b)
        new_pts = pts + delta
        # Stay inside the search patch (repeatability with the gather path is
        # asserted for displacements within the radius).
        new_first = new_pts - (P - 1) / 2.0 - sorg
        new_pts = new_pts + jnp.stack(
            [
                jnp.clip(new_first[:, 0], lo, hi) - new_first[:, 0],
                jnp.clip(new_first[:, 1], lo, hi) - new_first[:, 1],
            ],
            -1,
        )
        now_conv = jnp.linalg.norm(delta, axis=-1) < eps
        pts = jnp.where(converged[:, None], pts, new_pts)
        return (pts, converged | now_conv, it + 1)

    # Early-exit loop: typical tracks converge in <10 iterations; the whole
    # batch stops as soon as every feature has (the fixed-length scan paid
    # for 30 always).
    pts, _, _ = jax.lax.while_loop(
        cond, body, (pts_curr0, ~good, jnp.zeros((), jnp.int32))
    )

    if not final_level:
        return pts, jnp.ones(pts.shape[0], bool)

    r = win // 2 + 1
    inb = (pts[:, 0] >= r) & (pts[:, 0] < W - r) & (pts[:, 1] >= r) & (pts[:, 1] < H - r)
    inb = inb & (pts_prev[:, 0] >= r) & (pts_prev[:, 0] < W - r)
    inb = inb & (pts_prev[:, 1] >= r) & (pts_prev[:, 1] < H - r)
    return pts, good & inb


def optical_flow_pyr_lk_gemm(
    pyr_prev: Sequence[jnp.ndarray],
    pyr_curr: Sequence[jnp.ndarray],
    pts_prev: jnp.ndarray,
    pts_curr_init: jnp.ndarray,
    valid_in: jnp.ndarray,
    win: int = 15,
    iters: int = 30,
    eps: float = 0.01,
) -> KltResult:
    """Drop-in replacement for klt.optical_flow_pyr_lk (same semantics)."""
    L = len(pyr_prev)
    scale = 2.0 ** (L - 1)
    pts = pts_curr_init / scale
    valid = valid_in

    for lvl in range(L - 1, -1, -1):
        s = 2.0**lvl
        pts, ok = _track_level_gemm(
            pyr_prev[lvl], pyr_curr[lvl], pts_prev / s, pts, win, iters, eps, lvl == 0
        )
        valid = valid & ok
        if lvl > 0:
            pts = pts * 2.0

    return KltResult(pts=pts, valid=valid)
