"""Pyramidal Lucas–Kanade optical flow, batched over features.

Replacement for vikit's ``optical_flow_multi_level`` (called with
patch=15, iters=30 at image_processor.cpp:410,569), with OpenCV
``calcOpticalFlowPyrLK`` + OPTFLOW_USE_INITIAL_FLOW semantics: the caller
seeds ``pts_curr`` (IMU-predicted positions / extrinsics-projected stereo
guesses) and the tracker refines per level from coarse to fine.

This is the reference pure-JAX implementation (gather-based bilinear patch
sampling, vmapped over features; `lax.scan` over iterations).  The
production path is the correlation-surface formulation in ``klt_corr.py``
(whose LK iteration loop is a Triton kernel on the GPU); the GEMM
formulation in ``klt_gemm.py`` is the third cross-checked variant."""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .linalg import solve2x2

_MIN_EIG_THRESHOLD = 1e-4  # OpenCV minEigThreshold default, per-pixel scaled


class KltResult(NamedTuple):
    pts: jnp.ndarray  # (N, 2) refined positions [x, y]
    valid: jnp.ndarray  # (N,) bool tracking success


def _bilinear_patch(img: jnp.ndarray, center_xy: jnp.ndarray, offsets: jnp.ndarray):
    """Sample a patch of ``offsets`` (P,2 [dx,dy]) around center via bilinear
    interpolation.  Out-of-bounds reads clamp (validity handled by caller)."""
    H, W = img.shape
    x = center_xy[0] + offsets[:, 0]
    y = center_xy[1] + offsets[:, 1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    ax = x - x0
    ay = y - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 2)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 2)

    flat = img.reshape(-1)
    idx = y0i * W + x0i
    p00 = jnp.take(flat, idx)
    p01 = jnp.take(flat, idx + 1)
    p10 = jnp.take(flat, idx + W)
    p11 = jnp.take(flat, idx + W + 1)
    return (
        p00 * (1 - ax) * (1 - ay)
        + p01 * ax * (1 - ay)
        + p10 * (1 - ax) * ay
        + p11 * ax * ay
    )


def _patch_offsets(win: int, pad: int = 0, dtype=jnp.float32) -> jnp.ndarray:
    """(P^2, 2) [dx, dy] grid centered on 0, P = win + 2*pad."""
    r = win // 2 + pad
    g = np.arange(-r, r + 1, dtype=np.float64)
    dx, dy = np.meshgrid(g, g)
    return jnp.asarray(np.stack([dx.ravel(), dy.ravel()], axis=1), dtype)


def _track_level(
    img_prev: jnp.ndarray,
    img_curr: jnp.ndarray,
    pt_prev: jnp.ndarray,
    pt_curr0: jnp.ndarray,
    win: int,
    iters: int,
    eps: float,
    final_level: bool,
):
    """Refine one feature at one pyramid level (inverse-compositional LK:
    template gradients fixed, 2x2 normal equations per iteration)."""
    dtype = img_prev.dtype
    H, W = img_prev.shape
    off = _patch_offsets(win, 0, dtype)
    off_g = _patch_offsets(win, 1, dtype)
    P = win

    # Template patch + gradients from the previous image (win+2 super-patch,
    # central differences on its interior).
    sp = _bilinear_patch(img_prev, pt_prev, off_g).reshape(P + 2, P + 2)
    templ = sp[1:-1, 1:-1].reshape(-1)
    gx = 0.5 * (sp[1:-1, 2:] - sp[1:-1, :-2]).reshape(-1)
    gy = 0.5 * (sp[2:, 1:-1] - sp[:-2, 1:-1]).reshape(-1)

    G = jnp.array(
        [
            [jnp.sum(gx * gx), jnp.sum(gx * gy)],
            [jnp.sum(gx * gy), jnp.sum(gy * gy)],
        ],
        dtype,
    )
    # Min eigenvalue of the 2x2 gradient matrix, normalized per pixel.
    tr = G[0, 0] + G[1, 1]
    det = G[0, 0] * G[1, 1] - G[0, 1] * G[1, 0]
    disc = jnp.sqrt(jnp.maximum(0.25 * tr * tr - det, 0.0))
    min_eig = (0.5 * tr - disc) / (P * P)
    good = min_eig > _MIN_EIG_THRESHOLD

    def body(carry, _):
        pt, converged = carry
        patch = _bilinear_patch(img_curr, pt, off)
        dI = templ - patch
        b = jnp.array([jnp.sum(dI * gx), jnp.sum(dI * gy)], dtype)
        delta = solve2x2(G, b)
        new_pt = pt + delta
        now_conv = jnp.linalg.norm(delta) < eps
        pt = jnp.where(converged, pt, new_pt)
        return (pt, converged | now_conv), None

    (pt, _), _ = jax.lax.scan(body, (pt_curr0, ~good), None, length=iters)

    if not final_level:
        # Coarse levels only refine the guess; rejection happens at level 0
        # (OpenCV semantics — a weak-gradient or near-border coarse level
        # keeps the current estimate and the finer levels decide).
        return pt, jnp.ones((), bool)

    r = win // 2 + 1
    inb = (pt[0] >= r) & (pt[0] < W - r) & (pt[1] >= r) & (pt[1] < H - r)
    # Template center must also be inside the previous image.
    inb = inb & (pt_prev[0] >= r) & (pt_prev[0] < W - r) & (pt_prev[1] >= r) & (pt_prev[1] < H - r)
    return pt, good & inb


_track_level_batch = jax.vmap(_track_level, in_axes=(None, None, 0, 0, None, None, None, None))


def optical_flow_pyr_lk(
    pyr_prev: Sequence[jnp.ndarray],
    pyr_curr: Sequence[jnp.ndarray],
    pts_prev: jnp.ndarray,  # (N, 2) positions in level-0 pixels
    pts_curr_init: jnp.ndarray,  # (N, 2) initial guesses (level-0 pixels)
    valid_in: jnp.ndarray,  # (N,) bool
    win: int = 15,
    iters: int = 30,
    eps: float = 0.01,
) -> KltResult:
    """Track points through the pyramid, coarse to fine (vikit
    ``optical_flow_multi_level`` semantics, initial flow used at the
    coarsest level)."""
    L = len(pyr_prev)
    scale = 2.0 ** (L - 1)
    pts = pts_curr_init / scale
    valid = valid_in

    for lvl in range(L - 1, -1, -1):
        s = 2.0**lvl
        prev_l = pyr_prev[lvl]
        curr_l = pyr_curr[lvl]
        pts, ok = _track_level_batch(
            prev_l, curr_l, pts_prev / s, pts, win, iters, eps, lvl == 0
        )
        valid = valid & ok
        if lvl > 0:
            pts = pts * 2.0

    return KltResult(pts=pts, valid=valid)
