"""FAST-9/16 corner detection, dense and branch-free.

Replacement for vikit's ``CornerDetector`` (occupancy-grid FAST,
constructed as CornerDetector(30, 47, threshold) at image_processor.cpp:132):
instead of per-pixel scalar loops, the segment test runs on a stack of 16
shifted copies of the image (pure VPU element-wise work), the contiguous-arc
test uses a log-step rolling AND, and per-cell best-corner selection is a
reshape + argmax.  Occupied cells (existing features) are masked exactly like
``set_grid_position`` (image_processor.cpp:647)."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3 (OpenCV order), (dy, dx).
_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)
_ARC = 9  # FAST-9


def fast_score_map(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Dense FAST-9 response map; zero where the segment test fails.

    Score = sum of |I(circle) - I(p)| over circle pixels exceeding the
    threshold (the common FAST ranking score).  A 3-pixel border is zeroed.
    img: (H, W) float."""
    H, W = img.shape
    dtype = img.dtype

    # 16 shifted views via pad + static slices: XLA fuses these into the
    # elementwise consumer (jnp.roll would materialize 16 image copies).
    padded = jnp.pad(img, 3)
    shifted = jnp.stack(
        [padded[3 + int(dy) : 3 + int(dy) + H, 3 + int(dx) : 3 + int(dx) + W] for dy, dx in _CIRCLE]
    )  # (16, H, W)

    diff = shifted - img[None]
    brighter = diff > threshold
    darker = diff < -threshold

    def has_arc(mask):
        # Contiguous circular run >= 9 via log-step AND of rolls:
        # run>=2, >=4, >=8 then one extra AND with roll-8 for >=9.
        m = mask
        m = m & jnp.roll(mask, -1, axis=0)   # >=2
        m = m & jnp.roll(m, -2, axis=0)      # >=4
        m = m & jnp.roll(m, -4, axis=0)      # >=8
        m = m & jnp.roll(mask, -8, axis=0)   # >=9
        return jnp.any(m, axis=0)

    is_corner = has_arc(brighter) | has_arc(darker)

    score = jnp.sum(jnp.where(brighter | darker, jnp.abs(diff), jnp.zeros((), dtype)), axis=0)
    score = jnp.where(is_corner, score, jnp.zeros((), dtype))

    # Zero the 3-px border (shift wrap-around region).
    ys = jnp.arange(H)
    xs = jnp.arange(W)
    border = (ys[:, None] < 3) | (ys[:, None] >= H - 3) | (xs[None, :] < 3) | (xs[None, :] >= W - 3)
    return jnp.where(border, jnp.zeros((), dtype), score)


class CellCorners(NamedTuple):
    """Per-detector-cell best corners."""

    xy: jnp.ndarray  # (C, 2) float [x, y] pixel coordinates
    score: jnp.ndarray  # (C,)
    valid: jnp.ndarray  # (C,) bool


def detect_grid_corners(
    img: jnp.ndarray,
    threshold: float,
    cell: int = 16,
    occupied: jnp.ndarray | None = None,
) -> CellCorners:
    """Best FAST corner per cell x cell tile (the vikit detector's
    occupancy-grid behaviour: ~16 px cells for 752x480 = 30 x 47 grid).

    ``occupied``: optional (Gy, Gx) bool mask of cells to suppress (cells
    holding an already-tracked feature, see addNewFeatures
    image_processor.cpp:632-649)."""
    H, W = img.shape
    Gy, Gx = H // cell, W // cell
    score = fast_score_map(img, threshold)
    tiles = score[: Gy * cell, : Gx * cell].reshape(Gy, cell, Gx, cell)
    tiles = tiles.transpose(0, 2, 1, 3).reshape(Gy, Gx, cell * cell)

    best = jnp.argmax(tiles, axis=-1)  # (Gy, Gx)
    best_score = jnp.take_along_axis(tiles, best[..., None], axis=-1)[..., 0]

    dy = best // cell
    dx = best % cell
    ys = jnp.arange(Gy)[:, None] * cell + dy
    xs = jnp.arange(Gx)[None, :] * cell + dx

    valid = best_score > 0
    if occupied is not None:
        valid = valid & ~occupied

    xy = jnp.stack([xs, ys], axis=-1).reshape(Gy * Gx, 2).astype(img.dtype)
    return CellCorners(
        xy=xy, score=best_score.reshape(-1), valid=valid.reshape(-1)
    )


def occupancy_from_points(
    pts_xy: jnp.ndarray, valid: jnp.ndarray, shape: Tuple[int, int], cell: int = 16
) -> jnp.ndarray:
    """(Gy, Gx) bool mask of detector cells containing a valid point."""
    H, W = shape
    Gy, Gx = H // cell, W // cell
    cy = jnp.clip((pts_xy[:, 1] // cell).astype(jnp.int32), 0, Gy - 1)
    cx = jnp.clip((pts_xy[:, 0] // cell).astype(jnp.int32), 0, Gx - 1)
    occ = jnp.zeros((Gy, Gx), bool)
    return occ.at[cy, cx].max(valid, mode="drop")
