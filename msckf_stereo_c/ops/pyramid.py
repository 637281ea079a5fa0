"""Gaussian image pyramids (vikit ``pyr_down`` equivalent, used by the
reference at image_processor.cpp:213-245).

OpenCV-compatible pyrDown: separable 5-tap Gaussian [1,4,6,4,1]/16 with
REFLECT_101 borders, then factor-2 decimation; output size (n+1)//2.

The blur+decimate pair along each axis IS a banded matrix, so the op is
expressed as two dense GEMMs, ``D_h @ img @ D_w^T``: O(H^2 W) work for an
O(HW) filter, chosen for a matrix unit.  Not yet measured against a
strided convolution on the GPU (ROADMAP)."""
from __future__ import annotations

from functools import lru_cache
from typing import List

import jax.numpy as jnp
import numpy as np
from jax import lax

_KERNEL = jnp.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


@lru_cache(maxsize=None)
def _decim_matrix(n_in: int) -> np.ndarray:
    """((n_in+1)//2, n_in) banded matrix: row i applies the 5-tap kernel at
    2i with REFLECT_101 borders (exactly OpenCV pyrDown's 1-D factor)."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    n_out = (n_in + 1) // 2
    D = np.zeros((n_out, n_in))
    for i in range(n_out):
        for t in range(5):
            j = 2 * i + t - 2
            if j < 0:
                j = -j
            if j >= n_in:
                j = 2 * n_in - 2 - j
            D[i, j] += k[t]
    return D.astype(np.float32)


def _reflect101_pad(img: jnp.ndarray, pad: int, axis: int) -> jnp.ndarray:
    """OpenCV BORDER_REFLECT_101: edge pixel not repeated (gfedcb|abcdefgh)."""
    n = img.shape[axis]
    head = lax.slice_in_dim(img, 1, pad + 1, axis=axis)
    head = jnp.flip(head, axis=axis)
    tail = lax.slice_in_dim(img, n - pad - 1, n - 1, axis=axis)
    tail = jnp.flip(tail, axis=axis)
    return jnp.concatenate([head, img, tail], axis=axis)


def pyr_down(img: jnp.ndarray) -> jnp.ndarray:
    """One pyramid level down. img: (..., H, W) float; returns
    (..., (H+1)//2, (W+1)//2) via two dense decimation GEMMs."""
    H = img.shape[-2]
    W = img.shape[-1]
    Dh = jnp.asarray(_decim_matrix(H), img.dtype)
    Dw = jnp.asarray(_decim_matrix(W), img.dtype)
    return jnp.einsum(
        "oi,...ij,pj->...op", Dh, img, Dw, preferred_element_type=jnp.float32
    ).astype(img.dtype)


@lru_cache(maxsize=None)
def _smooth_matrix(n: int) -> np.ndarray:
    """(n, n) banded matrix applying the 5-tap kernel at every position
    (no decimation), REFLECT_101 borders."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    S = np.zeros((n, n))
    for i in range(n):
        for t in range(5):
            j = i + t - 2
            if j < 0:
                j = -j
            if j >= n:
                j = 2 * n - 2 - j
            S[i, j] += k[t]
    return S.astype(np.float32)


def smooth5(img: jnp.ndarray) -> jnp.ndarray:
    """Separable 5-tap binomial blur (sigma ~1 px, no decimation) — the
    tracker's sensor-noise prefilter (FrontendConfig.presmooth).  Cuts
    per-pixel noise ~3.7x (sqrt(sum k^2)^2 = 0.27) while the symmetric
    kernel leaves sub-pixel geometry unbiased.  Dense GEMMs like pyr_down
    (dense GEMMs over the banded structure)."""
    H = img.shape[-2]
    W = img.shape[-1]
    Sh = jnp.asarray(_smooth_matrix(H), img.dtype)
    Sw = jnp.asarray(_smooth_matrix(W), img.dtype)
    return jnp.einsum(
        "oi,...ij,pj->...op", Sh, img, Sw, preferred_element_type=jnp.float32
    ).astype(img.dtype)


def build_pyramid(img: jnp.ndarray, levels: int = 4) -> List[jnp.ndarray]:
    """Level-0 is the input image (reference createImagePyramids hardcodes
    4 levels, image_processor.cpp:232)."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr
