"""The GEMM-resampling KLT must reproduce the gather-based KLT exactly
(same scheme, different sampling machinery)."""
import cv2
import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.ops.klt import optical_flow_pyr_lk
from msckf_stereo_c.ops.klt_gemm import optical_flow_pyr_lk_gemm


def _test_image(H=240, W=320, n_blobs=70, seed=5):
    rng = np.random.default_rng(seed)
    img = 60.0 + 20.0 * np.sin(np.arange(W) / 13.0)[None, :] + 15.0 * np.cos(np.arange(H) / 9.0)[:, None]
    yy, xx = np.mgrid[-4:5, -4:5]
    for _ in range(n_blobs):
        x, y = rng.integers(8, W - 8), rng.integers(8, H - 8)
        a = rng.uniform(60, 150)
        img[y - 4 : y + 5, x - 4 : x + 5] += a * np.exp(-(xx**2 + yy**2) / 4.0)
    return np.clip(img, 0, 255).astype(np.float32)


def _pyr(img, levels=4):
    out = [img]
    for _ in range(levels - 1):
        out.append(cv2.pyrDown(out[-1]))
    return [jnp.asarray(x) for x in out]


def test_gemm_matches_gather():
    img = _test_image()
    M = np.float32([[1, 0, 4.3], [0, 1, -3.1]])
    img2 = cv2.warpAffine(img, M, (320, 240))
    pyr1, pyr2 = _pyr(img), _pyr(img2)

    rng = np.random.default_rng(0)
    pts = rng.uniform(40, 200, (24, 2)).astype(np.float32)
    pts = jnp.asarray(pts)
    valid = jnp.ones(24, bool)

    a = optical_flow_pyr_lk(pyr1, pyr2, pts, pts, valid, 15, 30, 0.01)
    b = optical_flow_pyr_lk_gemm(pyr1, pyr2, pts, pts, valid, 15, 30, 0.01)
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    ok = np.asarray(a.valid)
    np.testing.assert_allclose(
        np.asarray(a.pts)[ok], np.asarray(b.pts)[ok], atol=5e-2
    )
    # And both land on the true shift.
    expected = np.asarray(pts) + np.array([4.3, -3.1], np.float32)
    np.testing.assert_allclose(np.asarray(b.pts)[ok], expected[ok], atol=0.2)


def test_gemm_subpixel_template():
    """Non-integer template positions must sample identically in both paths."""
    img = _test_image(seed=9)
    pyr1 = _pyr(img)
    rng = np.random.default_rng(1)
    pts = jnp.asarray(rng.uniform(40, 180, (16, 2)) + rng.uniform(0.1, 0.9, (16, 2)), jnp.float32)
    valid = jnp.ones(16, bool)
    a = optical_flow_pyr_lk(pyr1, pyr1, pts, pts, valid, 15, 30, 0.01)
    b = optical_flow_pyr_lk_gemm(pyr1, pyr1, pts, pts, valid, 15, 30, 0.01)
    # Identity tracking: both must stay put.
    np.testing.assert_allclose(np.asarray(a.pts), np.asarray(pts), atol=1e-3)
    np.testing.assert_allclose(np.asarray(b.pts), np.asarray(pts), atol=1e-3)
