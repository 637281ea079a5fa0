"""The sensor-noise prefilter (ops/pyramid.py:smooth5) and its wiring into
the tracker's pyramids (FrontendConfig.presmooth)."""
import dataclasses

import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.config import FrontendConfig
from msckf_stereo_c.models.frontend import pyramids_for
from msckf_stereo_c.ops.pyramid import build_pyramid, pyr_down, smooth5


def _ref_smooth(img: np.ndarray) -> np.ndarray:
    """Direct 5-tap binomial with REFLECT_101 borders (numpy oracle)."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    pad = np.pad(img, 2, mode="reflect")  # np reflect == REFLECT_101
    out = np.zeros_like(pad)
    for t in range(5):
        out[:, 2:-2] += k[t] * pad[:, t : t + img.shape[1]]
    out2 = np.zeros_like(img)
    for t in range(5):
        out2 += k[t] * out[t : t + img.shape[0], 2:-2]
    return out2


def test_smooth5_matches_direct_convolution():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (37, 53)).astype(np.float32)
    got = np.asarray(smooth5(jnp.asarray(img)))
    np.testing.assert_allclose(got, _ref_smooth(img), atol=1e-3)


def test_smooth5_noise_attenuation_and_zero_phase():
    rng = np.random.default_rng(5)
    noise = rng.normal(0, 1.0, (64, 96)).astype(np.float32)
    out = np.asarray(smooth5(jnp.asarray(noise)))
    # Separable binomial: noise variance gain (sum k^2)^2 = (70/256)^2.
    assert 0.2 < out.std() / noise.std() < 0.35
    # Symmetric kernel: a centered blob must not shift (zero phase).
    yy, xx = np.mgrid[0:65, 0:65]
    blob = np.exp(-((yy - 32.0) ** 2 + (xx - 32.0) ** 2) / 8.0).astype(np.float32)
    sb = np.asarray(smooth5(jnp.asarray(blob)))
    cy = (sb * yy).sum() / sb.sum()
    cx = (sb * xx).sum() / sb.sum()
    np.testing.assert_allclose([cy, cx], [32.0, 32.0], atol=1e-4)


def test_pyramids_for_presmooth_wiring():
    rng = np.random.default_rng(7)
    img = jnp.asarray(rng.uniform(0, 255, (48, 64)).astype(np.float32))
    cfg_on = FrontendConfig(presmooth=True)
    cfg_off = dataclasses.replace(cfg_on, presmooth=False)

    p_on = pyramids_for(img, cfg_on)
    p_off = pyramids_for(img, cfg_off)
    # Level 0: prefiltered vs raw.
    np.testing.assert_array_equal(np.asarray(p_on[0]), np.asarray(smooth5(img)))
    np.testing.assert_array_equal(np.asarray(p_off[0]), np.asarray(img))
    # Coarse levels: the exact OpenCV pyrDown chain from the RAW image in
    # BOTH configurations (decimation already averages noise).
    for lvl in range(1, len(p_on)):
        np.testing.assert_array_equal(np.asarray(p_on[lvl]), np.asarray(p_off[lvl]))
    np.testing.assert_array_equal(
        np.asarray(p_off[1]), np.asarray(pyr_down(img))
    )
    assert len(p_on) == cfg_on.pyramid_levels
    assert [tuple(x.shape) for x in p_on] == [
        tuple(x.shape) for x in build_pyramid(img, cfg_on.pyramid_levels)
    ]
