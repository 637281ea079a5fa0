"""Patch extraction of the correlation KLT (``klt_corr._extract_at_origins``,
plain XLA dynamic slices) against NumPy slicing: exact integer-origin copies
at the frontend's window sizes, at the image corners and under vmap."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from msckf_stereo_c.ops.klt_corr import _extract_at_origins


def _oracle(img, org, S):
    img = np.asarray(img)
    return np.stack([img[oy : oy + S, ox : ox + S] for ox, oy in np.asarray(org).astype(int)])


def _extract(img, org, S):
    return jax.jit(_extract_at_origins, static_argnums=2)(img, org, S)


@pytest.mark.parametrize("shape,S", [((480, 752), 35), ((240, 376), 18), ((60, 94), 35)])
def test_matches_slicing(shape, S):
    H, W = shape
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (H, W)), jnp.float32)
    N = 37
    org = np.stack(
        [rng.integers(0, W - S + 1, N), rng.integers(0, H - S + 1, N)], axis=1
    ).astype(np.float32)
    got = _extract(img, jnp.asarray(org), S)
    np.testing.assert_array_equal(np.asarray(got), _oracle(img, org, S))


def test_extreme_origins():
    H, W, S = 480, 752, 35
    rng = np.random.default_rng(1)
    img = jnp.asarray(rng.uniform(0, 255, (H, W)), jnp.float32)
    corners = [(0, 0), (W - S, 0), (0, H - S), (W - S, H - S), (1, 7), (127, 8), (128, 9)]
    org = np.array(corners, np.float32)
    got = _extract(img, jnp.asarray(org), S)
    np.testing.assert_array_equal(np.asarray(got), _oracle(img, org, S))


def test_vmap_shared_image():
    """vmap over origin sets on one shared image."""
    H, W, S = 240, 376, 18
    rng = np.random.default_rng(2)
    img = jnp.asarray(rng.uniform(0, 255, (H, W)), jnp.float32)
    B, N = 3, 11
    org = np.stack(
        [rng.integers(0, W - S + 1, (B, N)), rng.integers(0, H - S + 1, (B, N))],
        axis=2,
    ).astype(np.float32)
    got = jax.jit(jax.vmap(lambda o: _extract_at_origins(img, o, S)))(jnp.asarray(org))
    want = np.stack([_oracle(img, org[b], S) for b in range(B)])
    np.testing.assert_array_equal(np.asarray(got), want)


def test_vmap_batched_images():
    H, W, S = 240, 376, 18
    rng = np.random.default_rng(3)
    imgs = jnp.asarray(rng.uniform(0, 255, (2, H, W)), jnp.float32)
    N = 9
    org = np.stack(
        [rng.integers(0, W - S + 1, (2, N)), rng.integers(0, H - S + 1, (2, N))],
        axis=2,
    ).astype(np.float32)
    got = jax.jit(jax.vmap(lambda im, o: _extract_at_origins(im, o, S)))(
        imgs, jnp.asarray(org)
    )
    want = np.stack([_oracle(imgs[b], org[b], S) for b in range(2)])
    np.testing.assert_array_equal(np.asarray(got), want)
