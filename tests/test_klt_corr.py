"""The correlation-surface KLT must reproduce the GEMM (and hence gather)
KLT: same inverse-compositional scheme, the per-iteration resampling replaced
by exact bilinear interpolation of precomputed gradient correlation surfaces
(see ops/klt_corr.py for the linearity identity)."""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest

import msckf_stereo_c.ops.klt_corr as kc
from msckf_stereo_c.ops.klt import optical_flow_pyr_lk
from msckf_stereo_c.ops.klt_corr import optical_flow_lk_corr_l0, optical_flow_pyr_lk_corr
from msckf_stereo_c.ops.klt_gemm import optical_flow_pyr_lk_gemm

from test_klt_gemm import _pyr, _test_image


def test_corr_matches_gemm():
    img = _test_image()
    M = np.float32([[1, 0, 4.3], [0, 1, -3.1]])
    img2 = cv2.warpAffine(img, M, (320, 240))
    pyr1, pyr2 = _pyr(img), _pyr(img2)

    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.uniform(40, 200, (24, 2)).astype(np.float32))
    valid = jnp.ones(24, bool)

    a = optical_flow_pyr_lk_gemm(pyr1, pyr2, pts, pts, valid, 15, 30, 0.01)
    b = optical_flow_pyr_lk_corr(pyr1, pyr2, pts, pts, valid, 15, 30, 0.01)
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    ok = np.asarray(a.valid)
    np.testing.assert_allclose(np.asarray(a.pts)[ok], np.asarray(b.pts)[ok], atol=5e-2)
    expected = np.asarray(pts) + np.array([4.3, -3.1], np.float32)
    np.testing.assert_allclose(np.asarray(b.pts)[ok], expected[ok], atol=0.2)


def test_corr_matches_gather_identity():
    """Identity tracking at sub-pixel template positions must stay put."""
    img = _test_image(seed=9)
    pyr1 = _pyr(img)
    rng = np.random.default_rng(1)
    pts = jnp.asarray(
        rng.uniform(40, 180, (16, 2)) + rng.uniform(0.1, 0.9, (16, 2)), jnp.float32
    )
    valid = jnp.ones(16, bool)
    a = optical_flow_pyr_lk(pyr1, pyr1, pts, pts, valid, 15, 30, 0.01)
    b = optical_flow_pyr_lk_corr(pyr1, pyr1, pts, pts, valid, 15, 30, 0.01)
    np.testing.assert_allclose(np.asarray(a.pts), np.asarray(pts), atol=1e-3)
    # The corr path's rounding shifts the convergence point within the
    # track_precision (0.01 px) tolerance of the scheme itself.
    np.testing.assert_allclose(np.asarray(b.pts), np.asarray(pts), atol=2e-3)


def test_corr_pallas_kernel_interpret():
    """The Triton-route iteration kernel (interpret mode) must match the XLA
    loop, including under vmap (custom_vmap folds the batch into the
    feature axis)."""
    import jax

    img = _test_image()
    M = np.float32([[1, 0, 4.3], [0, 1, -3.1]])
    img2 = cv2.warpAffine(img, M, (320, 240))
    pyr1, pyr2 = _pyr(img, 2), _pyr(img2, 2)
    rng = np.random.default_rng(2)
    pts = jnp.asarray(rng.uniform(40, 200, (24, 2)).astype(np.float32))
    valid = jnp.ones(24, bool)

    xla = optical_flow_pyr_lk_corr(pyr1, pyr2, pts, pts, valid, 15, 30, 0.01, loop="xla")
    pal = optical_flow_pyr_lk_corr(
        pyr1, pyr2, pts, pts, valid, 15, 30, 0.01, loop="interpret"
    )
    np.testing.assert_array_equal(np.asarray(xla.valid), np.asarray(pal.valid))
    ok = np.asarray(xla.valid)
    np.testing.assert_allclose(np.asarray(xla.pts)[ok], np.asarray(pal.pts)[ok], atol=5e-2)

    B = 3
    batched = jax.jit(
        jax.vmap(
            lambda p: optical_flow_pyr_lk_corr(
                pyr1, pyr2, p, p, valid, loop="interpret"
            )
        )
    )(jnp.broadcast_to(pts, (B, 24, 2)))
    np.testing.assert_allclose(
        np.asarray(batched.pts)[1][ok], np.asarray(pal.pts)[ok], atol=5e-2
    )


def _full_res_pair(seed):
    """A 752x480 frame and a sub-pixel shifted copy (the frontend's width)."""
    big = _test_image(H=480, W=752, n_blobs=400, seed=seed)
    M = np.float32([[1, 0, 1.7], [0, 1, -0.6]])
    return jnp.asarray(big), jnp.asarray(cv2.warpAffine(big, M, (752, 480)))


@pytest.mark.parametrize("B,N", [(16, 96), (1, 37)])
def test_corr_kernel_interpret_real_width(B, N):
    """At the frontend's real widths — B=16 lanes x 96 features, P=15, S=35
    (K=21, K*K=441 padded to 512) — and at N not a multiple of the block,
    the interpreted kernel matches the XLA loop: identical valid flags,
    <= 0.05 px on converged lanes."""
    import jax

    img0, img1 = _full_res_pair(seed=11)
    rng = np.random.default_rng(B)
    pts = jnp.asarray(
        np.stack([rng.uniform(30, 720, (B, N)), rng.uniform(30, 450, (B, N))], -1),
        jnp.float32,
    )
    guess = pts + jnp.asarray(rng.uniform(-2, 2, (B, N, 2)), jnp.float32)
    valid = jnp.ones((B, N), bool)

    def run(loop):
        res, _ = jax.jit(
            jax.vmap(
                lambda p, g, v: optical_flow_lk_corr_l0(
                    img0, img1, p, g, v, 15, 30, 0.01, loop=loop
                )
            )
        )(pts, guess, valid)
        return np.asarray(res.pts), np.asarray(res.valid)

    px, vx = run("xla")
    pk, vk = run("interpret")
    np.testing.assert_array_equal(vx, vk)
    assert vx.mean() > 0.5
    np.testing.assert_allclose(pk[vx], px[vx], atol=5e-2)


def test_loop_choice_follows_backend(monkeypatch):
    """The kernel runs on a GPU, the XLA loop elsewhere; an explicit choice
    wins and an unknown one is refused."""
    import jax

    assert kc._resolve_loop(None) == "xla"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert kc._resolve_loop(None) == "triton"
    assert kc._resolve_loop("xla") == "xla"
    assert kc._resolve_loop("interpret") == "interpret"
    with pytest.raises(ValueError):
        kc._resolve_loop("pallas")


def test_kernel_lowers_through_triton():
    """Lowered for CUDA, the loop is ONE Triton custom call named
    klt_lk_iterate (not Mosaic GPU, not a while loop), with the feature
    axis padded to whole blocks and K*K to a power of two."""
    import jax

    img0, img1 = _full_res_pair(seed=12)
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.uniform(40, 400, (2, 37, 2)), jnp.float32)
    valid = jnp.ones((2, 37), bool)
    f = jax.jit(
        jax.vmap(
            lambda p, v: optical_flow_lk_corr_l0(
                img0, img1, p, p, v, 15, 30, 0.01, loop="triton"
            )[0].pts
        )
    )
    text = f.trace(pts, valid).lower(lowering_platforms=("cuda",)).as_text()
    calls = [ln for ln in text.splitlines() if "custom_call" in ln]
    triton = [ln for ln in calls if "xla.gpu.triton" in ln]
    # One template + one search problem per call, each one launch.
    assert len(triton) == 1, len(triton)
    assert 'name = "klt_lk_iterate"' in triton[0]
    assert "tensor<80x512xf32>" in triton[0]  # 2*37 lanes -> 5 blocks of 16
    assert not any("mosaic" in ln.lower() for ln in calls)


def test_corr_border_guesses():
    """Initial guesses outside the image / search range follow the gemm
    clamped-walk semantics exactly (the carried iterate is unclipped until
    the first update)."""
    img = _test_image(seed=3)
    img2 = np.roll(img, (2, 1), (0, 1))
    pyr1, pyr2 = _pyr(img, 2), _pyr(img2, 2)
    pts = jnp.asarray(
        [[9.0, 9.0], [310.0, 230.0], [160.0, 8.5], [8.2, 120.0]], jnp.float32
    )
    # Guesses pushed far off the true position, some outside the image.
    guess = pts + jnp.asarray([[25.0, 0.0], [15.0, 15.0], [-30.0, 2.0], [0.0, -20.0]], jnp.float32)
    valid = jnp.ones(4, bool)
    a = optical_flow_pyr_lk_gemm(pyr1, pyr2, pts, guess, valid, 15, 30, 0.01)
    b = optical_flow_pyr_lk_corr(pyr1, pyr2, pts, guess, valid, 15, 30, 0.01)
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    np.testing.assert_allclose(np.asarray(a.pts), np.asarray(b.pts), atol=5e-2)
