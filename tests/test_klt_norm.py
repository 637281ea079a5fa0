"""Photometric normalization modes of the correlation-surface LK
(FrontendConfig.klt_norm; ops/klt_corr.py _template_quantities /
_surfaces_for_norm).

The gate's exposure drift (gain 1 +/- 0.25, offset +/- 12 DN) and vignette
bias raw brightness-constancy LK; 'zeromean' removes offset mismatch by
folding mean corrections into the correlation surfaces, 'gain' solves the
affine-photometric system (one extra template-correlation surface) and is
exactly unbiased under patch = a*template + b.  No reference equivalent
(vikit optical_flow_multi_level is raw brightness constancy).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from msckf_stereo_c.ops.klt_corr import (
    optical_flow_lk_corr_l0,
    stereo_anchor_lr_fused,
)


def _base_image(seed=0, H=200, W=260, pad=8):
    """Smooth random image with a padded domain for sub-pixel shifting."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 255.0, ((H + 2 * pad) // 8, (W + 2 * pad) // 8))
    img = jax.image.resize(
        jnp.asarray(base, jnp.float32), (H + 2 * pad, W + 2 * pad), method="cubic"
    )
    return np.clip(np.asarray(img), 0.0, 255.0)


def _shift_bilinear(base, dy, dx, pad, H, W):
    """Bilinear sub-pixel sample of the padded base at offset (dy, dx) —
    the same interpolation model LK itself uses."""
    iy, fy = int(np.floor(dy)), dy - np.floor(dy)
    ix, fx = int(np.floor(dx)), dx - np.floor(dx)
    b = base[pad + iy : pad + iy + H + 1, pad + ix : pad + ix + W + 1]
    return (
        (1 - fy) * (1 - fx) * b[:H, :W]
        + (1 - fy) * fx * b[:H, 1 : W + 1]
        + fy * (1 - fx) * b[1 : H + 1, :W]
        + fy * fx * b[1 : H + 1, 1 : W + 1]
    ).astype(np.float32)


def _tracking_setup(gain, offset, seed=3, n=40, shift=(1.3, -0.8)):
    H, W, pad = 200, 260, 8
    base = _base_image(seed=seed, H=H, W=W, pad=pad)
    img0 = _shift_bilinear(base, 0.0, 0.0, pad, H, W)
    img1 = np.clip(
        gain * _shift_bilinear(base, shift[0], shift[1], pad, H, W) + offset,
        0.0,
        255.0,
    )
    rng = np.random.default_rng(seed + 1)
    pts0 = np.stack(
        [rng.uniform(40, W - 40, n), rng.uniform(40, H - 40, n)], axis=1
    ).astype(np.float32)
    true1 = pts0 - np.array([shift[1], shift[0]], np.float32)
    guess = true1 + rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    return jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts0), true1, jnp.asarray(guess)


def _track(img0, img1, pts0, guess, norm, loop=None):
    res, _ = jax.jit(
        lambda a, b, p, g: optical_flow_lk_corr_l0(
            a, b, p, g, jnp.ones(p.shape[0], bool), win=15, iters=30, eps=0.01,
            norm=norm, loop=loop,
        ),
        static_argnames=(),
    )(img0, img1, pts0, guess)
    return np.asarray(res.pts), np.asarray(res.valid)


def _median_err(pts, valid, true1):
    e = np.linalg.norm(pts - true1, axis=1)
    assert valid.sum() >= valid.size * 0.8
    return float(np.median(e[valid]))


def test_clean_scene_modes_agree():
    """With no photometric mismatch all three modes land on the true shift."""
    img0, img1, pts0, true1, guess = _tracking_setup(gain=1.0, offset=0.0)
    for norm in ("none", "zeromean", "gain"):
        pts, valid = _track(img0, img1, pts0, guess, norm)
        assert _median_err(pts, valid, true1) < 0.08, norm


def test_zeromean_offset_invariant():
    """A +20 DN offset mismatch biases the raw path; zeromean removes it."""
    img0, img1, pts0, true1, guess = _tracking_setup(gain=1.0, offset=20.0)
    pts_n, val_n = _track(img0, img1, pts0, guess, "none")
    pts_z, val_z = _track(img0, img1, pts0, guess, "zeromean")
    err_n = _median_err(pts_n, val_n, true1)
    err_z = _median_err(pts_z, val_z, true1)
    assert err_z < 0.08, err_z
    assert err_n > 2.0 * err_z, (err_n, err_z)


def test_offset_mode_offset_invariant_and_ramp_safe():
    """The damped joint translation+offset solve removes offset bias on
    textured patches (like zeromean) but keeps tracking ramp-like patches
    where centered-gradient solves have no signal (the mixed-v1 failure
    mode, docs/STRESS_NOTES.md round 5)."""
    img0, img1, pts0, true1, guess = _tracking_setup(gain=1.0, offset=20.0)
    pts_n, val_n = _track(img0, img1, pts0, guess, "none")
    pts_o, val_o = _track(img0, img1, pts0, guess, "offset")
    err_n = _median_err(pts_n, val_n, true1)
    err_o = _median_err(pts_o, val_o, true1)
    assert err_o < 0.1, err_o
    assert err_n > 2.0 * err_o, (err_n, err_o)

    # Ramp scene: a pure linear ramp plus faint texture.  The zeromean
    # solve freezes at the guess (centered gradients ~ 0); the offset
    # solve must still converge to the true shift.
    H, W, pad = 200, 260, 8
    yy, xx = np.mgrid[0 : H + 2 * pad + 1, 0 : W + 2 * pad + 1]
    rng = np.random.default_rng(9)
    base = 0.5 * xx + 0.3 * yy + 2.0 * rng.standard_normal(xx.shape)
    base = np.clip(base, 0, 255).astype(np.float64)
    img0r = jnp.asarray(_shift_bilinear(base, 0.0, 0.0, pad, H, W))
    img1r = jnp.asarray(_shift_bilinear(base, 1.2, -0.7, pad, H, W))
    pts = np.stack(
        [rng.uniform(40, W - 40, 30), rng.uniform(40, H - 40, 30)], axis=1
    ).astype(np.float32)
    true1r = pts - np.array([-0.7, 1.2], np.float32)
    guess_r = jnp.asarray(true1r + rng.uniform(-1.5, 1.5, (30, 2)).astype(np.float32))
    pts_o, val_o = _track(img0r, img1r, jnp.asarray(pts), guess_r, "offset")
    pts_n, val_n = _track(img0r, img1r, jnp.asarray(pts), guess_r, "none")
    err_o = np.linalg.norm(pts_o - true1r, axis=1)
    err_n = np.linalg.norm(pts_n - true1r, axis=1)
    # Offset mode keeps tracking the ramp (the damp bounds how much of the
    # ramp's DC-gradient information the offset unknown can consume): its
    # error stays within 2x of the raw solve on the same lanes.
    assert np.median(err_o[val_o]) < 0.25, np.median(err_o[val_o])
    assert np.median(err_o[val_o]) < 2.0 * np.median(err_n[val_o]) + 0.05


def test_gain_mode_gain_invariant():
    """A 0.7x gain + offset mismatch (the stress gate's exposure-drift
    extreme) biases both the raw and zeromean paths; the affine-photometric
    solve stays on the true shift."""
    img0, img1, pts0, true1, guess = _tracking_setup(gain=0.7, offset=15.0)
    pts_g, val_g = _track(img0, img1, pts0, guess, "gain")
    pts_z, val_z = _track(img0, img1, pts0, guess, "zeromean")
    err_g = _median_err(pts_g, val_g, true1)
    err_z = _median_err(pts_z, val_z, true1)
    assert err_g < 0.08, err_g
    # zeromean under pure-gain mismatch keeps a residual bias.
    assert err_z > err_g, (err_z, err_g)


@pytest.mark.parametrize("norm", ["zeromean", "offset", "gain"])
def test_pallas_kernel_matches_xla_loop(norm):
    """The Triton-route iteration kernel (interpret mode; the third
    surface for offset/gain) must match the XLA while_loop for the
    normalized modes too."""
    img0, img1, pts0, true1, guess = _tracking_setup(gain=0.8, offset=10.0)
    pts_x, val_x = _track(img0, img1, pts0, guess, norm, loop="xla")
    pts_p, val_p = _track(img0, img1, pts0, guess, norm, loop="interpret")
    np.testing.assert_array_equal(val_x, val_p)
    np.testing.assert_allclose(pts_x[val_x], pts_p[val_x], atol=2e-4)


def test_fused_call_gain_mode_runs():
    """stereo_anchor_lr_fused under norm='gain': anchor acceptance against a
    gain-mismatched birth template must survive where the raw path loses it
    (the round-4 noise-locked anchor mechanism), and the min_eig output is
    positive for textured lanes."""
    img0, _, pts0, _, _ = _tracking_setup(gain=1.0, offset=0.0)
    n = pts0.shape[0]
    valid = jnp.ones((n,), bool)
    # Birth templates extracted from a darker exposure of the SAME scene
    # (gain+offset chosen to stay inside [0, 255]: the affine relation must
    # hold exactly, clipping would break it for any tracker).
    img0_dark = 0.75 * img0 + 8.0
    _, sp_anchor = jax.jit(
        lambda a, p, v: optical_flow_lk_corr_l0(
            a, a, p, p, v, win=15, iters=30, eps=0.01, want_tmpl=True
        )
    )(img0_dark, pts0, valid)

    out = {}
    for norm in ("none", "gain"):
        pts0_out, acc, res, rt2, sp, me = jax.jit(
            lambda a, b, p, g, v, sp_a, _n=norm: stereo_anchor_lr_fused(
                a, b, p, g, v, win=15, iters=30, eps=0.01,
                anchor_sp=sp_a, anchor_valid=v, anchor_radius=2.0, norm=_n,
            )
        )(img0, img0, pts0, pts0, valid, sp_anchor)
        out[norm] = (np.asarray(acc), np.asarray(pts0_out), np.asarray(me))
    acc_g, p_g, me_g = out["gain"]
    acc_n, p_n, _ = out["none"]
    # Gain mode: anchors accepted and land back on the true positions
    # (tolerance covers the convergence eps plus the 5% beta-damp residual).
    assert acc_g.sum() >= 0.9 * n
    err_gain = np.linalg.norm(p_g[acc_g] - np.asarray(pts0)[acc_g], axis=1)
    assert np.median(err_gain) < 0.05, np.median(err_gain)
    assert np.max(err_gain) < 0.3, np.max(err_gain)
    assert np.all(me_g > 0)
    # Raw path under the same mismatch is measurably biased where accepted.
    if acc_n.any():
        err_n = np.linalg.norm(p_n[acc_n] - np.asarray(pts0)[acc_n], axis=1)
        err_g = np.linalg.norm(p_g[acc_g] - np.asarray(pts0)[acc_g], axis=1)
        assert np.median(err_n) > np.median(err_g)


def test_anchor_gain_mode_forward_bit_identical_to_none():
    """klt_norm='anchor_gain' (norms ('none', 'gain')): the forward/backward
    stereo legs must be BIT-identical to the all-'none' call — only the
    anchor stage changes (it gets the affine-photometric solve against the
    gain-mismatched birth template), so the anchor outputs may differ."""
    from msckf_stereo_c.config import FrontendConfig
    from msckf_stereo_c.models.frontend import _norms

    assert _norms(FrontendConfig(klt_norm="anchor_gain")) == ("none", "gain")

    img0, img1, pts0, _, guess = _tracking_setup(gain=1.0, offset=0.0)
    n = pts0.shape[0]
    valid = jnp.ones((n,), bool)

    def run(anchor_norm):
        return jax.jit(
            lambda a, b, p, g, v, _an=anchor_norm: stereo_anchor_lr_fused(
                a, b, p, g, v, win=15, iters=30, eps=0.01,
                anchor_sp=None, anchor_valid=None,
                norm="none", anchor_norm=_an,
            )
        )(img0, img1, pts0, guess, valid)

    # Without an anchor slice the anchor_norm is inert: whole call equal.
    o_none = run("none")
    o_ag = run("gain")
    np.testing.assert_array_equal(np.asarray(o_none[2].pts), np.asarray(o_ag[2].pts))
    np.testing.assert_array_equal(np.asarray(o_none[3]), np.asarray(o_ag[3]))

    # With an anchor slice, the anchor stage engages the gain solve but the
    # forward leg still starts from the anchor-refined positions computed
    # by its own norm — check the call runs and yields valid tracks.
    img0_dark = 0.75 * img0 + 8.0
    _, sp_anchor = jax.jit(
        lambda a, p, v: optical_flow_lk_corr_l0(
            a, a, p, p, v, win=15, iters=30, eps=0.01, want_tmpl=True
        )
    )(img0_dark, pts0, valid)
    pts0_out, acc, res, rt2, sp, me = jax.jit(
        lambda a, b, p, g, v, sp_a: stereo_anchor_lr_fused(
            a, b, p, g, v, win=15, iters=30, eps=0.01,
            anchor_sp=sp_a, anchor_valid=v, anchor_radius=2.0,
            norm="none", anchor_norm="gain",
        )
    )(img0, img0, pts0, pts0, valid, sp_anchor)
    acc = np.asarray(acc)
    assert acc.sum() >= 0.9 * n
    err = np.linalg.norm(np.asarray(pts0_out)[acc] - np.asarray(pts0)[acc], axis=1)
    assert np.median(err) < 0.05, np.median(err)
