"""Fused stereo fine level (ops.klt_corr.stereo_anchor_lr_fused) vs the
unfused three-call composition it replaces, plus the stereo_lr_survivors
scope semantics of models.frontend._stereo_match_merged.

The fused call shares patch extractions across anchor refinement, the
forward match, and the backward left-right round trip.  For interior
features (away from the image border by more than the search window) the
forward leg is BIT-identical to the unfused composition; the backward leg
interpolates its template from the shared search window instead of
re-extracting (same sample positions, different fp association), so the
round trip is compared with a tolerance and its accept/reject decisions
must agree except within that tolerance of the threshold.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from msckf_stereo_c.config import EUROC_CALIB, FrontendConfig
from msckf_stereo_c.models import frontend as fe
from msckf_stereo_c.ops.klt_corr import (
    optical_flow_lk_corr_l0,
    stereo_anchor_lr_fused,
)


def _smooth_images(seed=0, H=160, W=224):
    """Two independent smooth random images (LK needs gradients)."""
    rng = np.random.default_rng(seed)
    imgs = []
    for _ in range(2):
        base = rng.uniform(0.0, 255.0, (H // 8, W // 8)).astype(np.float32)
        img = jax.image.resize(jnp.asarray(base), (H, W), method="cubic")
        imgs.append(jnp.clip(img, 0.0, 255.0).astype(jnp.float32))
    return imgs


def _interior_points(seed, n, H, W, margin=45):
    rng = np.random.default_rng(seed)
    pts = np.stack(
        [
            rng.uniform(margin, W - margin, n),
            rng.uniform(margin, H - margin, n),
        ],
        axis=1,
    ).astype(np.float32)
    return jnp.asarray(pts)


def test_fused_forward_bit_identical_no_anchor():
    """Without anchors, the fused forward leg must be bit-identical to the
    unfused single-level call for interior features, and the round-trip
    decisions must match the unfused backward composition."""
    img0, img1 = _smooth_images(seed=1)
    H, W = img0.shape
    pts0 = _interior_points(2, 48, H, W)
    rng = np.random.default_rng(3)
    guess = pts0 + jnp.asarray(rng.uniform(-3, 3, (48, 2)).astype(np.float32))
    valid = jnp.ones((48,), bool)

    ref, sp_ref = jax.jit(
        lambda a, b, p, g, v: optical_flow_lk_corr_l0(
            a, b, p, g, v, win=15, iters=30, eps=0.01, want_tmpl=True
        )
    )(img0, img1, pts0, guess, valid)

    pts0_out, acc, res, rt2, sp, _me = jax.jit(
        lambda a, b, p, g, v: stereo_anchor_lr_fused(
            a, b, p, g, v, win=15, iters=30, eps=0.01
        )
    )(img0, img1, pts0, guess, valid)

    assert acc is None
    np.testing.assert_array_equal(np.asarray(pts0_out), np.asarray(pts0))
    np.testing.assert_array_equal(np.asarray(res.pts), np.asarray(ref.pts))
    np.testing.assert_array_equal(np.asarray(res.valid), np.asarray(ref.valid))
    np.testing.assert_array_equal(np.asarray(sp), np.asarray(sp_ref))

    # Unfused backward composition.
    back = jax.jit(
        lambda a, b, p, g, v: optical_flow_lk_corr_l0(
            a, b, p, g, v, win=15, iters=30, eps=0.01
        )[0]
    )(img1, img0, ref.pts, pts0, ref.valid)
    rt2_ref = np.sum((np.asarray(back.pts) - np.asarray(pts0)) ** 2, axis=1)
    rt2_ref = np.where(np.asarray(back.valid), rt2_ref, np.inf)
    rt2 = np.asarray(rt2)

    thr2 = 1.0
    fused_dec = rt2 <= thr2
    ref_dec = rt2_ref <= thr2
    # Decisions must agree except where the round trip sits within fp noise
    # of the threshold.
    disagree = fused_dec != ref_dec
    near = np.abs(np.minimum(rt2, 4.0) - np.minimum(rt2_ref, 4.0)) > 1e-2
    assert not np.any(disagree & ~near), (
        rt2[disagree], rt2_ref[disagree]
    )
    # And the round-trip errors themselves agree closely where finite.
    both = np.isfinite(rt2) & np.isfinite(rt2_ref)
    assert both.sum() > 10  # the scene must actually exercise the check
    np.testing.assert_allclose(rt2[both], rt2_ref[both], atol=5e-2)


def test_fused_anchor_matches_unfused_composition():
    """With anchors, the fused anchor leg must reproduce the unfused
    standalone anchor call (same search window, same template path)."""
    img0, img1 = _smooth_images(seed=5)
    H, W = img0.shape
    pts_true = _interior_points(6, 32, H, W)
    # Anchor templates: appearance of img0 at a slightly different position
    # (simulating accumulated sub-pixel drift of up to ~0.7 px).
    rng = np.random.default_rng(7)
    drift = jnp.asarray(rng.uniform(-0.7, 0.7, (32, 2)).astype(np.float32))
    pts_drifted = pts_true + drift
    _, sp_anchor = jax.jit(
        lambda a, p, v: optical_flow_lk_corr_l0(
            a, a, p, p, v, win=15, iters=30, eps=0.01, want_tmpl=True
        )
    )(img0, pts_true, jnp.ones((32,), bool))

    valid = jnp.ones((32,), bool)
    guess = pts_drifted + jnp.asarray(
        rng.uniform(-2, 2, (32, 2)).astype(np.float32)
    )

    # Unfused: standalone anchor call, then forward at the refined points.
    res_a = jax.jit(
        lambda a, p, v, sp: optical_flow_lk_corr_l0(
            a, a, p, p, v, win=15, iters=30, eps=0.01, tmpl_sp=sp
        )[0]
    )(img0, pts_drifted, valid, sp_anchor)
    corr2 = jnp.sum((res_a.pts - pts_drifted) ** 2, axis=1)
    acc_ref = valid & res_a.valid & (corr2 <= 2.0**2)
    pts_ref = jnp.where(acc_ref[:, None], res_a.pts, pts_drifted)

    pts0_out, acc, res, rt2, sp, _me = jax.jit(
        lambda a, b, p, g, v, sp_a: stereo_anchor_lr_fused(
            a, b, p, g, v, win=15, iters=30, eps=0.01,
            anchor_sp=sp_a, anchor_valid=v, anchor_radius=2.0,
        )
    )(img0, img1, pts_drifted, guess, valid, sp_anchor)

    np.testing.assert_array_equal(np.asarray(acc), np.asarray(acc_ref))
    np.testing.assert_array_equal(np.asarray(pts0_out), np.asarray(pts_ref))
    # The anchor must actually fire in this scene for the test to mean
    # anything.
    assert int(np.asarray(acc).sum()) > 16


def _merged_inputs(seed=11):
    """Small synthetic survivor/candidate problem for _stereo_match_merged."""
    img0, img1 = _smooth_images(seed=seed, H=160, W=224)
    cfg = FrontendConfig(
        max_features=32,
        cand_budget=0,
        distortion_model0=EUROC_CALIB.cam0.distortion_model,
        distortion_model1=EUROC_CALIB.cam1.distortion_model,
    )
    params = fe.make_frontend_params(EUROC_CALIB, jnp.float32)
    pyr0 = fe.pyramids_for(img0, cfg)
    pyr1 = fe.pyramids_for(img1, cfg)
    H, W = img0.shape
    pts_surv = _interior_points(seed + 1, cfg.max_features, H, W)
    surv_guess = pts_surv + 2.0
    surv_valid = jnp.ones((cfg.max_features,), bool)
    C = cfg.num_grids * cfg.grid_max_feature_num
    cand_xy = _interior_points(seed + 2, C, H, W)
    cand_valid = jnp.ones((C,), bool)
    return cfg, params, pyr0, pyr1, pts_surv, surv_guess, surv_valid, cand_xy, cand_valid


@pytest.mark.parametrize("survivors", [True, False])
def test_stereo_lr_survivors_scope(survivors):
    """stereo_lr_survivors=False must gate ONLY candidate lanes (survivors
    keep their pre-LR ok flags); True gates the full union (ADVICE round 3:
    the non-default path had no coverage)."""
    (cfg, params, pyr0, pyr1, pts_surv, surv_guess, surv_valid,
     cand_xy, cand_valid) = _merged_inputs()
    img_shape = pyr0[0].shape

    def run(c):
        return jax.jit(
            lambda: fe._stereo_match_merged(
                pyr0, pyr1, pts_surv, surv_guess, surv_valid,
                cand_xy, cand_valid, params, c, img_shape,
            )
        )()

    base = dataclasses.replace(cfg, stereo_lr_survivors=survivors)
    (s_pts0, s_pts1, s_ok, _), (c_pts1, c_ok, _), _, _, _ = run(base)
    nolr = dataclasses.replace(cfg, stereo_lr_threshold=0.0)
    (_, n_pts1, n_ok, _), (nc_pts1, nc_ok, _), _, _, _ = run(nolr)

    # Forward geometry identical with the gate on or off.
    np.testing.assert_allclose(
        np.asarray(s_pts1), np.asarray(n_pts1), atol=1e-4
    )
    s_ok, c_ok, n_ok, nc_ok = map(np.asarray, (s_ok, c_ok, n_ok, nc_ok))
    if survivors:
        # Full-union scope: the gate may only ever REMOVE lanes.
        assert not np.any(s_ok & ~n_ok)
        assert not np.any(c_ok & ~nc_ok)
    else:
        # Candidates-only scope: survivor lanes keep their pre-LR flags.
        np.testing.assert_array_equal(s_ok, n_ok)
        assert not np.any(c_ok & ~nc_ok)
    # The round trip must reject something in this unmatched-image scene
    # (img0/img1 are independent textures, so wrong locks abound).
    assert c_ok.sum() < nc_ok.sum()


def test_fused_merged_matches_legacy_merged():
    """_stereo_match_merged with the fused path active vs forced-legacy on
    identical inputs: survivor forward results bit-identical, decisions
    equal up to round-trip fp tolerance."""
    (cfg, params, pyr0, pyr1, pts_surv, surv_guess, surv_valid,
     cand_xy, cand_valid) = _merged_inputs(seed=21)
    img_shape = pyr0[0].shape
    assert fe._fused_stereo_active(cfg, img_shape)

    def run(force_legacy):
        if force_legacy:
            orig = fe._fused_stereo_active
            fe._fused_stereo_active = lambda *_a: False
        try:
            out = jax.jit(
                lambda: fe._stereo_match_merged(
                    pyr0, pyr1, pts_surv, surv_guess, surv_valid,
                    cand_xy, cand_valid, params, cfg, img_shape,
                )
            )()
        finally:
            if force_legacy:
                fe._fused_stereo_active = orig
        return out

    (f_pts0, f_pts1, f_ok, f_depth), (fc_pts1, fc_ok, _), (f_tmpl, _), _, _ = run(False)
    (l_pts0, l_pts1, l_ok, l_depth), (lc_pts1, lc_ok, _), (l_tmpl, _), _, _ = run(True)

    np.testing.assert_array_equal(np.asarray(f_pts0), np.asarray(l_pts0))
    np.testing.assert_array_equal(np.asarray(f_pts1), np.asarray(l_pts1))
    np.testing.assert_array_equal(np.asarray(f_tmpl), np.asarray(l_tmpl))
    # Decisions: identical except lanes whose round trip sits at the
    # threshold boundary (backward-template fp association differs).
    dis = np.asarray(f_ok) != np.asarray(l_ok)
    assert dis.mean() <= 0.1, np.nonzero(dis)
    disc = np.asarray(fc_ok) != np.asarray(lc_ok)
    assert disc.mean() <= 0.1, np.nonzero(disc)
    agree = ~dis
    np.testing.assert_allclose(
        np.asarray(f_depth)[agree], np.asarray(l_depth)[agree], atol=1e-3
    )
