"""Config-system tests: YAML round-trips and the matmul_precision knob
validation/plumbing (ADVICE round 1: an invalid precision string used to
surface only as an opaque trace-time error on the first frame)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from msckf_stereo_c.config import (
    EUROC_CALIB,
    FilterConfig,
    FrontendConfig,
    VALID_MATMUL_PRECISIONS,
    load_filter_config,
    load_frontend_config,
    matmul_precision_scope,
)


def test_matmul_precision_validated_at_construction():
    for bad in ("f32", "tf32", "HIGHEST", "bfloat16_3pass"):
        with pytest.raises(ValueError, match="matmul_precision"):
            FrontendConfig(matmul_precision=bad)
        with pytest.raises(ValueError, match="matmul_precision"):
            FilterConfig(matmul_precision=bad)
    for good in VALID_MATMUL_PRECISIONS:
        FrontendConfig(matmul_precision=good)
        FilterConfig(matmul_precision=good)


def test_matmul_precision_validated_at_yaml_load(tmp_path):
    p = tmp_path / "imgproc.yaml"
    p.write_text("matmul_precision: floatt32\n")
    with pytest.raises(ValueError, match="matmul_precision"):
        load_frontend_config(str(p))
    p.write_text("matmul_precision: tensorfloat32\ngrid_row: 3\n")
    cfg = load_frontend_config(str(p))
    assert cfg.matmul_precision == "tensorfloat32" and cfg.grid_row == 3

    q = tmp_path / "msckf.yaml"
    q.write_text("matmul_precision: bf16\n")
    with pytest.raises(ValueError, match="matmul_precision"):
        load_filter_config(str(q))


def test_matmul_precision_scope_nullcontext():
    # "default" must be a no-op scope; others must set the jax precision.
    with matmul_precision_scope("default"):
        pass
    with matmul_precision_scope("float32"):
        pass


def test_frontend_precision_knob_plumbs_through_step():
    """frontend_step under matmul_precision='float32' vs 'default' runs the
    scoped wrapper end-to-end (on CPU both produce identical results; the
    test guards the wrapper/loader plumbing, mirroring
    tests/test_filter.py::test_matmul_precision_knob for the filter)."""
    from msckf_stereo_c.models.frontend import (
        frontend_step,
        init_tracker_state,
        make_frontend_params,
        pyramids_for,
    )

    rng = np.random.default_rng(0)
    H, W = 96, 128
    img = 70.0 + 30.0 * rng.standard_normal((H, W))
    yy, xx = np.mgrid[-3:4, -3:4]
    for _ in range(30):
        x, y = rng.integers(8, W - 8), rng.integers(8, H - 8)
        img[y - 3 : y + 4, x - 3 : x + 4] += 120.0 * np.exp(-(xx**2 + yy**2) / 3.0)
    img0 = jnp.asarray(np.clip(img, 0, 255), jnp.float32)
    img1 = jnp.asarray(np.clip(np.roll(img, 2, axis=1), 0, 255), jnp.float32)

    params = make_frontend_params(EUROC_CALIB, jnp.float32)

    outs = {}
    for prec in ("default", "float32"):
        cfg = FrontendConfig(max_features=32, matmul_precision=prec)
        state = init_tracker_state(cfg, jnp.float32)
        pyr0 = pyramids_for(img0, cfg)
        pyr1 = pyramids_for(img1, cfg)

        @jax.jit
        def first(state, pyr0, pyr1):
            return frontend_step(
                state, jax.tree.map(jnp.zeros_like, pyr0), pyr0, pyr1,
                jnp.zeros(3, jnp.float32), jnp.float32(0.0),
                jnp.asarray(True), params, cfg,
            )

        st, out = first(state, pyr0, pyr1)
        outs[prec] = out

    np.testing.assert_array_equal(
        np.asarray(outs["default"].fid), np.asarray(outs["float32"].fid)
    )
    np.testing.assert_allclose(
        np.asarray(outs["default"].uv), np.asarray(outs["float32"].uv), atol=1e-6
    )
