"""Two-point RANSAC tests on synthetic correspondences."""
import jax
import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.config import EUROC_CALIB
from msckf_stereo_c.ops.camera import distort_points
from msckf_stereo_c.ops.ransac import two_point_ransac

RNG = np.random.default_rng(31)
CAM = EUROC_CALIB.cam0
K = jnp.asarray(CAM.intrinsics)
D = jnp.asarray(CAM.distortion_coeffs)


def _project(p_cam):
    uv = p_cam[:, :2] / p_cam[:, 2:]
    return distort_points(jnp.asarray(uv), K, D)


def _make_pair(n=60, n_out=8, t=np.array([0.1, 0.02, 0.05])):
    """Static rotation (identity), pure translation t between frames."""
    pts_w = RNG.uniform(-1.5, 1.5, (n, 3)) + np.array([0, 0, 4.0])
    p1 = pts_w
    p2 = pts_w - t[None]
    uv1 = np.asarray(_project(p1))
    uv2 = np.asarray(_project(p2))
    outliers = RNG.choice(n, n_out, replace=False)
    uv2_bad = uv2.copy()
    uv2_bad[outliers] += RNG.uniform(8, 25, (n_out, 2)) * np.sign(RNG.normal(size=(n_out, 2)))
    return uv1, uv2_bad, outliers


def test_ransac_rejects_outliers():
    uv1, uv2, outliers = _make_pair()
    mask = two_point_ransac(
        jnp.asarray(uv1, jnp.float32), jnp.asarray(uv2, jnp.float32),
        jnp.ones(len(uv1), bool), jnp.eye(3, dtype=jnp.float32), K.astype(jnp.float32),
        D.astype(jnp.float32), jax.random.PRNGKey(0),
    )
    mask = np.asarray(mask)
    # All planted outliers rejected; most inliers kept.
    assert not mask[outliers].any(), "outliers survived"
    inlier_idx = np.setdiff1d(np.arange(len(uv1)), outliers)
    assert mask[inlier_idx].mean() > 0.85, mask[inlier_idx].mean()


def test_ransac_degenerate_motion():
    """No translation (static camera): the mean-displacement check must fire
    the degenerate branch — tiny-noise matches kept, gross mismatches (which
    the 50-unit prefilter removes, as in the reference) rejected."""
    pts_w = RNG.uniform(-1.5, 1.5, (40, 3)) + np.array([0, 0, 4.0])
    uv = np.asarray(_project(pts_w))
    uv2 = uv + RNG.normal(0, 0.05, uv.shape)
    uv2[:5] += 300.0  # beyond the 50*norm_pixel_unit prefilter
    mask = two_point_ransac(
        jnp.asarray(uv, jnp.float32), jnp.asarray(uv2, jnp.float32),
        jnp.ones(len(uv), bool), jnp.eye(3, dtype=jnp.float32), K.astype(jnp.float32),
        D.astype(jnp.float32), jax.random.PRNGKey(1),
    )
    mask = np.asarray(mask)
    assert not mask[:5].any()
    assert mask[5:].mean() > 0.9


def test_ransac_too_few_points():
    uv1 = np.array([[100.0, 100.0], [200.0, 150.0]])
    mask = two_point_ransac(
        jnp.asarray(uv1, jnp.float32), jnp.asarray(uv1 + 1.0, jnp.float32),
        jnp.ones(2, bool), jnp.eye(3, dtype=jnp.float32), K.astype(jnp.float32),
        D.astype(jnp.float32), jax.random.PRNGKey(2),
    )
    assert not np.asarray(mask).any()
