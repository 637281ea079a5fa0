"""Frontend kernel tests against OpenCV oracles (the reference front-end's
semantics are OpenCV's: buildOpticalFlowPyramid / FAST / calcOpticalFlowPyrLK,
image_processor.cpp:183-198, 259, 410)."""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from msckf_stereo_c.ops.fast import detect_grid_corners, fast_score_map, occupancy_from_points
from msckf_stereo_c.ops.klt import optical_flow_pyr_lk
from msckf_stereo_c.ops.pyramid import build_pyramid, pyr_down

RNG = np.random.default_rng(3)


def _test_image(H=120, W=160, n_blobs=40, seed=3):
    rng = np.random.default_rng(seed)
    img = 60.0 + 20.0 * np.sin(np.arange(W) / 13.0)[None, :] + 15.0 * np.cos(np.arange(H) / 9.0)[:, None]
    yy, xx = np.mgrid[-4:5, -4:5]
    for _ in range(n_blobs):
        x, y = rng.integers(8, W - 8), rng.integers(8, H - 8)
        a = rng.uniform(60, 150)
        img[y - 4 : y + 5, x - 4 : x + 5] += a * np.exp(-(xx**2 + yy**2) / 4.0)
    return np.clip(img, 0, 255).astype(np.float32)


def test_pyr_down_matches_opencv():
    img = _test_image()
    ours = np.asarray(pyr_down(jnp.asarray(img)))
    cv = cv2.pyrDown(img)
    assert ours.shape == cv.shape
    # Interior must match exactly (same 5-tap kernel, REFLECT_101 border).
    np.testing.assert_allclose(ours[2:-2, 2:-2], cv[2:-2, 2:-2], atol=1e-3)
    np.testing.assert_allclose(ours, cv, atol=1e-3)


def test_build_pyramid_shapes():
    img = jnp.zeros((480, 752))
    pyr = build_pyramid(img, 4)
    assert [p.shape for p in pyr] == [(480, 752), (240, 376), (120, 188), (60, 94)]


def test_fast_detects_blob_corners():
    img = _test_image()
    score = np.asarray(fast_score_map(jnp.asarray(img), 10.0))
    assert (score > 0).sum() > 20  # blobs light up
    # Borders must stay zero.
    assert score[:3].sum() == 0 and score[-3:].sum() == 0
    assert score[:, :3].sum() == 0 and score[:, -3:].sum() == 0


def test_fast_flat_image_no_corners():
    img = jnp.full((64, 64), 100.0)
    score = np.asarray(fast_score_map(img, 10.0))
    assert score.sum() == 0


def test_fast_against_opencv_recall():
    """Every strong OpenCV-FAST corner should have one of our corners within
    a couple of pixels (scores differ; positions should agree)."""
    img = _test_image(H=160, W=240, n_blobs=60)
    cv_fast = cv2.FastFeatureDetector_create(threshold=10)
    kps = cv_fast.detect(img.astype(np.uint8), None)
    strong = [k for k in kps if k.response > 30]
    score = np.asarray(fast_score_map(jnp.asarray(img), 10.0))
    ours_yx = np.argwhere(score > 0)
    assert len(ours_yx) > 0
    from scipy.spatial import cKDTree

    tree = cKDTree(ours_yx[:, ::-1])
    pts = np.array([k.pt for k in strong])
    if len(pts):
        d, _ = tree.query(pts)
        assert np.median(d) <= 2.0, f"median dist {np.median(d)}"


def test_detect_grid_corners_occupancy():
    img = jnp.asarray(_test_image(H=128, W=160))
    c_free = detect_grid_corners(img, 10.0, cell=16)
    n_free = int(jnp.sum(c_free.valid))
    assert n_free > 5
    # Occupy every cell -> nothing detected.
    occ = jnp.ones((128 // 16, 160 // 16), bool)
    c_occ = detect_grid_corners(img, 10.0, cell=16, occupied=occ)
    assert int(jnp.sum(c_occ.valid)) == 0


def test_occupancy_from_points():
    pts = jnp.asarray([[5.0, 5.0], [100.0, 50.0]])
    occ = occupancy_from_points(pts, jnp.asarray([True, False]), (128, 160), 16)
    assert bool(occ[0, 0])
    assert not bool(occ[50 // 16, 100 // 16])  # invalid point doesn't occupy


@pytest.mark.parametrize("shift", [(3.2, -2.7), (7.5, 5.1)])
def test_klt_matches_opencv(shift):
    """Track between an image and its subpixel-shifted copy; compare found
    flow against the known shift and against cv2.calcOpticalFlowPyrLK."""
    img = _test_image(H=240, W=320, n_blobs=70, seed=5)
    M = np.float32([[1, 0, shift[0]], [0, 1, shift[1]]])
    img2 = cv2.warpAffine(img, M, (320, 240))

    pts = np.array(
        [[60.0, 60.0], [160.0, 120.0], [240.0, 180.0], [100.0, 200.0]], np.float32
    )
    pyr1 = [jnp.asarray(x) for x in _np_pyramid(img, 4)]
    pyr2 = [jnp.asarray(x) for x in _np_pyramid(img2, 4)]
    res = optical_flow_pyr_lk(
        pyr1, pyr2, jnp.asarray(pts), jnp.asarray(pts), jnp.ones(len(pts), bool),
        win=15, iters=30, eps=0.01,
    )
    expected = pts + np.asarray(shift, np.float32)
    got = np.asarray(res.pts)
    ok = np.asarray(res.valid)
    assert ok.all()
    np.testing.assert_allclose(got, expected, atol=0.2)

    cv_pts, cv_st, _ = cv2.calcOpticalFlowPyrLK(
        img.astype(np.uint8), img2.astype(np.uint8), pts.reshape(-1, 1, 2), None,
        winSize=(15, 15), maxLevel=3,
        criteria=(cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS, 30, 0.01),
    )
    np.testing.assert_allclose(got, cv_pts.reshape(-1, 2), atol=0.3)


def _np_pyramid(img, levels):
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(cv2.pyrDown(pyr[-1]))
    return pyr
