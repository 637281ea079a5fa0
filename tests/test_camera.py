"""Camera distortion model tests against the OpenCV oracle (the reference's
undistort/distort semantics are OpenCV's, image_processor.cpp:772-846)."""
import cv2
import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.config import EUROC_CALIB
from msckf_stereo_c.ops.camera import (
    distort_points,
    radtan_distort_normalized,
    undistort_points,
)

CAM = EUROC_CALIB.cam0
K = CAM.K()
D = np.asarray(CAM.distortion_coeffs)
RNG = np.random.default_rng(11)


def _random_pixels(n=200):
    w, h = CAM.resolution
    return np.stack(
        [RNG.uniform(50, w - 50, n), RNG.uniform(50, h - 50, n)], axis=1
    )


def test_undistort_inverts_opencv_forward_model():
    """OpenCV's undistortPoints stops after 5 fixed-point iterations and is
    visibly unconverged at strong distortion, so instead of comparing
    unconverged iterates, validate against the *exact* forward model: our
    undistorted rays re-projected through cv2.projectPoints must land on the
    original pixels."""
    pts = _random_pixels()
    ours = np.asarray(
        undistort_points(
            jnp.asarray(pts), jnp.asarray(CAM.intrinsics), jnp.asarray(D)
        )
    )
    obj = np.concatenate([ours, np.ones((len(ours), 1))], axis=1)
    back, _ = cv2.projectPoints(obj, np.zeros(3), np.zeros(3), K, D)
    np.testing.assert_allclose(back.reshape(-1, 2), pts, atol=1e-6)
    # And stay close to OpenCV's (unconverged) undistort output.
    cv = cv2.undistortPoints(pts.reshape(-1, 1, 2).astype(np.float64), K, D).reshape(-1, 2)
    np.testing.assert_allclose(ours, cv, atol=2e-3)


def test_undistort_with_rectify_and_reproject():
    pts = _random_pixels()
    Rm, _ = cv2.Rodrigues(np.array([0.01, -0.02, 0.005]))
    newK = np.array([100.0, 110.0, 320.0, 240.0])
    P = np.array([[newK[0], 0, newK[2]], [0, newK[1], newK[3]], [0, 0, 1]])
    ours = np.asarray(
        undistort_points(
            jnp.asarray(pts),
            jnp.asarray(CAM.intrinsics),
            jnp.asarray(D),
            R=jnp.asarray(Rm),
            new_intrinsics=jnp.asarray(newK),
        )
    )
    cv = cv2.undistortPoints(
        pts.reshape(-1, 1, 2).astype(np.float64), K, D, R=Rm, P=P
    ).reshape(-1, 2)
    # Loose bound only: cv2's iteration is unconverged (see above); the exact
    # inverse property is covered by test_undistort_inverts_opencv_forward_model.
    np.testing.assert_allclose(ours, cv, atol=0.5)


def test_distort_matches_opencv_projectpoints():
    n = 200
    xn = RNG.uniform(-0.5, 0.5, (n, 2))
    ours = np.asarray(
        distort_points(jnp.asarray(xn), jnp.asarray(CAM.intrinsics), jnp.asarray(D))
    )
    obj = np.concatenate([xn, np.ones((n, 1))], axis=1).astype(np.float64)
    cv, _ = cv2.projectPoints(obj, np.zeros(3), np.zeros(3), K, D)
    np.testing.assert_allclose(ours, cv.reshape(-1, 2), atol=1e-8)


def test_roundtrip():
    xn = jnp.asarray(RNG.uniform(-0.6, 0.6, (100, 2)))
    xd = radtan_distort_normalized(xn, jnp.asarray(D))
    from msckf_stereo_c.ops.camera import radtan_undistort_normalized

    back = radtan_undistort_normalized(xd, jnp.asarray(D))
    np.testing.assert_allclose(np.asarray(back), np.asarray(xn), atol=1e-9)


def test_equidistant_roundtrip():
    from msckf_stereo_c.ops.camera import (
        equidistant_distort_normalized,
        equidistant_undistort_normalized,
    )

    D_fish = jnp.asarray([-0.01, 0.02, -0.005, 0.001])
    xn = jnp.asarray(RNG.uniform(-0.8, 0.8, (100, 2)))
    xd = equidistant_distort_normalized(xn, D_fish)
    back = equidistant_undistort_normalized(xd, D_fish)
    np.testing.assert_allclose(np.asarray(back), np.asarray(xn), atol=1e-8)


def test_equidistant_matches_opencv():
    D_fish = np.array([-0.01, 0.02, -0.005, 0.001])
    n = 100
    xn = RNG.uniform(-0.5, 0.5, (n, 2))
    from msckf_stereo_c.ops.camera import (
        equidistant_distort_normalized,
        normalized_to_pixel,
    )

    ours = np.asarray(
        normalized_to_pixel(
            equidistant_distort_normalized(jnp.asarray(xn), jnp.asarray(D_fish)),
            jnp.asarray(CAM.intrinsics),
        )
    )
    cv = cv2.fisheye.distortPoints(
        xn.reshape(1, -1, 2).astype(np.float64), K, D_fish
    ).reshape(-1, 2)
    np.testing.assert_allclose(ours, cv, atol=1e-7)
