"""Camera projection / distortion models (radtan + equidistant).

Replacement for vikit_cg's ``cv/undistort.h`` and ``cv/calib3d.h``
(used by the reference at image_processor.cpp:810-841): batched over points,
fixed-iteration undistortion (compiler-friendly ``fori_loop``-free unrolled
form), matching OpenCV ``undistortPoints`` / ``projectPoints`` semantics with
4 coefficients [k1, k2, p1, p2] (radtan) or [k1..k4] (equidistant).

All functions take points with shape (..., 2) and broadcast over leading
dimensions; intrinsics are (4,) [fx, fy, cx, cy].
"""
from __future__ import annotations

import jax.numpy as jnp

_UNDISTORT_ITERS = 20


def pixel_to_normalized(pts: jnp.ndarray, intrinsics: jnp.ndarray) -> jnp.ndarray:
    """Pixel coordinates -> ideal (distorted) normalized coordinates."""
    f = intrinsics[:2]
    c = intrinsics[2:]
    return (pts - c) / f


def normalized_to_pixel(pts: jnp.ndarray, intrinsics: jnp.ndarray) -> jnp.ndarray:
    f = intrinsics[:2]
    c = intrinsics[2:]
    return pts * f + c


def radtan_distort_normalized(pts: jnp.ndarray, dist: jnp.ndarray) -> jnp.ndarray:
    """Apply radial-tangential distortion to normalized coordinates."""
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    x, y = pts[..., 0], pts[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def radtan_undistort_normalized(pts_d: jnp.ndarray, dist: jnp.ndarray) -> jnp.ndarray:
    """Invert radtan distortion by fixed-point iteration (OpenCV-style)."""
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    xd, yd = pts_d[..., 0], pts_d[..., 1]
    x, y = xd, yd
    for _ in range(_UNDISTORT_ITERS):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return jnp.stack([x, y], axis=-1)


def equidistant_distort_normalized(pts: jnp.ndarray, dist: jnp.ndarray) -> jnp.ndarray:
    """Fisheye (equidistant) distortion of normalized coordinates."""
    k1, k2, k3, k4 = dist[0], dist[1], dist[2], dist[3]
    x, y = pts[..., 0], pts[..., 1]
    r = jnp.sqrt(jnp.maximum(x * x + y * y, 1e-16))
    theta = jnp.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = theta_d / r
    return pts * scale[..., None]


def equidistant_undistort_normalized(pts_d: jnp.ndarray, dist: jnp.ndarray) -> jnp.ndarray:
    """Invert fisheye distortion: Newton-free fixed-point on theta."""
    k1, k2, k3, k4 = dist[0], dist[1], dist[2], dist[3]
    xd, yd = pts_d[..., 0], pts_d[..., 1]
    theta_d = jnp.sqrt(jnp.maximum(xd * xd + yd * yd, 1e-16))
    theta = theta_d
    for _ in range(_UNDISTORT_ITERS):
        t2 = theta * theta
        theta = theta_d / (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = jnp.tan(theta) / theta_d
    return pts_d * scale[..., None]


def undistort_points(
    pts: jnp.ndarray,
    intrinsics: jnp.ndarray,
    dist: jnp.ndarray,
    model: str = "radtan",
    R: jnp.ndarray | None = None,
    new_intrinsics: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Pixel points -> undistorted, optionally rectified / reprojected points.

    Semantics of the reference's ``undistortPoints`` (image_processor.cpp:772):
    with default ``new_intrinsics`` = (1,1,0,0) the output is *normalized*
    coordinates; pass a rectification rotation ``R`` to rotate rays first.
    """
    xn = pixel_to_normalized(pts, intrinsics)
    if model == "equidistant":
        xu = equidistant_undistort_normalized(xn, dist)
    else:
        xu = radtan_undistort_normalized(xn, dist)
    if R is not None:
        rays = jnp.concatenate([xu, jnp.ones_like(xu[..., :1])], axis=-1)
        rays = jnp.einsum("ij,...j->...i", R, rays)
        xu = rays[..., :2] / rays[..., 2:3]
    if new_intrinsics is not None:
        xu = normalized_to_pixel(xu, new_intrinsics)
    return xu


def distort_points(
    pts_normalized: jnp.ndarray,
    intrinsics: jnp.ndarray,
    dist: jnp.ndarray,
    model: str = "radtan",
) -> jnp.ndarray:
    """Normalized coordinates -> distorted pixel coordinates (the reference's
    ``distortPoints`` / ``project_points`` with zero rvec/tvec)."""
    if model == "equidistant":
        xd = equidistant_distort_normalized(pts_normalized, dist)
    else:
        xd = radtan_distort_normalized(pts_normalized, dist)
    return normalized_to_pixel(xd, intrinsics)


def project_to_stereo_normalized(p_c0: jnp.ndarray, R_c0_c1: jnp.ndarray, t_c0_c1: jnp.ndarray):
    """Project cam0-frame points to both cameras' normalized image planes.

    ``p_c1 = R_c0_c1 p_c0 + t_c0_c1`` (Kalibr T_cn_cnm1 convention, see
    config.StereoCalib).  Returns ((...,2) cam0, (...,2) cam1, both depths).
    """
    p_c1 = jnp.einsum("ij,...j->...i", R_c0_c1, p_c0) + t_c0_c1
    z0 = p_c0[..., 2]
    z1 = p_c1[..., 2]
    uv0 = p_c0[..., :2] / z0[..., None]
    uv1 = p_c1[..., :2] / z1[..., None]
    return uv0, uv1, z0, z1
