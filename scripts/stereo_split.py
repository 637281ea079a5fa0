"""Microbenchmark the merged stereo-match path's sub-stages at bench shapes
(B=16 vmapped, 96 surviving + 80 candidates, 752x480 full-res pyramids):
candidate guess (undistort+rotate+distort), coarse candidate KLT (levels
3,2), merged fine KLT (levels 1,0), epipolar gate (2 undistorts + line
math).  Each is timed cumulatively by truncating the function.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.config import EUROC_CALIB, FrontendConfig
from msckf_stereo_c.models.frontend import _klt_fn, make_frontend_params
from msckf_stereo_c.ops.camera import distort_points, undistort_points
from msckf_stereo_c.ops.pyramid import build_pyramid

B = int(os.environ.get("SS_BATCH", "16"))
N, C = 96, 80
H, W = 480, 752
cfg = FrontendConfig()
params = make_frontend_params(EUROC_CALIB, jnp.float32)
rng = np.random.default_rng(0)
img0 = jnp.asarray(rng.uniform(0, 255, (H, W)), jnp.float32)
img1 = jnp.asarray(rng.uniform(0, 255, (H, W)), jnp.float32)
pyr0 = tuple(build_pyramid(img0, cfg.pyramid_levels))
pyr1 = tuple(build_pyramid(img1, cfg.pyramid_levels))
pts_surv = jnp.asarray(
    np.stack([rng.uniform(40, W - 40, (B, N)), rng.uniform(40, H - 40, (B, N))], -1),
    jnp.float32,
)
cand_xy = jnp.asarray(
    np.stack([rng.uniform(40, W - 40, (B, C)), rng.uniform(40, H - 40, (B, C))], -1),
    jnp.float32,
)
surv_valid = jnp.ones((B, N), bool)
cand_valid = jnp.ones((B, C), bool)


def stage(upto):
    def fn(ps, cx, sv, cv):
        klt = _klt_fn(cfg.klt_impl)
        xn = undistort_points(cx, params.K0, params.D0, model=cfg.distortion_model0, R=params.R_c0_c1)
        cguess = distort_points(xn, params.K1, params.D1, model=cfg.distortion_model1)
        if upto == "guess":
            return cguess
        s = 4.0
        res_c = klt(pyr0[2:], pyr1[2:], cx / s, cguess / s, cv,
                    win=cfg.patch_size, iters=cfg.max_iteration, eps=cfg.track_precision)
        cguess = res_c.pts * s
        if upto == "coarse":
            return cguess
        pts0 = jnp.concatenate([ps, cx], axis=0)
        guess = jnp.concatenate([ps + 4.0, cguess], axis=0)
        valid = jnp.concatenate([sv, cv], axis=0)
        res = klt(pyr0[:2], pyr1[:2], pts0, guess, valid,
                  win=cfg.patch_size, iters=cfg.max_iteration, eps=cfg.track_precision)
        pts1 = res.pts
        ok = res.valid & valid
        if upto == "fine":
            return pts1, ok
        un0 = undistort_points(pts0, params.K0, params.D0, model=cfg.distortion_model0)
        un1 = undistort_points(pts1, params.K1, params.D1, model=cfg.distortion_model1)
        p0h = jnp.concatenate([un0, jnp.ones_like(un0[:, :1])], axis=1)
        p1h = jnp.concatenate([un1, jnp.ones_like(un1[:, :1])], axis=1)
        line = p0h @ params.E.T
        dist = jnp.abs(jnp.sum(p1h * line, axis=1)) / jnp.sqrt(
            line[:, 0] ** 2 + line[:, 1] ** 2 + 1e-12
        )
        ok = ok & (dist <= cfg.stereo_threshold * params.norm_pixel_unit)
        return pts1, ok

    return jax.jit(jax.vmap(fn, in_axes=(0, 0, 0, 0)))


prev = None
for upto in ("guess", "coarse", "fine", "gate"):
    f = stage(upto)
    t0 = time.time()
    out = jax.block_until_ready(f(pts_surv, cand_xy, surv_valid, cand_valid))
    ct = time.time() - t0
    reps = 20
    t0 = time.time()
    for _ in range(reps):
        out = f(pts_surv, cand_xy, surv_valid, cand_valid)
    jax.block_until_ready(out)
    ms = (time.time() - t0) / reps * 1000
    delta = "" if prev is None else f"  (+{ms - prev:6.3f} ms)"
    print(f"{upto:8s} {ms:8.3f} ms{delta}", flush=True)
    prev = ms
