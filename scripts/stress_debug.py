#!/usr/bin/env python
"""Diagnose the stress-gate ATE: per-time-bucket aligned error against the
stress-event timeline, for a configurable variant matrix.

  STRESS_DURATION=36 STRESS_VARIANT=stress|nominal STRESS_METHOD=schur|qr
  STRESS_DTYPE=f32|f64 python scripts/stress_debug.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    if "STRESS_PLATFORM" in os.environ:
        jax.config.update("jax_platforms", os.environ["STRESS_PLATFORM"])
    # Debug runs often execute several at a time; concurrent writers have
    # corrupted the shared compilation cache before (segfault on read).
    jax.config.update("jax_enable_compilation_cache", False)

    import jax.numpy as jnp
    import numpy as np

    from msckf_stereo_c.config import FilterConfig, FrontendConfig
    from msckf_stereo_c.sim.render_jax import make_stress_events
    from msckf_stereo_c.sim.stress import run_stress_gate
    from msckf_stereo_c.sim.trajectory import make_stress_trajectory

    duration = float(os.environ.get("STRESS_DURATION", "36"))
    variant = os.environ.get("STRESS_VARIANT", "stress")
    method = os.environ.get("STRESS_METHOD", "schur")
    f64 = os.environ.get("STRESS_DTYPE", "f32") == "f64"
    mcfg = FilterConfig(
        ns_iters=0 if (f64 or method != "schur") else 10,
        matmul_precision="float32" if f64 else os.environ.get("STRESS_PRECISION", "tensorfloat32"),
    )

    import json

    fcfg = FrontendConfig(
        klt_impl=os.environ.get("STRESS_KLT", FrontendConfig.klt_impl),
        tmpl_carry=os.environ.get("STRESS_TMPL", "1") == "1",
        temporal_levels=int(os.environ.get("STRESS_TLEVELS", FrontendConfig.temporal_levels)),
        stereo_levels=int(os.environ.get("STRESS_SLEVELS", FrontendConfig.stereo_levels)),
    )
    traj_kwargs = json.loads(os.environ.get("STRESS_TRAJ_KWARGS", "{}"))
    if os.environ.get("STRESS_EXACT_GRAVITY", "0") == "1":
        # Ablation: pin the filter's gravity vector to the sim's exact
        # value instead of estimating |g| from the noisy static window
        # (isolates gravity-magnitude error from vision drift).
        import msckf_stereo_c.models.vio as _vio
        from msckf_stereo_c.sim.trajectory import GRAVITY as _G

        _orig = _vio.apply_gravity_init

        def _exact(state, gyro, acc):
            s = _orig(state, gyro, acc)
            return s._replace(gravity=jnp.asarray([0.0, 0.0, -_G], s.gravity.dtype))

        _vio.apply_gravity_init = _exact
    out = run_stress_gate(
        duration=duration,
        imu_gyro_noise=float(os.environ.get("STRESS_GYRO_NOISE", "5e-4")),
        imu_acc_noise=float(os.environ.get("STRESS_ACC_NOISE", "5e-3")),
        chunk=128,
        r_wall=float(os.environ.get("STRESS_WALL", "7")),
        z_cap=float(os.environ.get("STRESS_ZCAP", "3.5")),
        fcfg=fcfg,
        mcfg=mcfg,
        filter_dtype=jnp.float64 if f64 else jnp.float32,
        method=method,
        stress=(variant == "stress"),
        traj_kwargs=traj_kwargs,
        generator=os.environ.get("STRESS_GENERATOR", "stress"),
    )
    print(
        f"variant={variant} method={method} dtype={'f64' if f64 else 'f32'} "
        f"duration={duration} wall={os.environ.get('STRESS_WALL', '7')} "
        f"klt={fcfg.klt_impl}/tmpl{int(fcfg.tmpl_carry)}/tl{fcfg.temporal_levels}/sl{fcfg.stereo_levels} "
        f"kwargs={traj_kwargs} ATE rmse={out.ate_rmse:.4f} mean={out.ate_mean:.4f} "
        f"max={out.ate_max:.4f} min_tracks={out.min_tracks_after_ransac}"
    )

    # Aligned per-frame error (same association/alignment as evaluate_ate).
    from msckf_stereo_c.io.tum import associate, horn_align

    ia, ib = associate(out.result.times, out.gt_t, 0.02)
    e, g = out.result.positions[ia], out.gt_p[ib]
    R, t = horn_align(e, g)
    err = np.linalg.norm((e @ R.T + t) - g, axis=1)

    # Error-structure decomposition: how much of the ATE is a global SCALE
    # error (disparity/depth bias) vs heading drift vs z?
    ec, gc = e - e.mean(0), g - g.mean(0)
    er = ec @ R.T  # rotation-aligned, centered estimate
    s_opt = float(np.sum(er * gc) / np.sum(er * er))
    err_s = np.linalg.norm(s_opt * er - gc, axis=1)
    d = er - gc
    print(
        f"scale_opt={s_opt:.5f}  ate_rigid={np.sqrt((err**2).mean()):.4f}  "
        f"ate_similarity={np.sqrt((err_s**2).mean()):.4f}  "
        f"axis_rmse=({np.sqrt((d[:,0]**2).mean()):.4f},"
        f"{np.sqrt((d[:,1]**2).mean()):.4f},{np.sqrt((d[:,2]**2).mean()):.4f})"
    )
    dump = os.environ.get("STRESS_DUMP")
    if dump:
        np.savez(
            dump,
            t=out.result.times[ia], est=e, gt=g, R=R, toff=t,
            pos_cov=out.result.pos_cov[ia],
            tracks=out.result.tracking["after_ransac"][ia],
        )
    # Residual yaw between aligned estimate and gt, per time bucket (a
    # linear trend here = heading-rate drift).
    ang = np.degrees(
        np.arctan2(gc[:, 1], gc[:, 0]) - np.arctan2(er[:, 1], er[:, 0])
    )
    ang = (ang + 180.0) % 360.0 - 180.0
    Bv = max(1, len(ang) // 12)
    print("yaw residual [deg] per bucket:",
          " ".join(f"{ang[s:s+Bv].mean():+.2f}" for s in range(0, len(ang), Bv)))

    traj = make_stress_trajectory(duration=duration)
    idx = np.arange(0, traj.t.shape[0], 10)
    ev = make_stress_events(traj, idx)
    tr = out.result.tracking["after_ransac"]
    print(" t[s]  err[m]  tex  occ  gain  tracks")
    B = max(1, len(err) // 24)
    for s in range(0, len(err), B):
        sl = slice(s, min(s + B, len(err)))
        # Event/tracking arrays are indexed by frame; err is indexed by the
        # association subset — map the bucket through ia so the columns stay
        # aligned even if associate() drops frames.
        fi = ia[sl]
        print(
            f"{out.result.times[fi][0]:6.1f}  {err[sl].max():.4f}  "
            f"{ev.tex_scale[fi].min():.2f}  {ev.occ_radius[fi].max():.2f}  "
            f"{ev.gain[fi][0]:.2f}  {tr[fi].min()}"
        )


if __name__ == "__main__":
    main()
