#!/usr/bin/env python
"""Frontend-only track-accuracy probe: run the tracker (no filter) over a
rendered sequence and compare blob-landmark tracks against ground-truth
projections — isolates KLT/stereo systematic error from the filter.

PROBE_DUR=36 PROBE_WALL=8 PROBE_KLT=corr PROBE_TMPL=1 python scripts/track_bias_probe.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from msckf_stereo_c.device import select_platform, setup_compile_cache

    # Frontend-only probe: CPU by default (deterministic); set
    # PROBE_PLATFORM=gpu to measure the GPU path.
    select_platform(os.environ.get("PROBE_PLATFORM", "cpu"))
    setup_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from msckf_stereo_c.config import EUROC_CALIB, FilterConfig, FrontendConfig
    from msckf_stereo_c.models.frontend import (
        frontend_step, init_tracker_state, make_frontend_params, pyramids_for,
    )
    from msckf_stereo_c.models.runner import pack_imu_batches
    from msckf_stereo_c.sim.render_jax import (
        JaxRenderer,
        StressEvents,
        make_stress_events,
    )
    from msckf_stereo_c.sim.trajectory import (
        make_circle_trajectory, make_wall_landmarks, synthesize_imu,
    )

    dur = float(os.environ.get("PROBE_DUR", "36"))
    r_wall = float(os.environ.get("PROBE_WALL", "8"))
    fcfg = FrontendConfig(
        klt_impl=os.environ.get("PROBE_KLT", FrontendConfig.klt_impl),
        tmpl_carry=os.environ.get("PROBE_TMPL", "1") == "1",
        temporal_levels=int(os.environ.get("PROBE_TLEVELS", FrontendConfig.temporal_levels)),
        stereo_levels=int(os.environ.get("PROBE_SLEVELS", FrontendConfig.stereo_levels)),
        anchor_refine=os.environ.get("PROBE_ANCHOR", "1") == "1",
    )
    calib = EUROC_CALIB

    if os.environ.get("PROBE_GENERATOR", "circle") == "stress":
        from msckf_stereo_c.sim.trajectory import make_stress_trajectory

        traj = make_stress_trajectory(duration=dur)
    else:
        traj = make_circle_trajectory(
            duration=dur,
            z_amp=float(os.environ.get("PROBE_ZAMP", "0.5")),
            roll_amp=float(os.environ.get("PROBE_ROLLAMP", "0.1")),
            omega=float(os.environ.get("PROBE_OMEGA", str(2.0 * 3.14159265 / 20.0))),
        )
    lms = make_wall_landmarks(num=700, radius=r_wall, z_min=-4.5, z_max=4.5, seed=1)
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    idx = np.arange(0, traj.t.shape[0], 10)
    T = len(idx)
    frame_t = traj.t[idx]
    renderer = JaxRenderer(lms, calib, r_wall=r_wall)

    fparams = make_frontend_params(calib, jnp.float32)
    batches = pack_imu_batches(imu.t, imu.gyro, imu.acc, frame_t, 16, np.float32)

    @jax.jit
    def chunk_scan(tracker, pyr_prev, prev_t, i0s, i1s, ts, gyros, vels):
        def step(carry, xs):
            tracker, pyr_prev, prev_t = carry
            i0, i1, t, g, cv = xs
            pyr0 = pyramids_for(i0, fcfg)
            pyr1 = pyramids_for(i1, fcfg)
            is_first = prev_t < 0
            dt = jnp.where(is_first, 0.0, t - prev_t).astype(jnp.float32)
            tracker, out = frontend_step(
                tracker, pyr_prev, pyr0, pyr1, g, dt, is_first, fparams, fcfg,
                cam_vel=cv if use_vel else None,
            )
            return (tracker, pyr0, t), (out.fid, out.uv, out.valid)

        return jax.lax.scan(step, (tracker, pyr_prev, prev_t), (i0s, i1s, ts, gyros, vels))

    mean_gyro = np.where(
        np.asarray(batches.valid)[:, :, None],
        np.asarray(batches.gyro), 0.0
    ).sum(1) / np.maximum(np.asarray(batches.valid).sum(1), 1)[:, None]

    # PROBE_VEL=1 (default): feed the frontend the GROUND-TRUTH camera
    # velocity per frame — the probe then measures the tracker in the same
    # translation-seeded configuration the VIO driver runs it in
    # (models/vio.py passes the filter's velocity estimate).
    use_vel = os.environ.get("PROBE_VEL", "1") == "1"
    R_ci_np = calib.cam0.T_cam_imu_mat()[:3, :3]
    prev_i = np.maximum(idx - 10, 0)
    cam_vels = np.einsum(
        "ij,tjk,tk->ti", R_ci_np, traj.R_w_b[prev_i], traj.v[prev_i]
    ).astype(np.float32)  # velocity at the PREVIOUS frame, like the driver

    H, W = calib.cam0.resolution[1], calib.cam0.resolution[0]
    dummy = jnp.zeros((H, W), jnp.float32)
    carry = (init_tracker_state(fcfg, jnp.float32), pyramids_for(dummy, fcfg),
             jnp.asarray(-1.0, jnp.float32))
    fids, uvs, valids = [], [], []
    C = 64
    tex_scale = float(os.environ.get("PROBE_TEX", "1"))
    for s0 in range(0, T, C):
        s1 = min(s0 + C, T)
        ev = StressEvents.nominal(s1 - s0)
        ev.tex_scale[:] = tex_scale
        # Photometric channels (round 4): PROBE_NOISE=1 / PROBE_VIG=v /
        # PROBE_BLUR=1 turn on the realism channels frame-aligned with the
        # absolute index (noise identical to the gate's draw at seed 0).
        if os.environ.get("PROBE_NOISE", "0") == "1":
            # Match the gate's current default noise spec (the
            # make_stress_events signature is the single source of truth).
            import inspect

            _ev_defaults = inspect.signature(make_stress_events).parameters
            ev.noise_read = np.full(s1 - s0, _ev_defaults["noise_read_dn"].default)
            ev.noise_shot = np.full(s1 - s0, _ev_defaults["noise_shot_gain"].default)
            ev.noise_frame0 = s0
        if float(os.environ.get("PROBE_VIG", "0")) > 0:
            ev.vignette = np.full(s1 - s0, float(os.environ["PROBE_VIG"]))
        if os.environ.get("PROBE_BLUR", "0") == "1":
            ev.blur = np.ones(s1 - s0)
        img0, img1 = renderer.render_sequence(traj, idx[s0:s1], ev, chunk=C)
        carry, (f, u, v) = chunk_scan(
            carry[0], carry[1], carry[2],
            jnp.asarray(img0), jnp.asarray(img1),
            jnp.asarray(frame_t[s0:s1], jnp.float32),
            jnp.asarray(mean_gyro[s0:s1], jnp.float32),
            jnp.asarray(cam_vels[s0:s1]),
        )
        fids.append(np.asarray(f)); uvs.append(np.asarray(u)); valids.append(np.asarray(v))
    fid = np.concatenate(fids); uv = np.concatenate(uvs); valid = np.concatenate(valids)

    # Ground-truth normalized projections of every landmark per frame.
    T_ci0 = calib.cam0.T_cam_imu_mat()
    T01 = calib.T_cam0_cam1_mat()
    T_ci1 = T01 @ T_ci0
    R_wb = traj.R_w_b[idx]  # world->body
    p_b = traj.p[idx]

    def gt_norm(T_ci):
        R_ci, t_ci = T_ci[:3, :3], T_ci[:3, 3]
        # p_cam = R_ci (R_wb (lm - p)) + t_ci
        rel = lms[None, :, :] - p_b[:, None, :]
        p_imu = np.einsum("tij,tlj->tli", R_wb, rel)
        p_cam = np.einsum("ij,tlj->tli", R_ci, p_imu) + t_ci
        return p_cam[..., :2] / p_cam[..., 2:3], p_cam[..., 2]

    n0, z0 = gt_norm(T_ci0)
    n1, z1 = gt_norm(T_ci1)

    # Associate each track id with a landmark at its birth frame.
    fx = calib.cam0.intrinsics[0]
    first_seen = {}
    assoc = {}
    res = {}  # fid -> list of (frame, du0, dv0, ddisp, age)
    for t in range(T):
        for i in np.flatnonzero(valid[t]):
            f = int(fid[t, i])
            obs = uv[t, i]
            if f not in first_seen:
                d2 = np.sum((n0[t] - obs[:2]) ** 2, axis=1)
                j = int(np.argmin(d2))
                first_seen[f] = t
                if d2[j] < (2.0 / fx) ** 2 and z0[t, j] > 0.3:
                    assoc[f] = j
            j = assoc.get(f)
            if j is None:
                continue
            du0 = (obs[0] - n0[t, j, 0]) * fx
            dv0 = (obs[1] - n0[t, j, 1]) * fx
            gt_disp = (n0[t, j, 0] - n1[t, j, 0]) * fx
            tr_disp = (obs[0] - obs[2]) * fx
            res.setdefault(f, []).append(
                (t, du0, dv0, tr_disp - gt_disp, t - first_seen[f], n0[t, j, 1])
            )

    allr = np.array([r for v in res.values() for r in v])
    print(f"tracks associated: {len(res)} / {len(first_seen)}; obs: {len(allr)}")
    print(f"cam0 du: mean {allr[:,1].mean():+.4f} px  |du| p50/p90 "
          f"{np.percentile(np.abs(allr[:,1]),50):.3f}/{np.percentile(np.abs(allr[:,1]),90):.3f}")
    print(f"cam0 dv: mean {allr[:,2].mean():+.4f} px")
    print(f"disparity err: mean {allr[:,3].mean():+.4f} px  p50/p90 "
          f"{np.percentile(np.abs(allr[:,3]),50):.3f}/{np.percentile(np.abs(allr[:,3]),90):.3f}")
    # Outlier structure: wrong stereo locks ride ALONG the epipolar line and
    # pass the epipolar gate; quantify how much of the mean they carry.
    ad = np.abs(allr[:, 3])
    for thr in (0.1, 0.5, 2.0, 5.0):
        m = ad > thr
        print(f"|ddisp|>{thr:4.1f}: {m.mean()*100:5.2f}% of obs, "
              f"mean ddisp there {allr[m,3].mean() if m.any() else 0:+.3f} px")
    # Per-track: born bad vs goes bad.
    med_by_track = {f: np.median([r[3] for r in v]) for f, v in res.items()}
    bad = [f for f, m in med_by_track.items() if abs(m) > 0.5]
    print(f"tracks with |median ddisp|>0.5: {len(bad)} / {len(res)}")
    born_bad = 0
    for f in bad:
        first = sorted(res[f])[0]
        if abs(first[3]) > 0.5:
            born_bad += 1
    print(f"  of which born bad (|ddisp|>0.5 at first obs): {born_bad}")
    if bad:
        lt = [len(res[f]) for f in bad]
        print(f"  bad-track lifetime: mean {np.mean(lt):.1f} max {np.max(lt)} obs")
    # Bias vs track age (drift signature).
    print(" age  n      du0      dv0     ddisp")
    for a0, a1 in [(0, 1), (1, 3), (3, 6), (6, 10), (10, 15), (15, 25), (25, 60)]:
        m = (allr[:, 4] >= a0) & (allr[:, 4] < a1)
        if m.sum():
            print(f"{a0:3d}-{a1:<3d} {m.sum():5d} {allr[m,1].mean():+.4f} "
                  f"{allr[m,2].mean():+.4f} {allr[m,3].mean():+.4f}")
    # Bias vs IMAGE ROW (normalized v of the gt projection): distinguishes
    # position-dependent systematics (distortion, caps) from track-age ones.
    print("  v_n       n      du0      dv0    mean_age")
    vq = np.quantile(allr[:, 5], np.linspace(0, 1, 9))
    for lo, hi in zip(vq[:-1], vq[1:]):
        m = (allr[:, 5] >= lo) & (allr[:, 5] < hi)
        if m.sum():
            print(f"{lo:+.3f}..{hi:+.3f} {m.sum():6d} {allr[m,1].mean():+.4f} "
                  f"{allr[m,2].mean():+.4f} {allr[m,4].mean():6.1f}")
    # Joint (age x row) table: separates per-track temporal drift from a
    # static position-dependent bias (age and row are confounded when old
    # tracks pool at one side of the image).
    print("dv0 by age x v_n  (rows: age bins; cols: v_n bins)")
    age_bins = [(0, 2), (2, 6), (6, 15), (15, 60)]
    v_bins = [(-1.0, -0.3), (-0.3, 0.0), (0.0, 0.3), (0.3, 1.0)]
    hdr = "  age   " + " ".join(f"v{lo:+.1f}..{hi:+.1f}" for lo, hi in v_bins)
    print(hdr)
    for a0, a1 in age_bins:
        cells = []
        for lo, hi in v_bins:
            m = (allr[:, 4] >= a0) & (allr[:, 4] < a1) & (allr[:, 5] >= lo) & (allr[:, 5] < hi)
            cells.append(f"{allr[m,2].mean():+.3f}({m.sum():4d})" if m.sum() > 30 else "    --    ")
        print(f"{a0:3d}-{a1:<3d} " + " ".join(cells))
    # Bias vs sequence time (scale-drift signature).
    print(" t[s]   n      du0     ddisp")
    B = max(1, T // 12)
    for s in range(0, T, B):
        m = (allr[:, 0] >= s) & (allr[:, 0] < s + B)
        if m.sum():
            print(f"{frame_t[s]:5.1f} {m.sum():6d} {allr[m,1].mean():+.4f} {allr[m,3].mean():+.4f}")


if __name__ == "__main__":
    main()
