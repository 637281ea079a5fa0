#!/usr/bin/env python
"""Full-length V1_01-realistic stress gate (VERDICT round 1, next #2).

Runs the 130 s aggressive-6dof stress scene — texture-poor windows,
occluder sweep, exposure drift — end to end (device render -> frontend
kernels -> MSCKF) on JAX's default device (STRESS_PLATFORM=gpu|cpu picks
one), f32 + schur: the hardware path.

Prints one JSON line with the ATE and the margin vs the 0.13 m bar
(BASELINE.json; reference best on real V1_01_easy: 0.1207 m,
/root/reference/README.md:81).

Env knobs: STRESS_DURATION, STRESS_CHUNK, STRESS_METHOD, STRESS_NS_ITERS,
STRESS_FILTER_PRECISION, STRESS_SEED, STRESS_PLATFORM.

Multi-seed robustness protocol (VERDICT round 2, next #4): STRESS_SEEDS=N
runs seeds 0..N-1, each with a DIFFERENT IMU-noise draw and landmark
layout, and reports per-seed ATEs + median/worst — the gate is judged on
the WORST seed (single-seed green was measured at 0.32-0.97 m run-to-run
in round 2).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from msckf_stereo_c.device import select_platform, setup_compile_cache

    if "STRESS_PLATFORM" in os.environ:
        select_platform(os.environ["STRESS_PLATFORM"])
    setup_compile_cache()

    import numpy as np
    import jax
    import jax.numpy as jnp

    from msckf_stereo_c.config import FilterConfig, FrontendConfig
    from msckf_stereo_c.sim.stress import run_stress_gate

    duration = float(os.environ.get("STRESS_DURATION", "130"))
    method = os.environ.get("STRESS_METHOD", "schur")
    n_seeds = int(os.environ.get("STRESS_SEEDS", "1"))
    seed0 = int(os.environ.get("STRESS_SEED", "0"))
    mcfg = FilterConfig(
        ns_iters=int(os.environ.get("STRESS_NS_ITERS", FilterConfig.ns_iters)),
        matmul_precision=os.environ.get(
            "STRESS_FILTER_PRECISION", FilterConfig.matmul_precision
        ),
        noise_adaptive=os.environ.get(
            "STRESS_NOISE_ADAPTIVE", str(int(FilterConfig.noise_adaptive))
        ) == "1",
        noise_snr_ref=float(
            os.environ.get("STRESS_NOISE_REF", FilterConfig.noise_snr_ref)
        ),
        noise_inflation_cap=float(
            os.environ.get("STRESS_NOISE_CAP", FilterConfig.noise_inflation_cap)
        ),
    )
    fcfg = FrontendConfig(
        matmul_precision=os.environ.get("STRESS_FRONTEND_PRECISION", FrontendConfig.matmul_precision),
        cand_level1=os.environ.get(
            "STRESS_CAND_LEVEL1", str(int(FrontendConfig.cand_level1))
        ) == "1",
        presmooth=os.environ.get(
            "STRESS_PRESMOOTH", str(int(FrontendConfig.presmooth))
        ) == "1",
        fast_threshold=int(
            os.environ.get("STRESS_FAST_THR", FrontendConfig.fast_threshold)
        ),
        klt_norm=os.environ.get("STRESS_KLT_NORM", FrontendConfig.klt_norm),
    )

    # Photometric-channel knobs (defaults follow make_stress_events).
    events_kwargs = {}
    if "STRESS_SENSOR_NOISE" in os.environ:
        events_kwargs["sensor_noise"] = os.environ["STRESS_SENSOR_NOISE"] == "1"
    if "STRESS_MOTION_BLUR" in os.environ:
        events_kwargs["motion_blur"] = os.environ["STRESS_MOTION_BLUR"] == "1"
    if "STRESS_VIGNETTE" in os.environ:
        events_kwargs["vignette"] = float(os.environ["STRESS_VIGNETTE"])
    if "STRESS_NOISE_READ" in os.environ:
        events_kwargs["noise_read_dn"] = float(os.environ["STRESS_NOISE_READ"])
    if "STRESS_NOISE_SHOT" in os.environ:
        events_kwargs["noise_shot_gain"] = float(os.environ["STRESS_NOISE_SHOT"])
    if "STRESS_TEX_POOR" in os.environ:
        events_kwargs["tex_poor_depth"] = float(os.environ["STRESS_TEX_POOR"])
    if "STRESS_BLOB_POOR" in os.environ:
        events_kwargs["blob_poor_depth"] = float(os.environ["STRESS_BLOB_POOR"])
    # The fast-motion family pairs with the milder texture dip by default
    # (see make_stress_events): explicit env overrides still win.
    if os.environ.get("STRESS_GENERATOR") == "fastmotion":
        events_kwargs.setdefault("tex_poor_depth", 0.5)
        events_kwargs.setdefault("blob_poor_depth", 0.4)

    gate = 0.13
    generator = os.environ.get("STRESS_GENERATOR", "stress")
    t0 = time.time()
    runs = []
    for seed in range(seed0, seed0 + n_seeds):
        out = run_stress_gate(
            duration=duration,
            generator=generator,
            chunk=int(os.environ.get("STRESS_CHUNK", "64")),
            fcfg=fcfg,
            mcfg=mcfg,
            filter_dtype=jnp.float32,
            method=method,
            seed=seed,
            # seed 0 keeps the historical layout (lm_seed=1); other seeds
            # re-draw the landmark field too.
            lm_seed=1 if seed == 0 else 1000 + seed,
            events_kwargs=events_kwargs,
        )
        runs.append(out)
        if n_seeds > 1:
            print(
                json.dumps(
                    {
                        "seed": seed,
                        "ate_rmse": round(out.ate_rmse, 4),
                        "ate_max": round(out.ate_max, 4),
                        "min_tracks": out.min_tracks_after_ransac,
                    }
                ),
                flush=True,
            )
    wall = time.time() - t0

    ates = np.array([r.ate_rmse for r in runs])
    worst = runs[int(np.argmax(ates))]

    # STRESS_REFINE=1 (or --refine): feed the gate's VIO output through the
    # keyframe-BA refinement tier (parallel/refine.py -> distributed
    # Schur-complement BA) and report keyframe ATE before/after — the
    # flagship-artifact wiring of the new-capability tier (VERDICT round 3
    # next #6).  Gauge note: BA fixes the first keyframe pose, so it can
    # only reduce RELATIVE inconsistency; both numbers go through the same
    # Horn alignment.
    refine_stats = None
    if os.environ.get("STRESS_REFINE", "0") == "1" or "--refine" in sys.argv:
        from msckf_stereo_c.config import EUROC_CALIB
        from msckf_stereo_c.io import evaluate_ate
        from msckf_stereo_c.parallel.refine import (
            build_ba_problem,
            problem_to_body_poses,
            refine_trajectory,
        )

        r0 = worst
        stride = int(os.environ.get("STRESS_REFINE_STRIDE", "5"))
        prob = build_ba_problem(
            r0.result.times, r0.result.quats_xyzw, r0.result.positions,
            r0.result.fid, r0.result.uv, r0.result.valid,
            calib=EUROC_CALIB, keyframe_stride=stride,
            max_keyframes=int(os.environ.get("STRESS_REFINE_KF", "60")),
        )
        if prob is None:
            refine_stats = {"refine": "skipped (too few tracks/keyframes)"}
        else:
            kf = np.arange(0, len(r0.result.times), stride)[: prob.cam_q.shape[0]]
            kf_t = r0.result.times[kf]
            gt_at_kf = r0.gt_p[np.searchsorted(r0.gt_t, kf_t).clip(0, len(r0.gt_t) - 1)]
            before = evaluate_ate(kf_t, problem_to_body_poses(prob), kf_t, gt_at_kf)
            refined, costs = refine_trajectory(prob, iters=8)
            after = evaluate_ate(kf_t, problem_to_body_poses(refined), kf_t, gt_at_kf)
            refine_stats = {
                "refine_keyframes": int(prob.cam_q.shape[0]),
                "refine_landmarks": int(prob.landmarks.shape[0]),
                "refine_cost_drop": float(costs[0] / max(float(costs[-1]), 1e-30)),
                "ate_kf_before": round(float(before.rmse), 4),
                "ate_kf_after": round(float(after.rmse), 4),
            }

    print(
        json.dumps(
            {
                "metric": "stress_ate_rmse_worst" if n_seeds > 1 else "stress_ate_rmse",
                "value": round(float(ates.max()), 4),
                "unit": "m",
                "gate": gate,
                "margin_pct": round(100.0 * (1.0 - float(ates.max()) / gate), 1),
                "ate_median": round(float(np.median(ates)), 4),
                "ate_mean": round(worst.ate_mean, 4),
                "ate_max": round(worst.ate_max, 4),
                "n_seeds": n_seeds,
                "duration_s": worst.duration,
                "frames": worst.n_frames,
                "min_tracks": int(min(r.min_tracks_after_ransac for r in runs)),
                "generator": generator,
                "device": jax.devices()[0].device_kind,
                "wall_s": round(wall, 1),
                **(refine_stats or {}),
            }
        )
    )


if __name__ == "__main__":
    main()
