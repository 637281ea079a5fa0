#!/usr/bin/env python
"""Headline benchmark: full-pipeline VIO throughput (frames/s per device).

Runs the complete stereo pipeline — pyramid build, FAST detection, pyramidal
KLT tracking + stereo matching, and the MSCKF measurement update — on
synthetic EuRoC-resolution (752x480) stereo frames, on the GPU
(``BENCH_PLATFORM=cpu`` for a CPU run).  Without a GPU a GPU run stops with
an error; it never falls back to the CPU.  The JSON line names the device.

Prints ONE JSON line:
  {"metric": "vio_frames_per_sec_per_chip", "value": N, "unit": "frames/s",
   "vs_baseline": N / 40.0, "device": {...}}
Baseline: the reference C++ front-end alone takes ~25 ms/frame (=40 fps) on
the author's CPU (BASELINE.md; apps/run_euroc_muitl_threads.cpp:82).
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _env_bool(name: str, default: bool) -> bool:
    """Strict boolean env knob: only "0"/"1" (or unset) are accepted, and
    the default tracks the config-dataclass default instead of a hard-coded
    literal (ADVICE round 3: "false" silently parsed as True, and defaults
    drifted from FrontendConfig)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    if raw not in ("0", "1"):
        raise SystemExit(f"{name} must be 0 or 1, got {raw!r}")
    return raw == "1"


def bench_data(n_frames: int):
    """The bench's synthetic 752x480 stereo sequence: circle trajectory,
    wall landmarks, IMU at 200 Hz, one frame every 10 IMU samples."""
    from msckf_stereo_c.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
    from msckf_stereo_c.sim.render import render_stereo_sequence

    traj = make_circle_trajectory(duration=max(4.0, n_frames * 0.05 + 2.0))
    landmarks = make_wall_landmarks(num=600, radius=8.0, seed=1)
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    frame_idx = np.arange(0, traj.t.shape[0], 10)[:n_frames]
    img0, img1 = render_stereo_sequence(traj, landmarks, frame_idx, r_wall=8.0)
    return traj, imu, frame_idx, img0, img1


def build_batched_run(fcfg, mcfg, method, B, data, unroll=1):
    """(jitted run, args): B vmapped copies of the sequence, one lax.scan
    over the frames.  Image/IMU tensors are shared (broadcast); states are
    per sequence."""
    import jax
    import jax.numpy as jnp

    from msckf_stereo_c.config import EUROC_CALIB
    from msckf_stereo_c.models.frontend import make_frontend_params
    from msckf_stereo_c.models.msckf import make_params
    from msckf_stereo_c.models.runner import apply_gravity_init, pack_imu_batches
    from msckf_stereo_c.models.vio import init_vio_state, vio_step

    traj, imu, frame_idx, img0, img1 = data
    dtype = jnp.float32
    frame_t = traj.t[frame_idx]
    fparams = make_frontend_params(EUROC_CALIB, jnp.float32)
    mparams = make_params(mcfg, EUROC_CALIB, dtype)
    state0 = init_vio_state(fcfg, mcfg, EUROC_CALIB, img0.shape[1:], jnp.float32, dtype)
    state0 = state0._replace(
        filt=apply_gravity_init(state0.filt, imu.gyro[:200], imu.acc[:200])
    )
    batches = pack_imu_batches(imu.t, imu.gyro, imu.acc, frame_t, mcfg.max_imu_per_frame, np.float32)

    # The frame tensors are jit ARGUMENTS (broadcast via in_axes=None), not
    # closure captures: closed-over arrays are embedded as constants in the
    # HLO (~2.9 MB/frame), which bloats compile time.
    def seq_scan(state, i0s, i1s, ts, bs):
        def step(s, xs):
            i0, i1, t, b = xs
            return vio_step(s, i0, i1, t, b, fparams, mparams, fcfg, mcfg, method)

        # unroll>1 exposes cross-frame fusion to XLA (frontend of frame t+1
        # is data-independent of the filter of frame t).
        return jax.lax.scan(step, state, (i0s, i1s, ts, bs), unroll=unroll)

    run = jax.jit(jax.vmap(seq_scan, in_axes=(0, None, None, None, None)))
    states0 = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), state0)
    args = (
        states0,
        jnp.asarray(img0, jnp.float32),
        jnp.asarray(img1, jnp.float32),
        jnp.asarray(frame_t, dtype),
        jax.tree.map(jnp.asarray, batches),
    )
    return run, args


def time_run(run, args, reps):
    """Seconds per call of ``run(*args)`` (steady state) and the last poses."""
    import jax

    t0 = time.time()
    for _ in range(reps):
        _, (pose, _) = run(*args)
    jax.block_until_ready(pose.p)
    return (time.time() - t0) / reps, pose


def lane_ates(pose, data):
    """ATE RMSE (m) of every lane against the ground truth."""
    from msckf_stereo_c.io import evaluate_ate

    traj, _, frame_idx, _, _ = data
    est = np.asarray(pose.p)  # (B, T, 3)
    t = traj.t[frame_idx]
    return [evaluate_ate(t, est[b], t, traj.p[frame_idx]).rmse for b in range(est.shape[0])]


def main():
    import jax

    from msckf_stereo_c.config import FilterConfig, FrontendConfig
    from msckf_stereo_c.device import select_platform, setup_compile_cache

    select_platform(os.environ.get("BENCH_PLATFORM", "gpu"))
    setup_compile_cache()
    # IMU-seeded temporal tracking needs only the finest pyramid level
    # (validated by the ATE side-channel printed below; BENCH_TEMPORAL_LEVELS
    # to override).
    fcfg = FrontendConfig(
        temporal_levels=int(os.environ.get("BENCH_TEMPORAL_LEVELS", "1")),
        klt_impl=os.environ.get("BENCH_KLT", FrontendConfig.klt_impl),
        matmul_precision=os.environ.get(
            "BENCH_FRONTEND_PRECISION", FrontendConfig.matmul_precision
        ),
        anchor_refine=_env_bool("BENCH_ANCHOR_REFINE", FrontendConfig.anchor_refine),
        translation_seed=_env_bool(
            "BENCH_TRANSLATION_SEED", FrontendConfig.translation_seed
        ),
        stereo_lr_threshold=float(
            os.environ.get("BENCH_STEREO_LR", FrontendConfig.stereo_lr_threshold)
        ),
        # Scope of the LR round trip (False = candidates-only, a
        # benign-scene throughput measurement; see FrontendConfig).
        stereo_lr_survivors=_env_bool(
            "BENCH_STEREO_LR_SURVIVORS", FrontendConfig.stereo_lr_survivors
        ),
        cand_level1=_env_bool("BENCH_CAND_LEVEL1", FrontendConfig.cand_level1),
        # Photometric normalization of the corr-path LK (see
        # FrontendConfig.klt_norm; default 'none').
        klt_norm=os.environ.get("BENCH_KLT_NORM", FrontendConfig.klt_norm),
    )
    mcfg = FilterConfig(
        ns_iters=int(os.environ.get("BENCH_NS_ITERS", FilterConfig.ns_iters)),
        matmul_precision=os.environ.get(
            "BENCH_FILTER_PRECISION", FilterConfig.matmul_precision
        ),
        noise_adaptive=_env_bool("BENCH_NOISE_ADAPTIVE", FilterConfig.noise_adaptive),
    )
    n_frames = int(os.environ.get("BENCH_FRAMES", "100"))
    method = os.environ.get("BENCH_METHOD", "schur")
    # Batched-sequence data parallelism: B VIO sequences run vmapped on the
    # one device (the engine's throughput axis — multi-run EuRoC
    # evaluation; BASELINE.json config 3).
    B = int(os.environ.get("BENCH_BATCH", "16"))
    reps = int(os.environ.get("BENCH_REPS", "3"))

    data = bench_data(n_frames)
    run, args = build_batched_run(
        fcfg, mcfg, method, B, data, unroll=int(os.environ.get("BENCH_UNROLL", "1"))
    )
    t0 = time.time()
    jax.block_until_ready(run(*args)[1][0].p)  # warmup/compile
    compile_time = time.time() - t0
    dt, pose = time_run(run, args, reps)

    fps = B * n_frames / dt
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "vio_frames_per_sec_per_chip",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / 40.0, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    # Accuracy side-channel (stderr): all lanes run identical inputs, so the
    # per-lane ATE spread probes batch-tiling-dependent rounding.
    ates = lane_ates(pose, data)
    print(
        f"# device={dev.device_kind} frames={n_frames} batch={B} "
        f"reps={reps} compile={compile_time:.1f}s run={dt:.3f}s method={method} "
        f"ate_rmse={ates[0]:.4f}m ate_rmse_worst_lane={max(ates):.4f}m",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
