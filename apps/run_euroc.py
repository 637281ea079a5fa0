#!/usr/bin/env python
"""EuRoC VIO driver — the equivalent of the reference's
``run_euroc_single_thread`` app (apps/run_euroc_single_thread.cpp:116-324).

Usage:
    python apps/run_euroc.py <path-to>/mav0 [--out pose_out.txt]
        [--chunk 128] [--platform gpu|cpu] [--method qr|cholesky|schur]
        [--camchain config/camchain-imucam-euroc.yaml] [--ate]

Streams the dataset in chunks: each chunk of stereo frames + per-frame IMU
batches is one device program (frontend KLT + MSCKF update fused); poses are
written in TUM format and optionally scored against the bundled ground
truth with the in-repo ATE evaluator.  ``main(argv)`` returns the run's
poses, tracking counters and ATE for in-process callers.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mav0", help="path to the EuRoC sequence's mav0 directory")
    ap.add_argument("--out", default="pose_out.txt")
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"])
    ap.add_argument("--method", default="schur", choices=["qr", "cholesky", "schur"])
    ap.add_argument("--camchain", default=None)
    ap.add_argument("--imgproc-config", default=None)
    ap.add_argument("--msckf-config", default=None)
    ap.add_argument("--f64", action="store_true", help="run the filter in float64")
    ap.add_argument("--ate", action="store_true", help="evaluate ATE against ground truth")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument(
        "--debug-dump", default=None,
        help="write per-frame tracking counters (the reference's debug_imageprocessor.txt)",
    )
    ap.add_argument(
        "--viewer", nargs="?", const=8642, type=int, default=None, metavar="PORT",
        help="serve a live 3D trajectory view at http://localhost:PORT/ "
        "(the headless replacement for the reference's Pangolin window, "
        "run_euroc_single_thread.cpp:131-148)",
    )
    ap.add_argument(
        "--dump-filter-frame", type=int, default=None,
        help="dump the update-phase filter internals (Jacobian blocks, "
        "projected rows, gating scores) at this frame index to "
        "--dump-filter-out; the reference's frame-9 differential dump "
        "(msckf_vio.cpp:719-723)",
    )
    ap.add_argument("--dump-filter-out", default="debug_msckfvio.npz")
    ap.add_argument(
        "--cov-out", default=None,
        help="write a per-pose position-covariance sidecar "
        "(t p11 p12 p13 p22 p23 p33; the reference marshals this block "
        "then discards it, msckf_vio.cpp:1262-1293)",
    )
    args = ap.parse_args(argv)

    import jax

    from msckf_stereo_c.device import select_platform, setup_compile_cache

    select_platform(args.platform)
    setup_compile_cache()
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from msckf_stereo_c.config import (
        EUROC_CALIB,
        FilterConfig,
        FrontendConfig,
        load_camchain,
        load_filter_config,
        load_frontend_config,
    )
    from msckf_stereo_c.io import evaluate_ate, write_tum
    from msckf_stereo_c.io.euroc import ImageSource, load_sequence, synchronize_stereo
    from msckf_stereo_c.models.vio import run_vio_sequence

    calib = load_camchain(args.camchain) if args.camchain else EUROC_CALIB
    fcfg = load_frontend_config(args.imgproc_config) if args.imgproc_config else FrontendConfig()
    mcfg = load_filter_config(args.msckf_config) if args.msckf_config else FilterConfig()

    print(f"loading sequence {args.mav0} ...")
    seq = load_sequence(args.mav0)
    times, files0, files1 = synchronize_stereo(seq)
    if args.max_frames:
        times, files0, files1 = times[: args.max_frames], files0[: args.max_frames], files1[: args.max_frames]
    print(f"{len(times)} stereo frames, {len(seq.imu.t)} IMU samples")

    # Rebase timestamps to the sequence start BEFORE they are cast to the
    # device dtype: absolute EuRoC epoch times (~1.4e9 s) have a float32
    # resolution of ~128 s, which collapses the 0.05 s frame spacing to
    # zero (no propagation, constant output).  Absolute times are restored
    # for the TUM output / ATE association below.
    t_base = float(min(times[0], seq.imu.t[0]))
    times = times - t_base
    imu_t = seq.imu.t - t_base

    filter_dtype = jnp.float64 if args.f64 else jnp.float32

    # Stream decode + run in chunks to bound host memory.  Per-phase timing
    # + the frame-budget overrun report are the production analog of the
    # reference's red-ANSI featureCallback timers (msckf_vio.cpp:321-372).
    from msckf_stereo_c.utils.timing import PhaseTimer

    timer = PhaseTimer(frame_budget_s=1.0 / mcfg.frame_rate)
    t_start = time.time()
    state = None
    all_res = []

    viewer = None
    if args.viewer is not None:
        from msckf_stereo_c.io.live_viewer import LiveViewer

        viewer = LiveViewer(port=args.viewer)
        port = viewer.start()
        print(f"live viewer at http://localhost:{port}/")

    # Chunked decode + run, with decode/compute OVERLAP: one native
    # prefetch stream per camera stays open across the whole run, so its
    # C++ worker threads decode chunk N+1's PNGs while chunk N runs on the
    # device — the decode phase below measures only the residual wait
    # (~0 after chunk 0 when decode keeps up).  This is the reference's
    # producer/consumer pipeline (run_euroc_muitl_threads.cpp:30-90)
    # without its front-end/back-end race.
    c = args.chunk
    # Context managers so an exception in the chunk loop cannot leak the
    # native decoder threads; 3 threads per stream (two concurrent streams
    # on a small host — decode stays ahead of the device at this depth).
    with ImageSource(files0, prefetch=max(c, 64), threads=3) as src0, \
         ImageSource(files1, prefetch=max(c, 64), threads=3) as src1:
      for s0 in range(0, len(times), c):
        s1 = min(s0 + c, len(times))
        with timer.phase("decode_images"):
            imgs0 = src0.next(s1 - s0)
            imgs1 = src1.next(s1 - s0)
        t_chunk = time.time()
        dump_local = None
        if args.dump_filter_frame is not None and s0 <= args.dump_filter_frame < s1:
            dump_local = args.dump_filter_frame - s0
        with timer.phase("vio_chunk"):
            r = run_vio_sequence(
                fcfg, mcfg, calib,
                times[s0:s1], imgs0, imgs1,
                imu_t, seq.imu.gyro, seq.imu.acc,
                filter_dtype=filter_dtype,
                method=args.method,
                state=state,
                internals_at=dump_local,
                prev_frame_t=float(times[s0 - 1]) if s0 > 0 else None,
            )
        if r.internals is not None:
            import numpy as _np

            _np.savez_compressed(args.dump_filter_out, **{k: _np.asarray(v) for k, v in r.internals.items()})
            print(f"wrote filter internals for frame {args.dump_filter_frame} -> {args.dump_filter_out}")
        # Budget check at chunk granularity (mean frame time over the chunk;
        # the first chunk absorbs compilation and will overrun by design).
        timer.frame_done((time.time() - t_chunk) / (s1 - s0))
        state = r.final_state
        all_res.append(r)
        if viewer is not None:
            viewer.publish(r.positions, frame=s1)
        el = time.time() - t_start
        print(f"  frames {s1}/{len(times)}  ({s1/el:.1f} fps cumulative)")

    import numpy as np

    # float64 BEFORE re-adding the epoch base (f32 + big python float stays
    # f32 under NumPy's weak promotion and would re-collapse the spacing).
    times_out = np.concatenate([r.times for r in all_res]).astype(np.float64) + t_base
    pos = np.concatenate([r.positions for r in all_res])
    quat = np.concatenate([r.quats_xyzw for r in all_res])
    write_tum(args.out, times_out, pos, quat)
    if args.debug_dump:
        # TrackingInfo counters per frame (reference image_processor.cpp:1174-1179).
        with open(args.debug_dump, "w") as f:
            f.write("# time before_tracking after_tracking after_matching after_ransac\n")
            bt = np.concatenate([r.tracking["before_tracking"] for r in all_res])
            at = np.concatenate([r.tracking["after_tracking"] for r in all_res])
            am = np.concatenate([r.tracking["after_matching"] for r in all_res])
            ar = np.concatenate([r.tracking["after_ransac"] for r in all_res])
            for i in range(len(times_out)):
                f.write(f"{times_out[i]:.6f} {bt[i]} {at[i]} {am[i]} {ar[i]}\n")
    if args.cov_out:
        cov = np.concatenate([r.pos_cov for r in all_res])  # (T, 3, 3)
        with open(args.cov_out, "w") as f:
            f.write("# time p11 p12 p13 p22 p23 p33\n")
            for i in range(len(times_out)):
                c_ = cov[i]
                f.write(
                    f"{times_out[i]:.6f} {c_[0,0]:.9e} {c_[0,1]:.9e} {c_[0,2]:.9e} "
                    f"{c_[1,1]:.9e} {c_[1,2]:.9e} {c_[2,2]:.9e}\n"
                )
    wall = time.time() - t_start
    print(f"wrote {args.out}; {len(times)} frames in {wall:.1f}s = {len(times)/wall:.1f} fps")
    print(timer.report())
    if timer.overruns:
        # The reference prints its overrun report in red ANSI (msckf_vio.cpp:363-372).
        print(
            f"\x1b[31m{timer.overruns} chunk(s) exceeded the "
            f"{1.0 / mcfg.frame_rate * 1e3:.0f} ms/frame budget\x1b[0m"
        )

    ate = None
    if args.ate and seq.gt is not None:
        ate = evaluate_ate(times_out, pos, seq.gt.t, seq.gt.p)
        print(
            f"ATE RMSE {ate.rmse:.6f} m  mean {ate.mean:.4f}  median {ate.median:.4f} "
            f"std {ate.std:.4f}  min {ate.min:.4f}  max {ate.max:.4f}  pairs {ate.num_pairs}"
        )
    tracking = {
        k: np.concatenate([r.tracking[k] for r in all_res])
        for k in all_res[0].tracking
    }
    return {"times": times_out, "positions": pos, "quats_xyzw": quat,
            "tracking": tracking, "ate": ate}


if __name__ == "__main__":
    main()
