#!/usr/bin/env python
"""Batched multi-sequence EuRoC evaluation: run several sequences on one
device as a vmapped batch (BASELINE.json config 3, "MH_01-MH_05 machine-hall
batch ... on one chip").

Usage:
    python apps/run_euroc_batch.py <seqA>/mav0 <seqB>/mav0 ... \
        [--out-dir poses/] [--chunk 64] [--ate]

Each sequence gets its own tracker/filter state; images and IMU batches are
stacked on a leading batch axis and every chunk is one vmapped scanned
device program.  Sequences shorter than the longest are padded with repeats
of their last frame (masked out of the outputs)."""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mav0", nargs="+")
    ap.add_argument("--out-dir", default="poses")
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--method", default="schur")
    ap.add_argument("--ate", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args(argv)

    import jax

    from msckf_stereo_c.device import select_platform, setup_compile_cache

    select_platform(args.platform)
    setup_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from msckf_stereo_c.config import EUROC_CALIB, FilterConfig, FrontendConfig
    from msckf_stereo_c.io import evaluate_ate, write_tum
    from msckf_stereo_c.io.euroc import load_images, load_sequence, synchronize_stereo
    from msckf_stereo_c.models.frontend import make_frontend_params
    from msckf_stereo_c.models.msckf import make_params
    from msckf_stereo_c.models.runner import apply_gravity_init, pack_imu_batches
    from msckf_stereo_c.models.vio import init_vio_state, vio_step

    fcfg = FrontendConfig()
    mcfg = FilterConfig()
    dtype = jnp.float32
    fparams = make_frontend_params(EUROC_CALIB, jnp.float32)
    mparams = make_params(mcfg, EUROC_CALIB, dtype)

    B = len(args.mav0)
    seqs = []
    for path in args.mav0:
        seq = load_sequence(path)
        times, f0, f1 = synchronize_stereo(seq)
        if args.max_frames:
            times, f0, f1 = times[: args.max_frames], f0[: args.max_frames], f1[: args.max_frames]
        seqs.append((path, seq, times, f0, f1))
    T = max(len(s[2]) for s in seqs)
    print(f"{B} sequences, padded length {T}")

    states = []
    for path, seq, times, f0, f1 in seqs:
        st = init_vio_state(fcfg, mcfg, EUROC_CALIB, (480, 752), jnp.float32, dtype)
        n0 = min(mcfg.imu_init_samples, len(seq.imu.t))
        st = st._replace(filt=apply_gravity_init(st.filt, seq.imu.gyro[:n0], seq.imu.acc[:n0]))
        states.append(st)
    bstate = jax.tree.map(lambda *xs: jnp.stack(xs), *states)

    step = jax.vmap(
        lambda s, i0, i1, t, b: vio_step(s, i0, i1, t, b, fparams, mparams, fcfg, mcfg, args.method)
    )

    @jax.jit
    def chunk_fn(state, imgs0, imgs1, times, imu):
        def one(s, xs):
            i0, i1, t, b = xs
            return step(s, i0, i1, t, b)

        return jax.lax.scan(one, state, (imgs0, imgs1, times, imu))

    def frame_time(bi, k):
        times = seqs[bi][2]
        return times[min(k, len(times) - 1)]

    batches = []
    for path, seq, times, f0, f1 in seqs:
        t_pad = np.array([frame_time(seqs.index((path, seq, times, f0, f1)), k) for k in range(T)])
        batches.append(pack_imu_batches(seq.imu.t, seq.imu.gyro, seq.imu.acc, t_pad, mcfg.max_imu_per_frame, np.float32))
    imu_all = jax.tree.map(lambda *xs: jnp.stack(xs), *batches)

    os.makedirs(args.out_dir, exist_ok=True)
    all_p = [[] for _ in range(B)]
    all_q = [[] for _ in range(B)]
    t_start = time.time()
    for s0 in range(0, T, args.chunk):
        s1 = min(s0 + args.chunk, T)
        i0 = np.stack(
            [load_images([seqs[b][3][min(k, len(seqs[b][3]) - 1)] for k in range(s0, s1)]) for b in range(B)]
        )
        i1 = np.stack(
            [load_images([seqs[b][4][min(k, len(seqs[b][4]) - 1)] for k in range(s0, s1)]) for b in range(B)]
        )
        tt = np.stack([[frame_time(b, k) for k in range(s0, s1)] for b in range(B)])
        bstate, (pose, _) = chunk_fn(
            bstate,
            jnp.asarray(i0.transpose(1, 0, 2, 3), jnp.float32),
            jnp.asarray(i1.transpose(1, 0, 2, 3), jnp.float32),
            jnp.asarray(tt.T, dtype),
            jax.tree.map(lambda x: jnp.swapaxes(x[:, s0:s1], 0, 1), imu_all),
        )
        p = np.asarray(pose.p)  # (chunk, B, 3)
        q = np.asarray(pose.q_xyzw)
        for b in range(B):
            all_p[b].append(p[:, b])
            all_q[b].append(q[:, b])
        done = s1 * B
        print(f"  {s1}/{T} frames x {B} seqs  ({done / (time.time() - t_start):.1f} fps aggregate)")

    for b, (path, seq, times, _, _) in enumerate(seqs):
        n = len(times)
        p = np.concatenate(all_p[b])[:n]
        q = np.concatenate(all_q[b])[:n]
        name = os.path.basename(os.path.dirname(path.rstrip("/"))) or f"seq{b}"
        out = os.path.join(args.out_dir, f"pose_{name}.txt")
        write_tum(out, times, p, q)
        print(f"wrote {out}")
        if args.ate and seq.gt is not None:
            ate = evaluate_ate(times, p, seq.gt.t, seq.gt.p)
            print(f"  {name}: ATE RMSE {ate.rmse:.4f} m ({ate.num_pairs} pairs)")


if __name__ == "__main__":
    main()
