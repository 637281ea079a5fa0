#!/usr/bin/env python
"""Quickest proof that the VIO engine runs on the GPU, end to end.

    python chip_smoke.py           # one GPU: device, kernels, main path
    python chip_smoke.py --four    # four GPUs: the sharded multi-sequence path

Phases (any failure ends the run with a non-zero exit and no result line):

  device     refuse anything but a GPU backend; print the device kind and
             count and the card's name and power limit from nvidia-smi.
  kernels    the Triton LK-iteration kernel against the XLA while_loop
             reference at the frontend's real widths (B=16 lanes x 96
             features, P=15, S=35 -> K=21), both at "highest" matmul
             precision: identical valid flags, <= 0.05 px on converged
             lanes; prints the time of both.
  main path  writes a synthetic 752x480 EuRoC mav0 (100 frames) and runs
             ``apps/run_euroc.py --platform gpu --ate`` in this process at
             the flagship configuration; requires finite poses, >= 40
             tracked features per frame after frame 5 and ATE <= 0.13 m,
             and prints the ATE beside the CPU float64 'qr' reference on the
             same data (a JAX_PLATFORMS=cpu subprocess, off the GPU).
  --four     only: four different synthetic sequences sharded over a
             4-device mesh (``make_sharded_vio_runner``) against the
             single-card vmap of the same lanes.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

ATE_BAR_M = 0.13
KLT_TOL_PX = 0.05
MIN_TRACKED = 40
FOUR_POS_TOL_M = 1e-3
FOUR_QUAT_TOL = 1e-4
FOUR_FID_MATCH = 0.98


def log(msg):
    print(msg, flush=True)


def _time(fn, *args, reps=20):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def phase_device(expect_count):
    import jax

    from msckf_stereo_c.device import select_platform, setup_compile_cache

    select_platform("gpu")
    setup_compile_cache()
    devs = jax.devices()
    if jax.default_backend() != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {jax.default_backend()}")
    if len(devs) < expect_count:
        raise RuntimeError(f"need {expect_count} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"[device] {devs[0].device_kind} x{len(devs)} (platform {devs[0].platform})")
    log(f"[device] nvidia-smi: {smi}")
    return devs


def _frame_pair():
    """Two consecutive 752x480 frames of the synthetic scene."""
    import numpy as np

    from msckf_stereo_c.sim import make_circle_trajectory, make_wall_landmarks
    from msckf_stereo_c.sim.render import render_stereo_sequence

    traj = make_circle_trajectory(duration=2.0)
    lms = make_wall_landmarks(num=600, radius=8.0, seed=1)
    img0, _ = render_stereo_sequence(traj, lms, np.array([100, 110]), r_wall=8.0)
    return img0[0], img0[1]


def phase_kernels(B=16, N=96, loop="triton", reps=20):
    """The LK-iteration kernel against the XLA loop at real widths."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from msckf_stereo_c.ops import klt_corr as kc

    prev, curr = (jnp.asarray(x, jnp.float32) for x in _frame_pair())
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(30, 720, (B, N)), rng.uniform(30, 450, (B, N))], -1)
    pts = jnp.asarray(pts, jnp.float32)
    guess = pts + jnp.asarray(rng.uniform(-1.5, 1.5, (B, N, 2)), jnp.float32)
    valid = jnp.ones((B, N), bool)
    win, iters, eps = 15, 30, 0.01

    def lk(impl):
        return jax.jit(jax.vmap(
            lambda p, g, v: kc.optical_flow_lk_corr_l0(
                prev, curr, p, g, v, win, iters, eps, loop=impl)[0]
        ))

    # The loop alone, on identical surfaces: one kernel launch against the
    # while_loop with a data-dependent exit.
    S = win + 2 * kc._SEARCH_RADIUS + 2

    def surfaces(p, g):
        sp = kc._interp_template(prev, p, win)
        tq = kc._template_quantities(sp, win)
        H, W = curr.shape
        sorg = jnp.clip(jnp.floor(g) - S // 2, 0, jnp.array([W - S, H - S], jnp.float32))
        Cx, Cy = kc._corr_surfaces(kc._extract_at_origins(curr, sorg, S), tq.gx, tq.gy, win)
        return Cx, Cy, tq, g - (win - 1) / 2.0 - sorg

    def loop_only(impl):
        def one(Cx, Cy, tq, f0):
            return kc._run_iterations(Cx, Cy, None, tq, f0, ~tq.good, iters, eps, S, win, impl)
        return jax.jit(jax.vmap(one))

    with jax.default_matmul_precision("highest"):
        ref, got = lk("xla")(pts, guess, valid), lk(loop)(pts, guess, valid)
        args = jax.jit(jax.vmap(surfaces))(pts, guess)
        t_lk = {i: _time(lk(i), pts, guess, valid, reps=reps) for i in ("xla", loop)}
        t_loop = {i: _time(loop_only(i), *args, reps=reps) for i in ("xla", loop)}
        K = args[0].shape[-1]
    v_ref, v_got = np.asarray(ref.valid), np.asarray(got.valid)
    if not np.array_equal(v_ref, v_got):
        raise RuntimeError(f"valid flags differ on {int((v_ref != v_got).sum())} lanes")
    err = np.abs(np.asarray(ref.pts) - np.asarray(got.pts))[v_ref].max()
    log(
        f"[kernels] klt_lk_iterate ({loop}) vs XLA while_loop: B={B} N={N} "
        f"P={win} S={S} K={K} (K*K={K * K}); precision 'highest' both sides "
        f"(the kernel itself is elementwise f32); {int(v_ref.sum())}/{v_ref.size} "
        f"converged lanes, max |dpts| {err:.2e} px (tol {KLT_TOL_PX}), valid identical"
    )
    log(
        f"[kernels] time per call: LK level {t_lk[loop] * 1e3:.3f} ms ({loop}) vs "
        f"{t_lk['xla'] * 1e3:.3f} ms (xla); loop alone {t_loop[loop] * 1e3:.3f} ms "
        f"vs {t_loop['xla'] * 1e3:.3f} ms"
    )
    if not err <= KLT_TOL_PX:
        raise RuntimeError(f"kernel off by {err} px > {KLT_TOL_PX}")
    if v_ref.mean() < 0.5:
        raise RuntimeError(f"only {v_ref.mean():.2f} of lanes converged")


def write_synthetic_euroc(root, n_frames=100):
    """A synthetic EuRoC mav0 (752x480 PNGs, IMU and ground-truth CSVs), as
    tests/test_euroc_io.py builds it but on the bench's denser wall (600
    landmarks); the PNGs come from the stdlib encoder, Paeth-filtered as
    common writers store camera images."""
    import numpy as np

    from msckf_stereo_c.io.png import write_gray8
    from msckf_stereo_c.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
    from msckf_stereo_c.sim.render import render_stereo_sequence

    traj = make_circle_trajectory(duration=n_frames * 0.05 + 1.0)
    lms = make_wall_landmarks(num=600, radius=8.0, seed=1)
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    frame_idx = np.arange(0, traj.t.shape[0], 10)[:n_frames]
    img0, img1 = render_stereo_sequence(traj, lms, frame_idx, r_wall=8.0)
    t0_ns = 1403636579758555520
    ns = lambda t: t0_ns + int(round(t * 1e9))  # noqa: E731
    os.makedirs(os.path.join(root, "imu0"))
    with open(os.path.join(root, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for i in range(len(imu.t)):
            g, a = imu.gyro[i], imu.acc[i]
            f.write(f"{ns(imu.t[i])},{g[0]},{g[1]},{g[2]},{a[0]},{a[1]},{a[2]}\n")
    for cam, imgs in (("cam0", img0), ("cam1", img1)):
        os.makedirs(os.path.join(root, cam, "data"))
        with open(os.path.join(root, cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for k, i in enumerate(frame_idx):
                name = f"{ns(traj.t[i])}.png"
                write_gray8(os.path.join(root, cam, "data", name),
                            np.clip(imgs[k], 0, 255).astype(np.uint8))
                f.write(f"{ns(traj.t[i])},{name}\n")
    os.makedirs(os.path.join(root, "state_groundtruth_estimate0"))
    with open(os.path.join(root, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp,px,py,pz,qw,qx,qy,qz\n")
        for i in frame_idx:
            p = traj.p[i]
            f.write(f"{ns(traj.t[i])},{p[0]},{p[1]},{p[2]},1,0,0,0\n")


def start_cpu_reference(mav0, out_dir, log_file):
    """The float64 'qr' filter on the CPU, in a subprocess that never opens
    the GPU, writing to ``log_file``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, os.path.join(ROOT, "apps", "run_euroc.py"), mav0,
           "--platform", "cpu", "--f64", "--method", "qr", "--ate",
           "--out", os.path.join(out_dir, "pose_cpu_f64.txt")]
    return subprocess.Popen(cmd, env=env, stdout=log_file, stderr=subprocess.STDOUT)


def _ate_from_log(log_path):
    with open(log_path) as f:
        for line in f:
            if line.startswith("ATE RMSE"):
                return float(line.split()[2])
    return None


def log_png_decode(mav0, n=32):
    """Which decoder the main path reads the PNGs with, and the time per
    frame of the standard-library one (the fallback) on ``n`` frames."""
    from msckf_stereo_c.io import native
    from msckf_stereo_c.io.png import read_gray8_batch

    data = os.path.join(mav0, "cam0", "data")
    files = sorted(os.path.join(data, f) for f in os.listdir(data))[:n]
    t0 = time.perf_counter()
    read_gray8_batch(files)
    per_frame = (time.perf_counter() - t0) / len(files)
    state = "available" if native.available() else "not available (make -C native)"
    log(f"[main] PNG decode: native runtime {state}; stdlib decoder "
        f"{per_frame * 1e3:.1f} ms/frame (752x480 Paeth, {len(files)} frames)")


def phase_main_path(n_frames=100, platform="gpu"):
    import numpy as np

    from apps.run_euroc import main as run_euroc

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        mav0 = os.path.join(tmp, "mav0")
        t0 = time.time()
        write_synthetic_euroc(mav0, n_frames)
        log(f"[main] synthetic mav0: {n_frames} frames 752x480 ({time.time() - t0:.1f} s)")
        log_png_decode(mav0)
        ref_log = os.path.join(tmp, "cpu_reference.log")
        with open(ref_log, "w") as ref_out:
            ref = start_cpu_reference(mav0, tmp, ref_out)
            try:
                t0 = time.time()
                out = run_euroc([mav0, "--platform", platform, "--ate",
                                 "--out", os.path.join(tmp, "pose.txt")])
                wall = time.time() - t0
                ref_rc = ref.wait(timeout=900)
            finally:
                if ref.poll() is None:
                    ref.kill()
                    ref.wait()
        ref_ate = _ate_from_log(ref_log)
        if ref_rc != 0 or ref_ate is None:
            with open(ref_log) as f:
                sys.stderr.write(f.read()[-4000:])
            raise RuntimeError(f"CPU reference failed (rc={ref_rc})")

    pos, ate = out["positions"], out["ate"]
    tracked = out["tracking"]["after_tracking"][5:]
    log(
        f"[main] apps/run_euroc.py --platform {platform}: {len(pos)} poses in "
        f"{wall:.1f} s (compile included); min tracked after frame 5: "
        f"{int(tracked.min())}; ATE RMSE {ate.rmse:.6f} m (bar {ATE_BAR_M}) vs CPU "
        f"f64 qr reference {ref_ate:.6f} m"
    )
    if pos.shape != (n_frames, 3) or not np.all(np.isfinite(pos)):
        raise RuntimeError(f"bad poses: shape {pos.shape}, finite {np.isfinite(pos).all()}")
    if tracked.min() < MIN_TRACKED:
        raise RuntimeError(f"tracking fell to {tracked.min()} < {MIN_TRACKED} features")
    if not ate.rmse <= ATE_BAR_M:
        raise RuntimeError(f"ATE {ate.rmse} m > {ATE_BAR_M} m")


def phase_four(n_dev=4, fcfg=None, mcfg=None):
    """Four different sequences sharded over a 4-device mesh, each lane
    against the single-card vmap of the same lanes (flagship configuration
    unless ``fcfg``/``mcfg`` say otherwise)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from msckf_stereo_c.config import EUROC_CALIB, FilterConfig, FrontendConfig
    from msckf_stereo_c.models.frontend import make_frontend_params
    from msckf_stereo_c.models.msckf import make_params
    from msckf_stereo_c.models.runner import pack_imu_batches
    from msckf_stereo_c.models.vio import vio_step
    from msckf_stereo_c.parallel.multiseq import make_mesh
    from msckf_stereo_c.parallel.vio_multiseq import (
        batched_gravity_init,
        batched_init_vio_state,
        make_sharded_vio_runner,
    )
    from msckf_stereo_c.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
    from msckf_stereo_c.sim.render_jax import JaxRenderer, StressEvents

    fcfg, mcfg, method = fcfg or FrontendConfig(), mcfg or FilterConfig(), "schur"
    fparams = make_frontend_params(EUROC_CALIB, jnp.float32)
    mparams = make_params(mcfg, EUROC_CALIB, jnp.float32)
    # T = M+2 frames: the camera window fills and is pruned under shard_map.
    B, T = n_dev, mcfg.max_cam_state_size + 2
    traj = make_circle_trajectory(duration=8.0)
    lms = make_wall_landmarks(num=400, radius=8.0, seed=1)
    sim_imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    renderer = JaxRenderer(np.asarray(lms), r_wall=8.0)
    imgs0, imgs1, times, imus = [], [], [], []
    for b in range(B):  # each lane starts at its own trajectory offset
        idx = np.arange(320, 320 + 10 * T, 10) + 10 * b
        i0, i1 = renderer.render_sequence(traj, idx, StressEvents.nominal(T))
        imgs0.append(np.asarray(i0))
        imgs1.append(np.asarray(i1))
        times.append(traj.t[idx].astype(np.float32))
        imus.append(pack_imu_batches(sim_imu.t, sim_imu.gyro, sim_imu.acc, traj.t[idx],
                                     mcfg.max_imu_per_frame, np.float32))
    data = (np.stack(imgs0), np.stack(imgs1), np.stack(times),
            jax.tree.map(lambda *xs: np.stack(xs), *imus))
    states = batched_init_vio_state(fcfg, mcfg, EUROC_CALIB, data[0].shape[2:], B)
    states = batched_gravity_init(
        states,
        jnp.broadcast_to(jnp.asarray(sim_imu.gyro[:200], jnp.float32), (B, 200, 3)),
        jnp.broadcast_to(jnp.asarray(sim_imu.acc[:200], jnp.float32), (B, 200, 3)),
    )

    run = make_sharded_vio_runner(make_mesh(n_dev), fparams, mparams, fcfg, mcfg, method)

    def seq_scan(state, i0s, i1s, ts, imu_seq):
        def step(s, xs):
            return vio_step(s, *xs, fparams, mparams, fcfg, mcfg, method)
        return jax.lax.scan(step, state, (i0s, i1s, ts, imu_seq))

    one_args = jax.device_put((states,) + data, jax.devices()[0])
    # The two programs compile concurrently (XLA compiles off the GIL).
    t0 = time.time()
    with ThreadPoolExecutor(2) as ex:
        sharded = ex.submit(lambda: run.lower(states, *data).compile())
        single = ex.submit(lambda: jax.jit(jax.vmap(seq_scan)).lower(*one_args).compile())
        sharded, single = sharded.result(), single.result()
    t_compile = time.time() - t0
    t0 = time.time()
    sh_states, sh_poses, sh_fronts, metrics = sharded(states, *data)
    jax.block_until_ready(sh_poses.p)
    t_sharded = time.time() - t0
    t0 = time.time()
    one_states, (one_poses, one_fronts) = single(*one_args)
    jax.block_until_ready(one_poses.p)
    t_single = time.time() - t0

    dp = np.abs(np.asarray(sh_poses.p) - np.asarray(one_poses.p)).max(axis=(1, 2))
    dq = np.abs(np.asarray(sh_poses.q_xyzw) - np.asarray(one_poses.q_xyzw)).max(axis=(1, 2))
    fid_match = (np.asarray(sh_fronts.fid) == np.asarray(one_fronts.fid)).mean(axis=(1, 2))
    cams = np.asarray(sh_states.filt.num_cams)
    for b in range(B):
        log(f"[four] lane {b}: max |dp| {dp[b]:.3e} m (tol {FOUR_POS_TOL_M}), max |dq| "
            f"{dq[b]:.3e} (tol {FOUR_QUAT_TOL}), track ids equal {fid_match[b]:.4f} "
            f"(min {FOUR_FID_MATCH}), num_cams {cams[b]}")
    log(f"[four] 1-D mesh of {n_dev} devices (one lane per card), T={T} frames; sharded "
        f"{t_sharded:.2f} s vs single-card vmap {t_single:.2f} s (first call after "
        f"{t_compile:.1f} s of concurrent compilation); "
        f"psum total_tracks {int(metrics['total_tracks'])}")
    if not (np.all(np.isfinite(np.asarray(sh_poses.p))) and dp.max() <= FOUR_POS_TOL_M
            and dq.max() <= FOUR_QUAT_TOL and fid_match.min() >= FOUR_FID_MATCH):
        raise RuntimeError("sharded lanes disagree with the single-card run")
    if cams.min() < mcfg.max_cam_state_size - 2:
        raise RuntimeError(f"camera window did not fill and prune: {cams}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU sharded multi-sequence phase")
    args = ap.parse_args(argv)
    devs = phase_device(4 if args.four else 1)
    if args.four:
        phase_four(4)
    else:
        phase_kernels()
        phase_main_path()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}}))


if __name__ == "__main__":
    main()
