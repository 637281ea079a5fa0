"""Multi-device scaling efficiency of the sharded multi-sequence filter.

North-star: >=80% scaling efficiency at N>=2 (BASELINE.md).  This script
runs the collective path on a virtual CPU mesh (the same shard_map program
the driver dry-runs); on several GPUs the identical code shards over the
cards.

Weak scaling: B=N sequences over N devices vs N sequences on 1 device.

NOTE: on a virtual CPU mesh the N "devices" share the same physical cores
and host-side collectives dominate, so the efficiency numbers printed here
are NOT hardware-meaningful — this script exists to exercise the sharded
program end-to-end.  Real efficiency must be measured on several GPUs,
where each mesh element is a card."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
import jax

from msckf_stereo_c.device import select_platform, setup_compile_cache  # noqa: E402

select_platform("cpu")
setup_compile_cache()

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from msckf_stereo_c.config import EUROC_CALIB, FilterConfig
from msckf_stereo_c.models.msckf import FrameFeatures, make_params
from msckf_stereo_c.models.propagation import ImuBatch
from msckf_stereo_c.parallel.multiseq import batched_init_state, make_sharded_runner

cfg = FilterConfig(max_cam_state_size=8, max_tracks=48, max_imu_per_frame=10)
dtype = jnp.float32
params = make_params(cfg, EUROC_CALIB, dtype)
T, F, L = 20, 32, cfg.max_imu_per_frame
rng = np.random.default_rng(0)


def make_batch(B):
    frames = FrameFeatures(
        time=jnp.asarray(np.tile(np.arange(1, T + 1) * 0.05, (B, 1)), dtype),
        fid=jnp.asarray(np.tile(np.arange(F), (B, T, 1)), jnp.int32),
        uv=jnp.asarray(rng.uniform(-0.3, 0.3, (B, T, F, 4)), dtype),
        valid=jnp.ones((B, T, F), bool),
    )
    imu_t = np.tile(np.linspace(0.005, 0.05, L), (B, T, 1)) + np.arange(T)[None, :, None] * 0.05
    imu = ImuBatch(
        time=jnp.asarray(imu_t, dtype),
        gyro=jnp.asarray(rng.normal(0, 0.01, (B, T, L, 3)), dtype),
        acc=jnp.asarray(
            np.tile([0, 0, 9.81], (B, T, L, 1)) + rng.normal(0, 0.01, (B, T, L, 3)), dtype
        ),
        valid=jnp.ones((B, T, L), bool),
    )
    return batched_init_state(cfg, EUROC_CALIB, B, dtype), frames, imu


def run_on(n_dev, B, reps=3):
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("seq",))
    run = make_sharded_runner(mesh, params, cfg, method="schur")
    states, frames, imu = make_batch(B)
    out = run(states, frames, imu)
    jax.block_until_ready(out[1].p)
    t0 = time.time()
    for _ in range(reps):
        out = run(states, frames, imu)
    jax.block_until_ready(out[1].p)
    return (time.time() - t0) / reps


def run_flagship_on(n_dev, reps=2):
    """Weak scaling of the FLAGSHIP full pipeline (bench.py configuration:
    752x480 frames, FrontendConfig() defaults, schur + Newton-Schulz,
    M=20) — the one-command artifact for the >=80% N>=2 measurement on a
    real pod slice (VERDICT round 3, next #8).  1 lane per device,
    T = M+2 frames per step."""
    from msckf_stereo_c.config import FrontendConfig
    from msckf_stereo_c.models.frontend import make_frontend_params
    from msckf_stereo_c.models.runner import pack_imu_batches
    from msckf_stereo_c.models.vio import init_vio_state
    from msckf_stereo_c.parallel.vio_multiseq import (
        batched_init_vio_state,
        make_sharded_vio_runner,
    )
    from msckf_stereo_c.sim import (
        make_circle_trajectory,
        make_wall_landmarks,
        synthesize_imu,
    )
    from msckf_stereo_c.sim.render_jax import JaxRenderer, StressEvents

    fcfg = FrontendConfig()
    mcfg_fl = FilterConfig(ns_iters=10)
    B, Tf = n_dev, mcfg_fl.max_cam_state_size + 2
    traj = make_circle_trajectory(duration=8.0)
    lms = make_wall_landmarks(num=400, radius=8.0, seed=1)
    sim_imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    renderer = JaxRenderer(np.asarray(lms), r_wall=8.0)
    imgs0, imgs1, times_, imus = [], [], [], []
    for b in range(B):
        idx = np.arange(320, 320 + 10 * Tf, 10) + 10 * b
        i0, i1 = renderer.render_sequence(traj, idx, StressEvents.nominal(Tf))
        imgs0.append(i0)
        imgs1.append(i1)
        times_.append(traj.t[idx].astype(np.float32))
        imus.append(
            pack_imu_batches(
                sim_imu.t, sim_imu.gyro, sim_imu.acc, traj.t[idx],
                mcfg_fl.max_imu_per_frame, np.float32,
            )
        )
    d0 = jnp.asarray(np.stack(imgs0), jnp.float32)
    d1 = jnp.asarray(np.stack(imgs1), jnp.float32)
    dt_ = jnp.asarray(np.stack(times_), jnp.float32)
    di = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *imus)

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("seq",))
    fparams = make_frontend_params(EUROC_CALIB, jnp.float32)
    mparams_fl = make_params(mcfg_fl, EUROC_CALIB, jnp.float32)
    states = batched_init_vio_state(
        fcfg, mcfg_fl, EUROC_CALIB, d0.shape[2:], B, jnp.float32, jnp.float32
    )
    run = make_sharded_vio_runner(mesh, fparams, mparams_fl, fcfg, mcfg_fl, method="schur")
    out = run(states, d0, d1, dt_, di)
    jax.block_until_ready(out[1].p)
    t0 = time.time()
    for _ in range(reps):
        out = run(states, d0, d1, dt_, di)
    jax.block_until_ready(out[1].p)
    return (time.time() - t0) / reps


def main():
    if "--processes" in sys.argv:
        # Multi-process flagship point: P OS processes x D devices via
        # jax.distributed (parallel/multiproc.py).  Reuses the dryrun
        # worker with timing; compare the reported step_ms against a
        # --flagship run at the same total device count.
        from msckf_stereo_c.parallel.multiproc import launch_workers

        P = int(sys.argv[sys.argv.index("--processes") + 1])
        D = int(os.environ.get("SCALE_DEVICES_PER_PROC", "2"))
        results = launch_workers("bench", num_processes=P, devices_per_process=D)
        for rc, out in results:
            assert rc == 0, out[-3000:]
            for line in out.splitlines():
                if line.startswith("MULTIPROC_BENCH") or line.startswith("MULTIPROC_OK"):
                    print(line)
        return

    if "--flagship" in sys.argv:
        results = {}
        for n in [1, 2, 4, 8]:
            dtv = run_flagship_on(n)
            results[n] = dtv
            eff = results[1] / dtv
            print(
                f"flagship devices={n}  B={n}  time={dtv*1e3:8.1f} ms  "
                f"weak-scaling eff={eff:6.1%}  (virtual CPU mesh: NOT "
                f"hardware-meaningful, see module docstring)"
            )
        return

    results = {}
    for n in [1, 2, 4, 8]:
        dt = run_on(n, B=n)
        results[n] = dt
        base = results[1]
        eff = base / dt  # weak scaling: same per-device work
        print(f"devices={n}  B={n}  time={dt*1e3:8.1f} ms  weak-scaling eff={eff:6.1%}")


if __name__ == "__main__":
    main()
