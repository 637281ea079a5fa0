"""Multi-process (multi-host) execution tier: ``jax.distributed`` + a
global mesh spanning OS processes.

The north star's distributed story (SURVEY.md §5, :324-327) is
``jax.distributed`` with a mesh over hosts, cross-host collectives at
sequence/map-block granularity; the reference anchor it replaces is
the broken 4-pthread pipeline (/root/reference/apps/
run_euroc_muitl_threads.cpp:222-231).  Rounds 1-3 validated every SPMD
program (multi-sequence VIO, distributed BA, pose graph) under
single-process ``shard_map`` on a virtual mesh; what a single process can
NEVER exercise is the multi-process semantics: global-mesh construction
from per-process device sets, per-process data feeding
(``jax.make_array_from_process_local_data``), and collectives that actually
cross a process boundary.  This module adds exactly that tier:

- ``init_distributed``: per-process runtime bring-up with gloo-backed
  CPU collectives.  This tier is a CPU test harness; a GPU run is one
  process per host driving its cards (a one-process-per-card tier over
  NCCL is not written).
- ``make_global`` / ``local_values``: feed each process ONLY its shard;
  read back only addressable shards.
- a worker ``__main__`` with three modes (``vio``, ``ba``, ``dryrun``) and
  a ``launch_workers`` helper, used by ``tests/test_multiproc.py`` (2 OS
  processes x 2 virtual CPU devices, bit-level equality against the
  single-process run) and by ``__graft_entry__.dryrun_multichip`` when
  ``MSCKF_MULTIPROC=N`` is set (full flagship pipeline across N processes).
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from typing import Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Runtime bring-up


def init_distributed(
    coordinator: str,
    num_processes: int,
    process_id: int,
    local_devices: int,
    collectives: str = "gloo",
) -> None:
    """Configure THIS process as one participant of a multi-process run.

    Must be called before any other jax API touches the backend.  The
    processes run on the CPU and their collectives over gloo."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    # Parity with the CPU validation environment (tests/conftest.py): f64
    # available, explicit-f32 code unaffected.
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_num_cpu_devices", int(local_devices))
    jax.config.update("jax_cpu_collectives_implementation", collectives)
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=int(num_processes),
        process_id=int(process_id),
    )


def global_mesh(axis: str = "seq"):
    """1-d mesh over ALL global devices (every process sees the same)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def process_lane_range(mesh, n_lanes: int):
    """Contiguous [lo, hi) range of batch lanes owned by this process when
    the batch axis is sharded over the (1-d) mesh in device order."""
    import jax

    devs = list(mesh.devices.flat)
    n_dev = len(devs)
    assert n_lanes % n_dev == 0, (n_lanes, n_dev)
    per = n_lanes // n_dev
    mine = [i for i, d in enumerate(devs) if d.process_index == jax.process_index()]
    assert mine == list(range(mine[0], mine[0] + len(mine))), (
        f"process devices not contiguous in mesh order: {mine}"
    )
    return mine[0] * per, (mine[-1] + 1) * per


def make_global(mesh, axis: str, local_tree, replicated: bool = False):
    """Global arrays from per-process data.

    ``replicated=False``: each leaf is THIS process's shard of the batch
    axis (axis 0); the global array is assembled across processes without
    any data exchange.  ``replicated=True``: each process passes the full
    array (replicated sharding)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    def one(x):
        x = np.asarray(x)
        spec = P() if replicated else P(*([axis] + [None] * (x.ndim - 1)))
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, spec), x
        )

    return jax.tree.map(one, local_tree)


def local_values(tree):
    """np values of this process's addressable shards, concatenated in lane
    order along axis 0 (replicated leaves return one copy)."""
    import jax

    def one(x):
        shards = list(x.addressable_shards)
        idx0 = shards[0].index
        if not idx0 or all(
            s == slice(None) for s in idx0
        ):  # replicated
            return np.asarray(shards[0].data)
        shards.sort(key=lambda s: s.index[0].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards], axis=0)

    return jax.tree.map(one, tree)


# ---------------------------------------------------------------------------
# Deterministic problem builders (shared by workers, tests, and the parent
# reference runs — every process regenerates the SAME data for its lanes).

# Small-but-complete configuration: cam window fills AND the keyframe-prune
# compacted update runs (T >= M+2), at half EuRoC resolution so two
# concurrent worker processes compile + run quickly on a small host.
VIO_LANES = 4
VIO_FRAMES = 8  # = max_cam_state_size + 2


def _half_res_calib():
    import dataclasses

    from ..config import EUROC_CALIB

    def half(cam):
        fx, fy, cx, cy = cam.intrinsics
        w, h = cam.resolution
        return dataclasses.replace(
            cam,
            intrinsics=(fx / 2, fy / 2, cx / 2, cy / 2),
            resolution=(w // 2, h // 2),
        )

    return dataclasses.replace(
        EUROC_CALIB, cam0=half(EUROC_CALIB.cam0), cam1=half(EUROC_CALIB.cam1)
    )


def vio_configs():
    from ..config import FilterConfig, FrontendConfig

    fcfg = FrontendConfig(max_features=64)
    mcfg = FilterConfig(
        max_cam_state_size=6, max_tracks=64, max_imu_per_frame=10, ns_iters=10
    )
    return fcfg, mcfg, _half_res_calib()


def vio_lane_inputs(lanes: Sequence[int], T: int, mcfg, calib):
    """(imgs0, imgs1, times, imu) stacked over the given lane ids — lane b
    is a genuinely different sequence (different trajectory offset), same
    construction as tests/test_vio_multiseq.py."""
    import jax
    import jax.numpy as jnp

    from ..models.runner import pack_imu_batches
    from ..sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
    from ..sim.render_jax import JaxRenderer, StressEvents

    traj = make_circle_trajectory(duration=6.0)
    lms = make_wall_landmarks(num=300, radius=8.0, seed=1)
    imu = synthesize_imu(traj, gyro_noise=1e-4, acc_noise=1e-3, seed=0)
    renderer = JaxRenderer(np.asarray(lms), calib=calib, r_wall=8.0)

    imgs0, imgs1, times, imus = [], [], [], []
    for b in lanes:
        idx = np.arange(300, 300 + 10 * T, 10) + 12 * b
        i0, i1 = renderer.render_sequence(traj, idx, StressEvents.nominal(T))
        imgs0.append(np.asarray(i0))
        imgs1.append(np.asarray(i1))
        times.append(traj.t[idx].astype(np.float32))
        imus.append(
            pack_imu_batches(
                imu.t, imu.gyro, imu.acc, traj.t[idx],
                mcfg.max_imu_per_frame, np.float32,
            )
        )
    d_imu = jax.tree.map(lambda *xs: np.stack(xs), *imus)
    return (
        np.stack(imgs0).astype(np.float32),
        np.stack(imgs1).astype(np.float32),
        np.stack(times),
        d_imu,
    )


def run_vio_reference(mesh):
    """Single-process sharded reference run over ``mesh`` (all lanes local).
    Returns (poses, fronts, metrics) as np trees."""
    import jax
    import jax.numpy as jnp

    from ..models.frontend import make_frontend_params
    from ..models.msckf import make_params
    from .vio_multiseq import batched_init_vio_state, make_sharded_vio_runner

    fcfg, mcfg, calib = vio_configs()
    imgs0, imgs1, times, imu = vio_lane_inputs(range(VIO_LANES), VIO_FRAMES, mcfg, calib)
    fparams = make_frontend_params(calib, jnp.float32)
    mparams = make_params(mcfg, calib, jnp.float32)
    states = batched_init_vio_state(
        fcfg, mcfg, calib, imgs0.shape[2:], VIO_LANES, jnp.float32, jnp.float32
    )
    run = make_sharded_vio_runner(mesh, fparams, mparams, fcfg, mcfg, method="schur")
    new_states, poses, fronts, metrics = run(
        states,
        jnp.asarray(imgs0),
        jnp.asarray(imgs1),
        jnp.asarray(times),
        jax.tree.map(jnp.asarray, imu),
    )
    jax.block_until_ready(poses.p)
    out = {
        "p": np.asarray(poses.p),
        "q_xyzw": np.asarray(poses.q_xyzw),
        "fid": np.asarray(fronts.fid),
        "uv": np.asarray(fronts.uv),
        "valid": np.asarray(fronts.valid),
        "after_ransac": np.asarray(fronts.after_ransac),
        "num_cams": np.asarray(new_states.filt.num_cams),
        "total_tracks": np.asarray(metrics["total_tracks"]),
    }
    return out


def ba_problem():
    """Deterministic synthetic BA problem (cameras on an arc observing a
    landmark cloud), perturbed; mirrors tests/test_ba.py."""
    import jax
    import jax.numpy as jnp

    from ..utils.lie import so3_exp
    from ..utils.quaternion import jpl_to_rot, rot_to_jpl
    from .ba import BAProblem

    rng = np.random.default_rng(31)
    F, L = 6, 64
    R01 = jnp.eye(3, dtype=jnp.float64)
    t01 = jnp.asarray([-0.1, 0.0, 0.0], jnp.float64)
    qs, ps = [], []
    for i in range(F):
        a = 0.25 * i
        p = np.array([2.0 * np.sin(a), 0.05 * i, -2.0 * np.cos(a)])
        c, s = np.cos(0.08 * i), np.sin(0.08 * i)
        R = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        qs.append(np.asarray(rot_to_jpl(jnp.asarray(R))))
        ps.append(p)
    cam_q = jnp.asarray(qs)
    cam_p = jnp.asarray(ps)
    lms = jnp.asarray(rng.uniform(-1.0, 1.0, (L, 3)) + np.array([0, 0, 1.5]))
    R0 = jpl_to_rot(cam_q)
    p_c0 = jnp.einsum("fij,lfj->lfi", R0, lms[:, None] - cam_p[None])
    p_c1 = jnp.einsum("ij,lfj->lfi", R01, p_c0) + t01
    mask = (p_c0[..., 2] > 0.3) & (p_c1[..., 2] > 0.3)
    obs = jnp.concatenate(
        [p_c0[..., :2] / p_c0[..., 2:], p_c1[..., :2] / p_c1[..., 2:]], axis=-1
    ) * mask[..., None]

    dth = rng.normal(0, 0.02, (F, 3))
    dth[0] = 0
    dp = rng.normal(0, 0.02, (F, 3))
    dp[0] = 0
    q_pert = jax.vmap(lambda q, d: rot_to_jpl(so3_exp(d) @ jpl_to_rot(q)))(
        cam_q, jnp.asarray(dth)
    )
    return BAProblem(
        q_pert,
        cam_p + jnp.asarray(dp),
        lms + jnp.asarray(rng.normal(0, 0.02, (L, 3))),
        obs,
        mask,
        R01,
        t01,
    )


def run_ba_reference(mesh):
    """Single-process sharded BA reference over ``mesh``."""
    import jax

    from .ba import make_distributed_ba

    prob = ba_problem()
    run = make_distributed_ba(mesh, iters=8, axis="map")
    refined, costs = run(prob)
    jax.block_until_ready(costs)
    return {
        "cam_q": np.asarray(refined.cam_q),
        "cam_p": np.asarray(refined.cam_p),
        "landmarks": np.asarray(refined.landmarks),
        "costs": np.asarray(costs),
    }


# ---------------------------------------------------------------------------
# Worker modes


def _worker_vio(args) -> None:
    import jax
    import jax.numpy as jnp

    from ..models.frontend import make_frontend_params
    from ..models.msckf import make_params
    from ..models.vio import init_vio_state
    from .vio_multiseq import make_sharded_vio_runner

    fcfg, mcfg, calib = vio_configs()
    mesh = global_mesh("seq")
    lo, hi = process_lane_range(mesh, VIO_LANES)
    imgs0, imgs1, times, imu = vio_lane_inputs(
        range(lo, hi), VIO_FRAMES, mcfg, calib
    )

    one = init_vio_state(fcfg, mcfg, calib, imgs0.shape[2:], jnp.float32, jnp.float32)
    states_local = jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x), (hi - lo,) + x.shape), one
    )
    g_states = make_global(mesh, "seq", states_local)
    g_imgs0, g_imgs1, g_times, g_imu = make_global(
        mesh, "seq", (imgs0, imgs1, times, imu)
    )

    fparams = make_frontend_params(calib, jnp.float32)
    mparams = make_params(mcfg, calib, jnp.float32)
    run = make_sharded_vio_runner(mesh, fparams, mparams, fcfg, mcfg, method="schur")
    new_states, poses, fronts, metrics = run(g_states, g_imgs0, g_imgs1, g_times, g_imu)
    jax.block_until_ready(poses.p)

    got = local_values(
        {
            "p": poses.p,
            "q_xyzw": poses.q_xyzw,
            "fid": fronts.fid,
            "uv": fronts.uv,
            "valid": fronts.valid,
            "after_ransac": fronts.after_ransac,
            "num_cams": new_states.filt.num_cams,
        }
    )
    total_tracks = int(local_values({"t": metrics["total_tracks"]})["t"])

    assert np.all(np.isfinite(got["p"]))
    assert int(got["after_ransac"].min()) > 10, "frontend lost tracking"
    assert int(got["num_cams"].min()) >= mcfg.max_cam_state_size - 2

    if args.ref:
        ref = np.load(args.ref)
        # Bit-level equality with the single-process sharded run: lane math
        # never crosses a device, so process boundaries must not change a
        # single bit of the per-lane outputs.
        for key in ("p", "q_xyzw", "fid", "uv", "valid", "after_ransac", "num_cams"):
            np.testing.assert_array_equal(
                got[key], ref[key][lo:hi], err_msg=f"lane-sharded output {key!r}"
            )
        # The cross-process psum (integer total) is exact too.
        assert total_tracks == int(ref["total_tracks"])
    print(
        f"MULTIPROC_OK vio process={jax.process_index()}/{jax.process_count()} "
        f"lanes=[{lo},{hi}) devices={len(jax.devices())} "
        f"total_tracks={total_tracks}",
        flush=True,
    )


def _worker_ba(args) -> None:
    import jax

    from .ba import make_distributed_ba

    mesh = global_mesh("map")
    prob = ba_problem()
    L = prob.landmarks.shape[0]
    # The per-process feed below covers exactly L/P landmarks each; a
    # remainder would silently disagree with the global sharded shape
    # (mirrors the contiguity assert in process_lane_range).
    assert L % jax.process_count() == 0, (
        f"landmark count {L} not divisible by process count {jax.process_count()}"
    )
    lo_l = L // jax.process_count() * jax.process_index()
    hi_l = L // jax.process_count() * (jax.process_index() + 1)

    g_prob = prob._replace(
        # Landmark-sharded leaves: feed only the local block.
        landmarks=make_global(mesh, "map", np.asarray(prob.landmarks)[lo_l:hi_l]),
        obs=make_global(mesh, "map", np.asarray(prob.obs)[lo_l:hi_l]),
        mask=make_global(mesh, "map", np.asarray(prob.mask)[lo_l:hi_l]),
        # Replicated leaves: every process passes the full value.
        cam_q=make_global(mesh, "map", np.asarray(prob.cam_q), replicated=True),
        cam_p=make_global(mesh, "map", np.asarray(prob.cam_p), replicated=True),
        R_c0_c1=make_global(mesh, "map", np.asarray(prob.R_c0_c1), replicated=True),
        t_c0_c1=make_global(mesh, "map", np.asarray(prob.t_c0_c1), replicated=True),
    )
    run = make_distributed_ba(mesh, iters=8, axis="map")
    refined, costs = run(g_prob)
    jax.block_until_ready(costs)
    got = local_values(
        {
            "cam_q": refined.cam_q,
            "cam_p": refined.cam_p,
            "landmarks": refined.landmarks,
            "costs": costs,
        }
    )
    assert got["costs"][-1] < 1e-3 * got["costs"][0], got["costs"]
    if args.ref:
        ref = np.load(args.ref)
        # The pose system is assembled by a cross-process psum whose
        # reduction order differs from the single-process one — equality is
        # machine-precision, not bitwise.
        np.testing.assert_allclose(got["cam_q"], ref["cam_q"], atol=1e-9)
        np.testing.assert_allclose(got["cam_p"], ref["cam_p"], atol=1e-9)
        np.testing.assert_allclose(
            got["landmarks"], ref["landmarks"][lo_l:hi_l], atol=1e-9
        )
        # Converged costs shrink to ~1e-28 where relative comparison is
        # meaningless; the cross-process psum order shifts them at the
        # 1e-22 scale.
        np.testing.assert_allclose(got["costs"], ref["costs"], rtol=1e-6, atol=1e-18)
    print(
        f"MULTIPROC_OK ba process={jax.process_index()}/{jax.process_count()} "
        f"landmarks=[{lo_l},{hi_l}) cost {got['costs'][0]:.3e}->{got['costs'][-1]:.3e}",
        flush=True,
    )


def _worker_bench(args) -> None:
    """Timed flagship weak-scaling point across processes: each process
    reports the per-step wall time of the sharded full-pipeline chunk
    (scripts/bench_scaling.py --processes consumes the MULTIPROC_BENCH
    line).  Per-device work is constant (1 lane per device), so on real
    hardware the multi-process time vs the single-process time at the same
    mesh size IS the multi-host scaling-efficiency measurement; on a
    shared-core CPU host the number is a plumbing exercise only."""
    _worker_dryrun(args, time_reps=int(os.environ.get("MSCKF_BENCH_REPS", "2")))


def _worker_dryrun(args, time_reps: int = 0) -> None:
    """Full flagship pipeline (bench configuration, EuRoC resolution) across
    processes — the multi-process form of __graft_entry__.dryrun_multichip."""
    import jax
    import jax.numpy as jnp

    from ..config import EUROC_CALIB, FilterConfig, FrontendConfig
    from ..models.frontend import make_frontend_params
    from ..models.msckf import make_params
    from ..models.runner import pack_imu_batches
    from ..models.vio import init_vio_state
    from ..sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
    from ..sim.render_jax import JaxRenderer, StressEvents
    from .vio_multiseq import make_sharded_vio_runner

    fcfg = FrontendConfig()
    mcfg = FilterConfig(ns_iters=10)
    mesh = global_mesh("seq")
    B = len(jax.devices())
    T = mcfg.max_cam_state_size + 2
    lo, hi = process_lane_range(mesh, B)

    traj = make_circle_trajectory(duration=8.0)
    lms = make_wall_landmarks(num=400, radius=8.0, seed=1)
    sim_imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    renderer = JaxRenderer(np.asarray(lms), r_wall=8.0)
    imgs0, imgs1, times, imus = [], [], [], []
    for b in range(lo, hi):
        idx = np.arange(320, 320 + 10 * T, 10) + 10 * b
        i0, i1 = renderer.render_sequence(traj, idx, StressEvents.nominal(T))
        imgs0.append(np.asarray(i0))
        imgs1.append(np.asarray(i1))
        times.append(traj.t[idx].astype(np.float32))
        imus.append(
            pack_imu_batches(
                sim_imu.t, sim_imu.gyro, sim_imu.acc, traj.t[idx],
                mcfg.max_imu_per_frame, np.float32,
            )
        )
    imu = jax.tree.map(lambda *xs: np.stack(xs), *imus)

    one = init_vio_state(
        fcfg, mcfg, EUROC_CALIB, imgs0[0].shape[1:], jnp.float32, jnp.float32
    )
    # Gravity/bias init on the local lanes (same windows every lane).
    from ..models.runner import apply_gravity_init

    one = one._replace(
        filt=apply_gravity_init(
            one.filt,
            jnp.asarray(sim_imu.gyro[:200], jnp.float32),
            jnp.asarray(sim_imu.acc[:200], jnp.float32),
        )
    )
    states_local = jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x), (hi - lo,) + x.shape), one
    )
    g_states = make_global(mesh, "seq", states_local)
    g_in = make_global(
        mesh, "seq", (np.stack(imgs0), np.stack(imgs1), np.stack(times), imu)
    )
    fparams = make_frontend_params(EUROC_CALIB, jnp.float32)
    mparams = make_params(mcfg, EUROC_CALIB, jnp.float32)
    run = make_sharded_vio_runner(mesh, fparams, mparams, fcfg, mcfg, method="schur")
    new_states, poses, fronts, metrics = run(g_states, *g_in)
    jax.block_until_ready(poses.p)
    if time_reps:
        import time as _time

        t0 = _time.time()
        for _ in range(time_reps):
            _, poses, _, _ = run(g_states, *g_in)
        jax.block_until_ready(poses.p)
        dt = (_time.time() - t0) / time_reps
        print(
            f"MULTIPROC_BENCH process={jax.process_index()} step_ms="
            f"{dt * 1e3:.1f} lanes={hi - lo} frames={T}",
            flush=True,
        )
    got = local_values(
        {
            "p": poses.p,
            "after_ransac": fronts.after_ransac,
            "num_cams": new_states.filt.num_cams,
        }
    )
    assert np.all(np.isfinite(got["p"]))
    tracked = int(got["after_ransac"][:, -1].min())
    assert tracked > 10, f"frontend lost tracking: {tracked}"
    assert int(got["num_cams"].max()) <= mcfg.max_cam_state_size
    assert int(got["num_cams"].min()) >= mcfg.max_cam_state_size - 2
    print(
        f"MULTIPROC_OK dryrun process={jax.process_index()}/{jax.process_count()} "
        f"lanes=[{lo},{hi}) of {B}, T={T} (cam window filled + pruned under "
        f"multi-process shard_map: num_cams={got['num_cams'].tolist()}), "
        f"min after_ransac={tracked}, "
        f"psum total_tracks={int(local_values({'t': metrics['total_tracks']})['t'])}",
        flush=True,
    )


# ---------------------------------------------------------------------------
# Launcher


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_workers(
    mode: str,
    num_processes: int = 2,
    devices_per_process: int = 2,
    ref_path: str | None = None,
    timeout: float = 1500.0,
):
    """Spawn ``num_processes`` worker OS processes and wait.  Returns
    [(returncode, output), ...].  The workers coordinate over a local port;
    the environment is sanitized so the parent's virtual-device XLA flags
    do not fight the workers' own device-count configuration."""
    port = _free_port()
    env = dict(os.environ)
    flags = env.get("XLA_FLAGS", "")
    env["XLA_FLAGS"] = " ".join(
        f for f in flags.split() if "host_platform_device_count" not in f
    )
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_NUM_CPU_DEVICES", None)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")

    procs = []
    for pid in range(num_processes):
        cmd = [
            sys.executable,
            "-m",
            "msckf_stereo_c.parallel.multiproc",
            "--mode", mode,
            "--process-id", str(pid),
            "--num-processes", str(num_processes),
            "--coordinator", f"127.0.0.1:{port}",
            "--devices-per-process", str(devices_per_process),
        ]
        if ref_path:
            cmd += ["--ref", ref_path]
        procs.append(
            subprocess.Popen(
                cmd,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                env=env,
                cwd=repo_root,
            )
        )
    results = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out = (out or "") + "\n<TIMEOUT>"
        results.append((p.returncode, out))
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=("vio", "ba", "dryrun", "bench"), required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--devices-per-process", type=int, default=2)
    ap.add_argument("--ref", default=None, help="reference npz to compare against")
    args = ap.parse_args(argv)

    init_distributed(
        args.coordinator, args.num_processes, args.process_id,
        args.devices_per_process,
    )
    if args.mode == "vio":
        _worker_vio(args)
    elif args.mode == "ba":
        _worker_ba(args)
    elif args.mode == "bench":
        _worker_bench(args)
    else:
        _worker_dryrun(args)


if __name__ == "__main__":
    main()
