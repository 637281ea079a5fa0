"""Multi-sequence data parallelism over a device mesh.

The reference processes exactly one EuRoC sequence per process
(apps/run_euroc_single_thread.cpp); its only concurrency is a broken
4-pthread pipeline (README.md:33).  The scaling story here instead
batches *sequences*: filter state and frame streams carry a leading batch
dimension, ``vmap`` runs the per-frame step across the batch, and
``shard_map`` over a ``Mesh`` splits the batch across devices — pure data
parallelism across devices, with a ``psum`` only for cross-sequence metric
reduction."""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import FilterConfig, StereoCalib
from ..models.msckf import FrameFeatures, MsckfParams, filter_step, make_params
from ..models.propagation import ImuBatch
from ..models.runner import apply_gravity_init, pack_imu_batches
from ..models.state import FilterState, init_filter_state


def make_mesh(n_devices: Optional[int] = None, axis: str = "seq") -> Mesh:
    devs = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.array(devs), (axis,))


def batched_init_state(cfg: FilterConfig, calib: StereoCalib, batch: int, dtype=jnp.float32) -> FilterState:
    one = init_filter_state(cfg, calib, dtype)
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), one)


def batched_gravity_init(states: FilterState, gyro_windows, acc_windows) -> FilterState:
    """Vmapped gravity/bias init: windows have shape (B, n, 3)."""
    return jax.vmap(apply_gravity_init)(states, gyro_windows, acc_windows)


def make_sharded_runner(
    mesh: Mesh,
    params: MsckfParams,
    cfg: FilterConfig,
    method: str = "cholesky",
    mesh_axis: str = "seq",
):
    """Build the jitted sharded multi-sequence chunk runner for ``mesh``.

    The returned callable maps (states (B,...), frames (B,T,...),
    imu (B,T,L,...)) -> (new_states, poses, metrics); the batch dimension is
    sharded over ``mesh_axis`` and metrics are psum-reduced across devices."""

    def seq_scan(state, frame_seq, imu_seq):
        def step(s, xs):
            fr, b = xs
            return filter_step(s, fr, b, params, cfg, method=method)

        return jax.lax.scan(step, state, (frame_seq, imu_seq))

    def local(states, frames, imu):
        new_states, poses = jax.vmap(seq_scan)(states, frames, imu)
        total_tracks = jax.lax.psum(jnp.sum(poses.num_tracks), mesh_axis)
        return new_states, poses, total_tracks

    from jax import shard_map

    spec = P(mesh_axis)
    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(spec, spec, P()),
        check_vma=False,
    )

    @jax.jit
    def run(states, frames, imu):
        new_states, poses, total_tracks = sharded(states, frames, imu)
        return new_states, poses, {"total_tracks": total_tracks}

    return run


def run_multi_sequence(
    cfg: FilterConfig,
    calib: StereoCalib,
    frame_t: np.ndarray,  # (B, T)
    fid: np.ndarray,  # (B, T, F)
    uv: np.ndarray,  # (B, T, F, 4)
    valid: np.ndarray,  # (B, T, F)
    imu_t: np.ndarray,  # (B, N)
    imu_gyro: np.ndarray,  # (B, N, 3)
    imu_acc: np.ndarray,  # (B, N, 3)
    dtype=jnp.float32,
    method: str = "cholesky",
):
    """Evaluate B feature-track sequences in parallel across the mesh (the
    batched analog of runner.run_sequence)."""
    B, T = frame_t.shape
    params = make_params(cfg, calib, dtype)
    states = batched_init_state(cfg, calib, B, dtype)
    n0 = min(cfg.imu_init_samples, imu_t.shape[1])
    states = batched_gravity_init(
        states, jnp.asarray(imu_gyro[:, :n0], dtype), jnp.asarray(imu_acc[:, :n0], dtype)
    )

    batches = [
        pack_imu_batches(imu_t[b], imu_gyro[b], imu_acc[b], frame_t[b], cfg.max_imu_per_frame)
        for b in range(B)
    ]
    imu = jax.tree.map(lambda *xs: jnp.stack(xs), *batches)
    frames = FrameFeatures(
        time=jnp.asarray(frame_t, dtype),
        fid=jnp.asarray(fid, jnp.int32),
        uv=jnp.asarray(uv, dtype),
        valid=jnp.asarray(valid),
    )

    mesh = make_mesh()
    # Pad the batch to a multiple of the mesh size for even sharding.
    n_dev = mesh.devices.size
    pad = (-B) % n_dev
    if pad:
        def padb(x):
            return jnp.concatenate([x, jnp.repeat(x[-1:], pad, axis=0)], axis=0)

        states = jax.tree.map(padb, states)
        frames = jax.tree.map(padb, frames)
        imu = jax.tree.map(padb, imu)

    run = make_sharded_runner(mesh, params, cfg, method=method)
    new_states, poses, metrics = run(states, frames, imu)
    unpad = lambda x: x[:B]
    return (
        jax.tree.map(unpad, new_states),
        jax.device_get(jax.tree.map(unpad, poses)),
        jax.device_get(metrics),
    )
