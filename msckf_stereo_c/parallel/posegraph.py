"""Distributed pose-graph optimization (SE(3) relative-pose edges).

The long-horizon tier of the engine (BASELINE.json config 5): keyframe poses
from one or more VIO sessions are refined against relative-pose constraints
(odometry edges from the filter, plus loop-closure / inter-session edges).
Gauss-Newton on the 6-dof pose manifold; the edge set is sharded across the
device mesh and each shard's normal-equation contribution is psum-reduced —
the same assemble-reduce-solve pattern as the BA layer (ba.py), with edges
instead of landmarks as the partitioned axis.

Residual for edge (i, j) with measured relative transform (R_ij, t_ij)
(maps frame-j vectors to frame i under the world->frame convention used by
the filter):  r_rot = log(R_ij^T R_i R_j^T),  r_trans = R_i (p_j - p_i) - t_ij.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..utils.lie import so3_exp, so3_log
from ..utils.quaternion import jpl_to_rot, quat_multiply, small_angle_quaternion


class PoseGraph(NamedTuple):
    q: jnp.ndarray  # (F, 4) JPL world->frame
    p: jnp.ndarray  # (F, 3) frame position in world
    edge_i: jnp.ndarray  # (E,) int32
    edge_j: jnp.ndarray  # (E,)
    R_meas: jnp.ndarray  # (E, 3, 3) measured R_ij (frame j -> frame i vectors)
    t_meas: jnp.ndarray  # (E, 3) measured R_i (p_j - p_i)
    weight: jnp.ndarray  # (E,) information weight (0 disables an edge)


def _edge_residual(q_i, p_i, q_j, p_j, R_m, t_m):
    R_i = jpl_to_rot(q_i)
    R_j = jpl_to_rot(q_j)
    r_rot = so3_log(R_m.T @ (R_i @ R_j.T))
    r_t = R_i @ (p_j - p_i) - t_m
    return jnp.concatenate([r_rot, r_t])


def _edge_residual_jac(q_i, p_i, q_j, p_j, R_m, t_m):
    """Residual + Jacobians w.r.t. [dtheta_i, dp_i] and [dtheta_j, dp_j]
    (left-multiplicative JPL error, same convention as apply_correction)."""
    r = _edge_residual(q_i, p_i, q_j, p_j, R_m, t_m)

    def f(d):
        di, dj = d[:6], d[6:]
        qi = quat_multiply(small_angle_quaternion(di[:3]), q_i)
        qj = quat_multiply(small_angle_quaternion(dj[:3]), q_j)
        return _edge_residual(qi, p_i + di[3:], qj, p_j + dj[3:], R_m, t_m)

    J = jax.jacfwd(f)(jnp.zeros(12, q_i.dtype))
    return r, J[:, :6], J[:, 6:]


_edge_rj = jax.vmap(_edge_residual_jac, in_axes=(0, 0, 0, 0, 0, 0))


def _assemble(graph: PoseGraph, F: int):
    """Normal equations H (F,F,6,6), b (F,6) over this shard's edges."""
    dtype = graph.p.dtype
    qi = graph.q[graph.edge_i]
    pi = graph.p[graph.edge_i]
    qj = graph.q[graph.edge_j]
    pj = graph.p[graph.edge_j]
    r, Ji, Jj = _edge_rj(qi, pi, qj, pj, graph.R_meas, graph.t_meas)
    # ``weight`` is the edge information (1/sigma^2): it must scale H and b
    # by the SAME power or the Gauss-Newton step is mis-scaled per edge
    # (the historical code weighted r once more than J, which cancels only
    # for uniform weights and diverges for mixed odometry/loop weights).
    w = graph.weight[:, None, None]

    Hii = jnp.einsum("eab,eac->ebc", Ji * w, Ji)
    Hjj = jnp.einsum("eab,eac->ebc", Jj * w, Jj)
    Hij = jnp.einsum("eab,eac->ebc", Ji * w, Jj)
    bi = jnp.einsum("eab,ea->eb", Ji * w, r)
    bj = jnp.einsum("eab,ea->eb", Jj * w, r)

    H = jnp.zeros((F, F, 6, 6), dtype)
    H = H.at[graph.edge_i, graph.edge_i].add(Hii)
    H = H.at[graph.edge_j, graph.edge_j].add(Hjj)
    H = H.at[graph.edge_i, graph.edge_j].add(Hij)
    H = H.at[graph.edge_j, graph.edge_i].add(jnp.swapaxes(Hij, -1, -2))
    b = jnp.zeros((F, 6), dtype)
    b = b.at[graph.edge_i].add(bi)
    b = b.at[graph.edge_j].add(bj)
    cost = jnp.sum(graph.weight * jnp.sum(r * r, axis=-1))
    return H, b, cost


def _solve_and_update(q, p, H, b, damping, gauge_fix=1):
    dtype = p.dtype
    F = q.shape[0]
    Hm = H.transpose(0, 2, 1, 3).reshape(6 * F, 6 * F)
    bv = b.reshape(6 * F)
    Hm = Hm + damping * jnp.eye(6 * F, dtype=dtype)
    gmask = (jnp.arange(6 * F) < 6 * gauge_fix).astype(dtype)
    Hm = Hm + jnp.diag(gmask * 1e12)
    L = jnp.linalg.cholesky(Hm)
    delta = -jax.scipy.linalg.cho_solve((L, True), bv).reshape(F, 6)
    q_new = quat_multiply(small_angle_quaternion(delta[:, :3]), q)
    return q_new, p + delta[:, 3:6]


def optimize_pose_graph(graph: PoseGraph, iters: int = 10, damping: float = 1e-8):
    """Single-device Gauss-Newton (oracle for the sharded version)."""
    F = graph.q.shape[0]

    def step(carry, _):
        q, p = carry
        H, b, cost = _assemble(graph._replace(q=q, p=p), F)
        q, p = _solve_and_update(q, p, H, b, damping)
        return (q, p), cost

    (q, p), costs = jax.lax.scan(step, (graph.q, graph.p), None, length=iters)
    return graph._replace(q=q, p=p), costs


def make_distributed_pose_graph(mesh: Mesh, iters: int = 10, damping: float = 1e-8, axis: str = "edges"):
    """Edges sharded over ``axis``; poses replicated; per-iteration psum of
    the normal equations across devices."""
    from jax import shard_map

    def local(q, p, ei, ej, Rm, tm, w):
        F = q.shape[0]

        def step(carry, _):
            q, p = carry
            g = PoseGraph(q, p, ei, ej, Rm, tm, w)
            H, b, cost = _assemble(g, F)
            H = jax.lax.psum(H, axis)
            b = jax.lax.psum(b, axis)
            cost = jax.lax.psum(cost, axis)
            q, p = _solve_and_update(q, p, H, b, damping)
            return (q, p), cost

        (q, p), costs = jax.lax.scan(step, (q, p), None, length=iters)
        return q, p, costs

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def run(graph: PoseGraph):
        q, p, costs = sharded(
            graph.q, graph.p, graph.edge_i, graph.edge_j,
            graph.R_meas, graph.t_meas, graph.weight,
        )
        return graph._replace(q=q, p=p), costs

    return run


def odometry_edges(q: np.ndarray, p: np.ndarray, stride: int = 1, weight: float = 1.0):
    """Build consecutive relative-pose edges from a trajectory (the VIO
    output): measured transforms from the (possibly noisy) poses."""
    F = q.shape[0]
    ei = np.arange(0, F - stride, stride, dtype=np.int32)
    ej = ei + stride
    R = np.asarray(jpl_to_rot(jnp.asarray(q)))
    R_m = np.einsum("eij,ekj->eik", R[ei], R[ej])  # R_i R_j^T
    t_m = np.einsum("eij,ej->ei", R[ei], p[ej] - p[ei])
    w = np.full(len(ei), weight)
    return ei, ej, R_m, t_m, w
