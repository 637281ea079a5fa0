"""Pose-graph optimization tests: loop-closure correction + sharded
equivalence."""
import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.parallel.posegraph import (
    PoseGraph,
    make_distributed_pose_graph,
    odometry_edges,
    optimize_pose_graph,
)
from msckf_stereo_c.utils.lie import so3_exp
from msckf_stereo_c.utils.quaternion import jpl_to_rot, rot_to_jpl

RNG = np.random.default_rng(23)


def _true_trajectory(F=16):
    qs, ps = [], []
    for i in range(F):
        a = 2 * np.pi * i / F
        c, s = np.cos(a), np.sin(a)
        R = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])
        qs.append(np.asarray(rot_to_jpl(jnp.asarray(R))))
        ps.append([2 * np.cos(a), 2 * np.sin(a), 0.1 * i])
    return jnp.asarray(qs), jnp.asarray(ps)


def _drifted(q, p, drift=0.03):
    """Accumulating odometric drift (except the gauge pose)."""
    F = q.shape[0]
    qd, pd = [np.asarray(q[0])], [np.asarray(p[0])]
    for i in range(1, F):
        dth = RNG.normal(0, drift, 3) * i / F
        qd.append(np.asarray(rot_to_jpl(so3_exp(jnp.asarray(dth)) @ jpl_to_rot(q[i]))))
        pd.append(np.asarray(p[i]) + RNG.normal(0, drift, 3) * i / F)
    return jnp.asarray(qd), jnp.asarray(pd)


def _graph(F=16):
    q_true, p_true = _true_trajectory(F)
    # Edges measured from the TRUE poses (perfect constraints), including a
    # loop closure from last to first.
    ei, ej, Rm, tm, w = odometry_edges(np.asarray(q_true), np.asarray(p_true))
    ei = np.concatenate([ei, [F - 1]]).astype(np.int32)
    ej = np.concatenate([ej, [0]]).astype(np.int32)
    R = np.asarray(jpl_to_rot(q_true))
    Rm = np.concatenate([Rm, (R[F - 1] @ R[0].T)[None]])
    tm = np.concatenate([tm, (R[F - 1] @ (np.asarray(p_true[0]) - np.asarray(p_true[F - 1])))[None]])
    w = np.concatenate([w, [1.0]])

    q0, p0 = _drifted(q_true, p_true)
    return (
        PoseGraph(
            q=q0, p=p0,
            edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
            R_meas=jnp.asarray(Rm), t_meas=jnp.asarray(tm), weight=jnp.asarray(w),
        ),
        q_true, p_true,
    )


def test_pose_graph_recovers_truth():
    graph, q_true, p_true = _graph()
    refined, costs = optimize_pose_graph(graph, iters=15)
    assert float(costs[-1]) < 1e-16
    np.testing.assert_allclose(np.asarray(refined.p), np.asarray(p_true), atol=1e-6)


def test_distributed_matches_single():
    from msckf_stereo_c.parallel.multiseq import make_mesh

    graph, _, _ = _graph(F=17)  # 16 odo edges + 1 loop = 17... ensure /8
    # Pad edges to a multiple of 8 with zero-weight edges.
    E = graph.edge_i.shape[0]
    pad = (-E) % 8
    if pad:
        graph = graph._replace(
            edge_i=jnp.concatenate([graph.edge_i, jnp.zeros(pad, jnp.int32)]),
            edge_j=jnp.concatenate([graph.edge_j, jnp.zeros(pad, jnp.int32)]),
            R_meas=jnp.concatenate([graph.R_meas, jnp.tile(jnp.eye(3)[None], (pad, 1, 1))]),
            t_meas=jnp.concatenate([graph.t_meas, jnp.zeros((pad, 3))]),
            weight=jnp.concatenate([graph.weight, jnp.zeros(pad)]),
        )
    mesh = make_mesh(8, axis="edges")
    run = make_distributed_pose_graph(mesh, iters=8)
    single, costs_s = optimize_pose_graph(graph, iters=8)
    shard, costs_d = run(graph)
    np.testing.assert_allclose(np.asarray(costs_d), np.asarray(costs_s), rtol=1e-6, atol=1e-18)
    np.testing.assert_allclose(np.asarray(shard.p), np.asarray(single.p), atol=1e-8)
