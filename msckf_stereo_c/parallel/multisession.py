"""Multi-session map alignment: the BASELINE config-5 tier.

Two (or more) VIO sessions of the same space each live in their own
gravity-aligned odometry frame (origin/yaw fixed by each run's IMU
initialization).  This module joins them: per-session keyframe BA problems
re-associate each session's tracks (parallel/refine.py), shared landmarks
are matched ACROSS sessions (mutual nearest neighbor under a coarse prior
alignment — the "same dock / operator prior" every real multi-session system
starts from), landmark-set Kabsch fits turn the matches into inter-session
relative-pose edges, and the joint pose graph (per-session odometry chains +
inter-session edges) is optimized with the distributed SE(3) solver
(parallel/posegraph.py) on the device mesh.

This is exactly where the refinement tier adds information the filter never
had (docs/STRESS_NOTES.md round-4 BA analysis): no single-session filter can
observe the inter-session transform.  The reference has no comparable
capability (its map dies with the process; SURVEY.md §5 checkpoint "none").
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..io.tum import horn_align
from ..utils.quaternion import jpl_to_rot, rot_to_jpl
from .ba import BAProblem
from .posegraph import PoseGraph, make_distributed_pose_graph, optimize_pose_graph


@dataclasses.dataclass
class SessionData:
    """One finished VIO session, keyframed for the joint problem."""

    kf_times: np.ndarray  # (F,)
    q: np.ndarray  # (F, 4) JPL world->body (the published xyzw reinterpreted)
    p: np.ndarray  # (F, 3) body position in the session's odometry frame
    landmarks: np.ndarray  # (L, 3) BA-triangulated, session frame
    lm_mask: np.ndarray  # (L, F) which keyframes observe each landmark


def session_frame_transform(q0_jpl: np.ndarray, R_w_b0: np.ndarray, p0_w: np.ndarray):
    """(R_wv, t_wv): the rigid map from a session's odometry frame V to the
    common world frame W, anchored at the session's start (dock) pose.

    The filter's own initialization defines V: ``q0_jpl`` is the JPL V->body
    quaternion apply_gravity_init produced (estimator-side knowledge), while
    (R_w_b0, p0_w) is the session's true start pose in W (the dock prior —
    externally known, NOT derived from the estimate).  x_w = R_wv x_v + t_wv.
    """
    import jax.numpy as jnp

    R_v_b = np.asarray(jpl_to_rot(jnp.asarray(q0_jpl)))
    R_wv = np.asarray(R_w_b0).T @ R_v_b
    return R_wv, np.asarray(p0_w)


def relative_prior(
    frameA: Tuple[np.ndarray, np.ndarray],
    frameB: Tuple[np.ndarray, np.ndarray],
    yaw_noise_rad: float = 0.0,
    trans_noise_m: float = 0.0,
    seed: int = 0,
):
    """Coarse prior T_AB mapping session-B odometry coordinates into
    session A's frame, with operator-grade noise injected (the honest
    simulation of a dock/survey prior): x_A = R_ab x_B + t_ab."""
    (R_wa, t_wa), (R_wb, t_wb) = frameA, frameB
    R_ab = R_wa.T @ R_wb
    t_ab = R_wa.T @ (t_wb - t_wa)
    if yaw_noise_rad or trans_noise_m:
        rng = np.random.default_rng(seed)
        a = rng.normal(0.0, yaw_noise_rad)
        c, s = np.cos(a), np.sin(a)
        Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        R_ab = Rz @ R_ab
        t_ab = t_ab + rng.normal(0.0, trans_noise_m, 3)
    return R_ab, t_ab


def apply_rigid(R: np.ndarray, t: np.ndarray, q: np.ndarray, p: np.ndarray):
    """Map world->body poses from frame B into frame A under x_A = R x_B + t:
    R'_vb = R_vb R^T, p' = R p + t."""
    import jax.numpy as jnp

    Rb = np.asarray(jpl_to_rot(jnp.asarray(q)))  # (F,3,3) B-frame->body
    Ra = np.einsum("fij,kj->fik", Rb, R)
    q_out = np.stack([np.asarray(rot_to_jpl(jnp.asarray(m))) for m in Ra])
    return q_out, p @ R.T + t


def match_landmarks(
    lms_a: np.ndarray,
    lms_b_in_a: np.ndarray,
    radius: float = 0.5,
):
    """Mutual-nearest-neighbor 3D association within ``radius`` meters.
    Returns (idx_a, idx_b) match arrays."""
    if len(lms_a) == 0 or len(lms_b_in_a) == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    d2 = np.sum((lms_a[:, None, :] - lms_b_in_a[None, :, :]) ** 2, axis=-1)
    nn_ab = np.argmin(d2, axis=1)
    nn_ba = np.argmin(d2, axis=0)
    ia = np.arange(len(lms_a))
    mutual = nn_ba[nn_ab] == ia
    close = d2[ia, nn_ab] <= radius * radius
    keep = mutual & close
    return ia[keep].astype(np.int32), nn_ab[keep].astype(np.int32)


def _icp_passes(lms_a, cur, radii, min_matches):
    """Mutual-NN + Kabsch passes at the given radius schedule.  Returns
    (R, t, ia, ib, rms) accumulated over the passes (identity when no
    radius ever yields min_matches)."""
    R_acc = np.eye(3)
    t_acc = np.zeros(3)
    ia = ib = np.zeros(0, np.int32)
    rms = np.inf
    for r in radii:
        ia, ib = match_landmarks(lms_a, cur, radius=r)
        if len(ia) < min_matches:
            continue
        R, t = horn_align(cur[ib], lms_a[ia])
        cur = cur @ R.T + t
        R_acc = R @ R_acc
        t_acc = R @ t_acc + t
        rms = float(np.sqrt(np.mean(np.sum((cur[ib] - lms_a[ia]) ** 2, -1))))
    return R_acc, t_acc, ia, ib, rms


def refine_alignment(
    lms_a: np.ndarray,
    lms_b_in_a: np.ndarray,
    radius_schedule: Tuple[float, ...] = (3.0, 1.5, 0.8, 0.4),
    min_matches: int = 12,
    yaw_sweep_deg: float = 24.0,
    yaw_step_deg: float = 3.0,
):
    """Global alignment refinement of the coarse dock prior: a 1-D yaw sweep
    with short ICP scoring, then iterated mutual-NN + global Kabsch fits
    (point-set ICP) on the two sessions' triangulated landmark clouds.

    The sweep exists because plain ICP's convergence basin is NARROW in yaw:
    both session frames are gravity-aligned (each filter observes gravity),
    so the inter-session rotation error is essentially pure yaw — but a few
    degrees of it displaces far landmarks beyond the nearest-neighbor
    matching radius (a 10 deg error moves a 7 m-away wall point ~1.2 m,
    more than typical landmark spacing), and mutual-NN association locks
    onto a wrong, self-consistent match set.  Sweeping candidate yaw
    corrections (about the B cloud's centroid) and scoring each by short-ICP
    match count / residual restores the basin at operator-grade prior noise.

    Returns (R, t, idx_a, idx_b): the refinement maps prior-aligned B
    coordinates into A (x_A = R x + t); the final match index arrays feed
    ``intersession_edges``.  This global stage is the optimal
    single-transform estimator (Horn); the pose graph downstream only adds
    value through per-keyframe edges where the sessions' INTERNAL drift
    varies along the trajectory."""
    if yaw_sweep_deg > 0:
        yaws = np.deg2rad(
            np.arange(-yaw_sweep_deg, yaw_sweep_deg + 1e-9, yaw_step_deg)
        )
    else:
        yaws = np.array([0.0])
    # The z-offset needs its own sweep axis: a cylindrical-wall map is
    # nearly invariant to vertical translation (NN association finds
    # plausible height-shifted wrong matches), so ICP's basin is narrow in
    # z exactly like it is in yaw.  Gravity alignment makes (yaw, dz) the
    # two weakly-constrained prior axes; xy translation recovers fine
    # inside the matching radius (wall curvature breaks xy invariance).
    dzs = np.arange(-2.0, 2.0 + 1e-9, 0.5)
    cB = lms_b_in_a.mean(axis=0)

    def _sweep(xy_offsets):
        best = None
        for a in yaws:
            c, s = np.cos(a), np.sin(a)
            Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            for dxy in xy_offsets:
                for dz in dzs:
                    t0 = cB - Rz @ cB + np.array([dxy[0], dxy[1], dz])
                    cur0 = lms_b_in_a @ Rz.T + t0
                    R1, t1, ia, ib, rms = _icp_passes(
                        lms_a, cur0, radius_schedule[:3], min_matches
                    )
                    score = (len(ia), -rms)
                    if best is None or score > best[0]:
                        best = (score, R1 @ Rz, R1 @ t0 + t1)
        return best

    # The xy translation basin of mutual-NN ICP is about half the landmark
    # spacing, and near-symmetric rooms admit SELF-CONSISTENT wrong basins
    # (measured: a yaw-aliased basin with 108/400 matches vs the true
    # basin's 135-141 — any "looks locked" threshold picks wrong), so the
    # xy grid is always swept and the best candidate wins on
    # (match count, -rms) across the full (yaw, dxy, dz) grid.
    g = (-1.6, 0.0, 1.6)
    best = _sweep([(x, y) for x in g for y in g])
    R_acc, t_acc = best[1], best[2]
    # Polish from the winning candidate with the full schedule.
    cur = lms_b_in_a @ R_acc.T + t_acc
    R2, t2, ia, ib, _ = _icp_passes(lms_a, cur, radius_schedule, min_matches)
    return R2 @ R_acc, R2 @ t_acc + t2, ia, ib


def intersession_edges(
    sessA: SessionData,
    sessB: SessionData,
    match_a: np.ndarray,
    match_b: np.ndarray,
    min_common: int = 6,
    max_edges: int = 64,
    weight: float = 1.0,
):
    """Per-B-keyframe landmark-set Kabsch fits -> relative-pose edges.

    For each B keyframe observing >= min_common matched landmarks, the
    matched subsets (A-frame positions vs B-frame positions) give a local
    rigid fit T_loc (B->A); the edge ties that keyframe to the A keyframe
    co-observing most of the same landmarks, with the measured relative
    pose derived from T_loc.  Node numbering: A keyframes [0, Fa), B
    keyframes [Fa, Fa+Fb).  Returns (ei, ej, R_m, t_m, w)."""
    import jax.numpy as jnp

    Fa = sessA.q.shape[0]
    Ra = np.asarray(jpl_to_rot(jnp.asarray(sessA.q)))
    Rb = np.asarray(jpl_to_rot(jnp.asarray(sessB.q)))
    ei, ej, R_ms, t_ms, ws = [], [], [], [], []
    order = np.argsort(-sessB.lm_mask[match_b].sum(axis=0))  # busiest kb first
    for kb in order:
        obs_here = sessB.lm_mask[match_b, kb]
        if obs_here.sum() < min_common:
            continue
        sel_a = match_a[obs_here]
        sel_b = match_b[obs_here]
        pts_a = sessA.landmarks[sel_a]
        pts_b = sessB.landmarks[sel_b]
        # Rigid fit x_A = R_loc x_B + t_loc over the co-observed landmarks.
        R_loc, t_loc = horn_align(pts_b, pts_a)
        # Partner: the A keyframe observing most of these matched landmarks.
        ka = int(np.argmax(sessA.lm_mask[sel_a].sum(axis=0)))
        if sessA.lm_mask[sel_a, ka].sum() < min_common:
            continue
        # B keyframe pose mapped into A frame by the local fit.
        R_kb_a = Rb[kb] @ R_loc.T
        p_kb_a = R_loc @ sessB.p[kb] + t_loc
        R_m = Ra[ka] @ R_kb_a.T
        t_m = Ra[ka] @ (p_kb_a - sessA.p[ka])
        ei.append(ka)
        ej.append(Fa + kb)
        R_ms.append(R_m)
        t_ms.append(t_m)
        # Edge information from the local fit itself.  A Kabsch fit of n
        # points with per-point residual rms has translation variance
        # ~ rms^2/n AT THE LANDMARK CENTROID — but the edge constrains the
        # KEYFRAME pose, a lever arm away, and the fit's rotation variance
        # ~ rms^2/(n*lambda_min) (lambda_min = smallest principal spread^2
        # of the local landmark cloud) is amplified by that arm.  Local
        # subsets are the landmarks co-visible from one viewpoint — often
        # thin (near-planar/collinear) geometry whose fits are rms-small
        # yet transform-wrong; ignoring the geometry term was measured to
        # drag the graph ~5 cm off the global-Kabsch alignment on accurate
        # sessions.  var = rms^2/n * (1 + lever^2/lambda_min); w = 1/var
        # (rms floored at 1 cm against overconfident fits).
        n_c = float(obs_here.sum())
        pts_b_a = pts_b @ R_loc.T + t_loc
        res = pts_a - pts_b_a
        rms2 = max(float(np.mean(np.sum(res * res, -1))), 1e-4)
        ctr = pts_b_a.mean(axis=0)
        C = pts_b_a - ctr
        lam_min = max(float(np.linalg.eigvalsh(C.T @ C / n_c)[0]), 1e-2)
        lever2 = float(np.sum((p_kb_a - ctr) ** 2))
        var = rms2 / n_c * (1.0 + lever2 / lam_min)
        ws.append(weight / var)
        if len(ei) >= max_edges:
            break
    if not ei:
        z = np.zeros(0)
        return z.astype(np.int32), z.astype(np.int32), np.zeros((0, 3, 3)), np.zeros((0, 3)), z
    return (
        np.asarray(ei, np.int32),
        np.asarray(ej, np.int32),
        np.stack(R_ms),
        np.stack(t_ms),
        np.asarray(ws),
    )


def build_joint_graph(
    sessA: SessionData,
    sessB_in_a: SessionData,
    inter: Tuple[np.ndarray, ...],
    odom_weight: float = 1.0e4,
    dtype=None,
) -> PoseGraph:
    """Joint pose graph: both sessions' odometry chains (relative poses from
    the VIO trajectories — locally accurate) + the inter-session edges.
    sessB poses must already be prior-mapped into A's frame (their odometry
    edges are invariant to that rigid map).

    ``odom_weight`` is the odometry edges' information (1/variance):
    the default 1e4 corresponds to ~1 cm relative-pose noise between
    consecutive keyframes — the filter's measured short-horizon accuracy.
    Inter-session edges carry their own per-edge information from the local
    Kabsch fit residuals (``intersession_edges``), so both edge families
    live on one 1/variance scale and the solve balances them honestly."""
    import jax.numpy as jnp

    from .posegraph import odometry_edges

    dtype = dtype or np.float64
    Fa = sessA.q.shape[0]
    q = np.concatenate([sessA.q, sessB_in_a.q], axis=0)
    p = np.concatenate([sessA.p, sessB_in_a.p], axis=0)

    ei_a, ej_a, Rm_a, tm_a, w_a = odometry_edges(sessA.q, sessA.p, weight=odom_weight)
    ei_b, ej_b, Rm_b, tm_b, w_b = odometry_edges(
        sessB_in_a.q, sessB_in_a.p, weight=odom_weight
    )
    ei_x, ej_x, Rm_x, tm_x, w_x = inter

    ei = np.concatenate([ei_a, ei_b + Fa, ei_x])
    ej = np.concatenate([ej_a, ej_b + Fa, ej_x])
    Rm = np.concatenate([Rm_a, Rm_b, Rm_x]) if len(ei_x) else np.concatenate([Rm_a, Rm_b])
    tm = np.concatenate([tm_a, tm_b, tm_x]) if len(ei_x) else np.concatenate([tm_a, tm_b])
    w = np.concatenate([w_a, w_b, w_x])

    return PoseGraph(
        q=jnp.asarray(q, dtype),
        p=jnp.asarray(p, dtype),
        edge_i=jnp.asarray(ei),
        edge_j=jnp.asarray(ej),
        R_meas=jnp.asarray(Rm, dtype),
        t_meas=jnp.asarray(tm, dtype),
        weight=jnp.asarray(w, dtype),
    )


def optimize_joint(graph: PoseGraph, mesh=None, iters: int = 12):
    """Optimize the joint graph — distributed over the device mesh when
    given (edges sharded, per-iteration psum across devices; posegraph.py), else
    the single-device oracle.  Pads the edge set to the mesh size with
    zero-weight edges."""
    import jax.numpy as jnp

    if mesh is None:
        return optimize_pose_graph(graph, iters=iters)
    n = mesh.devices.size
    E = graph.edge_i.shape[0]
    pad = (-E) % n
    if pad:
        graph = graph._replace(
            edge_i=jnp.concatenate([graph.edge_i, jnp.zeros(pad, jnp.int32)]),
            edge_j=jnp.concatenate([graph.edge_j, jnp.zeros(pad, jnp.int32)]),
            R_meas=jnp.concatenate(
                [graph.R_meas, jnp.tile(jnp.eye(3, dtype=graph.R_meas.dtype), (pad, 1, 1))]
            ),
            t_meas=jnp.concatenate([graph.t_meas, jnp.zeros((pad, 3), graph.t_meas.dtype)]),
            weight=jnp.concatenate([graph.weight, jnp.zeros(pad, graph.weight.dtype)]),
        )
    run = make_distributed_pose_graph(mesh, iters=iters)
    return run(graph)
