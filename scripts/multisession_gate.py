#!/usr/bin/env python
"""Multi-session map-alignment gate — the BASELINE config-5 artifact.

Two VIO sessions of the same synthetic room start from different poses;
each runs the full pipeline (render -> frontend kernels -> MSCKF) in its own
odometry frame.  A coarse dock prior (true inter-start transform + injected
operator noise) bootstraps cross-session landmark association; an iterated
global Kabsch fit over the matched landmark clouds (ICP) refines the
alignment to map accuracy; per-keyframe landmark-set Kabsch fits become
inter-session relative-pose edges; and the joint pose graph (odometry
chains + inter-session edges) is optimized with the distributed SE(3)
solver on the device mesh (parallel/posegraph.py).

Reported: per-session ATE, and the joint ATE of the concatenated
two-session trajectory at THREE tiers — prior-only, + global landmark
alignment, + pose-graph solve — one Horn alignment for the joint set, so
residual inter-session misalignment cannot be hidden.  The improvement
over the prior tier is the refinement tier's measured value-add:
information (the inter-session transform) no single-session filter ever
observes.

Env knobs: MS_DURATION (s, default 40), MS_PLATFORM, MS_SEED,
MS_PRIOR_YAW_DEG / MS_PRIOR_TRANS (injected prior noise, default 10 deg /
0.75 m — operator-grade), MS_STRIDE, MS_CHUNK, MS_GRAPH_ITERS,
MS_INTER_WEIGHT, MS_CACHE (default 1: cache the finished VIO sessions in
/tmp so alignment/graph iterations skip the expensive session runs).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compute_sessions(
    duration: float = 40.0,
    seed: int = 0,
    keyframe_stride: int = 5,
    chunk: int = 64,
    verbose: bool = True,
):
    """Run the two full-pipeline VIO sessions and keyframe/BA them.

    Returns a dict of plain numpy arrays (cacheable): per session s in
    {A, B}: kf_times_s, q_s, p_s, landmarks_s, lm_mask_s, frame_w_R_s,
    frame_w_t_s, ate_s, gt_kf_s."""
    import jax.numpy as jnp
    import numpy as np

    from msckf_stereo_c.config import EUROC_CALIB, FilterConfig, FrontendConfig
    from msckf_stereo_c.io import evaluate_ate
    from msckf_stereo_c.models.runner import apply_gravity_init
    from msckf_stereo_c.models.state import init_filter_state
    from msckf_stereo_c.models.vio import run_vio_sequence
    from msckf_stereo_c.parallel.multisession import session_frame_transform
    from msckf_stereo_c.parallel.refine import build_ba_problem
    from msckf_stereo_c.sim import (
        make_circle_trajectory,
        make_room_landmarks,
        synthesize_imu,
        transform_trajectory,
    )
    from msckf_stereo_c.sim.render_jax import JaxRenderer, StressEvents

    fcfg = FrontendConfig()
    mcfg = FilterConfig(ns_iters=10)
    landmarks = make_room_landmarks(num=900, radius=7.0, z_cap=3.5, seed=1)
    renderer = JaxRenderer(landmarks, EUROC_CALIB, r_wall=7.0, z_cap=3.5)

    # Session A: inner orbit.  Session B: the same room from a different
    # start pose (world yaw + offset) on a different orbit.
    trajA = make_circle_trajectory(duration=duration, radius=3.0, z_amp=0.5)
    trajB = transform_trajectory(
        make_circle_trajectory(duration=duration, radius=2.5, z_amp=0.35,
                               omega=2.0 * np.pi / 17.0),
        yaw=np.deg2rad(55.0),
        offset=(0.7, -0.5, 0.15),
    )

    out = {}
    for name, traj, s in (("A", trajA, seed), ("B", trajB, seed + 100)):
        imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=s)
        frame_idx = np.arange(0, traj.t.shape[0], 10)
        frame_t = traj.t[frame_idx]
        T = len(frame_idx)
        state = None
        results = []
        for s0 in range(0, T, chunk):
            s1 = min(s0 + chunk, T)
            img0, img1 = renderer.render_sequence(
                traj, frame_idx[s0:s1], StressEvents.nominal(s1 - s0), chunk=chunk
            )
            res = run_vio_sequence(
                fcfg, mcfg, EUROC_CALIB, frame_t[s0:s1], img0, img1,
                imu.t, imu.gyro, imu.acc,
                filter_dtype=jnp.float32, method="schur", state=state,
                prev_frame_t=float(frame_t[s0 - 1]) if s0 > 0 else None,
            )
            state = res.final_state
            results.append(res)

        def cat(f):
            return np.concatenate([np.asarray(getattr(r, f)) for r in results], 0)

        positions = cat("positions")
        quats = cat("quats_xyzw")
        fid, uv, valid = cat("fid"), cat("uv"), cat("valid")

        # The session's odometry-frame definition from ITS OWN gravity init.
        st0 = init_filter_state(mcfg, EUROC_CALIB, jnp.float32)
        q0 = np.asarray(
            apply_gravity_init(st0, imu.gyro[:200], imu.acc[:200]).imu.q
        )
        frame_w = session_frame_transform(q0, traj.R_w_b[0], traj.p[0])

        prob = build_ba_problem(
            frame_t, quats, positions, fid, uv, valid,
            calib=EUROC_CALIB, keyframe_stride=keyframe_stride,
            max_keyframes=10_000, max_landmarks=400,
        )
        assert prob is not None, f"session {name}: too few tracks for BA"
        F = prob.cam_q.shape[0]
        kf = np.arange(0, T, keyframe_stride)[:F]
        ate = evaluate_ate(frame_t, positions, frame_t, traj.p[frame_idx])
        if verbose:
            print(
                f"session {name}: {T} frames, ATE {ate.rmse:.4f} m, "
                f"{F} keyframes, {len(np.asarray(prob.landmarks))} landmarks",
                flush=True,
            )
        out[f"kf_times_{name}"] = frame_t[kf]
        out[f"q_{name}"] = quats[kf]  # published Hamilton xyzw == JPL world->body
        out[f"p_{name}"] = positions[kf]
        out[f"landmarks_{name}"] = np.asarray(prob.landmarks)
        out[f"lm_mask_{name}"] = np.asarray(prob.mask)
        out[f"frame_w_R_{name}"] = frame_w[0]
        out[f"frame_w_t_{name}"] = frame_w[1]
        out[f"ate_{name}"] = np.float64(ate.rmse)
        out[f"gt_kf_{name}"] = traj.p[frame_idx[kf]]
    return out


def align_and_solve(
    sess: dict,
    seed: int = 0,
    prior_yaw_deg: float = 10.0,
    prior_trans_m: float = 0.75,
    graph_iters: int = 12,
    inter_weight: float = 1.0,
    use_mesh: bool = True,
    verbose: bool = True,
):
    """Alignment + joint-graph tiers on finished sessions (cheap, cacheable
    input).  Returns the result dict (sans wall_s)."""
    import numpy as np

    from msckf_stereo_c.io import evaluate_ate
    from msckf_stereo_c.parallel.multisession import (
        SessionData,
        apply_rigid,
        build_joint_graph,
        intersession_edges,
        optimize_joint,
        refine_alignment,
        relative_prior,
    )

    sessA = SessionData(
        kf_times=sess["kf_times_A"], q=sess["q_A"], p=sess["p_A"],
        landmarks=sess["landmarks_A"], lm_mask=sess["lm_mask_A"],
    )
    sessB = SessionData(
        kf_times=sess["kf_times_B"], q=sess["q_B"], p=sess["p_B"],
        landmarks=sess["landmarks_B"], lm_mask=sess["lm_mask_B"],
    )
    frameA = (sess["frame_w_R_A"], sess["frame_w_t_A"])
    frameB = (sess["frame_w_R_B"], sess["frame_w_t_B"])
    gtA, gtB = sess["gt_kf_A"], sess["gt_kf_B"]
    ateA, ateB = float(sess["ate_A"]), float(sess["ate_B"])

    # Coarse dock prior with injected operator noise.
    R_ab, t_ab = relative_prior(
        frameA, frameB,
        yaw_noise_rad=np.deg2rad(prior_yaw_deg),
        trans_noise_m=prior_trans_m, seed=seed,
    )
    qB_prior, pB_prior = apply_rigid(R_ab, t_ab, sessB.q, sessB.p)
    lmsB_prior = sessB.landmarks @ R_ab.T + t_ab

    # Joint two-session ATE: ONE Horn alignment over the concatenated
    # keyframe sets (session-relative misalignment cannot be aligned away).
    t_all = np.concatenate([sessA.kf_times, sessB.kf_times + 1e4])
    gt_all = np.concatenate([gtA, gtB])
    Fa = len(sessA.kf_times)

    def joint_ate(pA, pB):
        return evaluate_ate(
            t_all, np.concatenate([pA, pB]), t_all, gt_all
        ).rmse

    before = joint_ate(sessA.p, pB_prior)

    # Tier 2: iterated global Kabsch over the matched landmark clouds —
    # refines the coarse prior to the accuracy of the maps themselves.
    R_g, t_g, ia, ib = refine_alignment(sessA.landmarks, lmsB_prior)
    R_tot = R_g @ R_ab
    t_tot = R_g @ t_ab + t_g
    qB_a, pB_a = apply_rigid(R_tot, t_tot, sessB.q, sessB.p)
    lmsB_a = sessB.landmarks @ R_tot.T + t_tot
    mid = joint_ate(sessA.p, pB_a)
    if verbose:
        print(
            f"global alignment: {len(ia)} landmark matches, joint ATE "
            f"{before:.4f} -> {mid:.4f} m", flush=True,
        )

    sessB_in_a = SessionData(
        kf_times=sessB.kf_times + 1e4,  # disjoint time axis for association
        q=qB_a, p=pB_a, landmarks=lmsB_a, lm_mask=sessB.lm_mask,
    )
    inter = intersession_edges(
        sessA, sessB_in_a, ia, ib, min_common=6, max_edges=96,
        weight=inter_weight,
    )
    n_inter = len(inter[0])
    if verbose:
        print(f"cross-session: {n_inter} edges", flush=True)
    assert n_inter >= 3, "too few inter-session edges"

    graph = build_joint_graph(sessA, sessB_in_a, inter)

    mesh = None
    if use_mesh:
        import jax as _jax

        n_dev = len(_jax.devices())
        if n_dev >= 2:
            from msckf_stereo_c.parallel.multiseq import make_mesh

            mesh = make_mesh(n_dev, axis="edges")
    refined, costs = optimize_joint(graph, mesh=mesh, iters=graph_iters)

    p_opt = np.asarray(refined.p)
    after = joint_ate(p_opt[:Fa], p_opt[Fa:len(t_all)])

    return {
        "metric": "multisession_joint_ate",
        "value": round(after, 4),
        "joint_ate_prior": round(before, 4),
        "joint_ate_global_align": round(mid, 4),
        "joint_ate_after_graph": round(after, 4),
        "improvement_x": round(before / max(after, 1e-9), 2),
        "ate_session_a": round(ateA, 4),
        "ate_session_b": round(ateB, 4),
        "landmark_matches": int(len(ia)),
        "inter_edges": int(n_inter),
        "graph_nodes": int(np.asarray(refined.q).shape[0]),
        "cost_drop": round(float(costs[0] / max(float(costs[-1]), 1e-30)), 2),
        "mesh_devices": 0 if mesh is None else int(mesh.devices.size),
        "prior_noise": f"{prior_yaw_deg} deg / {prior_trans_m} m",
    }


def run_multisession(
    duration: float = 40.0,
    seed: int = 0,
    prior_yaw_deg: float = 10.0,
    prior_trans_m: float = 0.75,
    keyframe_stride: int = 5,
    chunk: int = 64,
    graph_iters: int = 12,
    inter_weight: float = 1.0,
    use_mesh: bool = True,
    verbose: bool = True,
    cache: bool = True,
):
    import numpy as np

    t0 = time.time()
    sess = None
    cache_path = None
    if cache:
        import jax

        plat = jax.default_backend()
        cache_path = (
            f"/tmp/ms_sessions_{plat}_d{duration:g}_s{seed}"
            f"_k{keyframe_stride}_c{chunk}.npz"
        )
        if os.path.exists(cache_path):
            sess = dict(np.load(cache_path))
            if verbose:
                print(f"sessions from cache {cache_path}", flush=True)
    if sess is None:
        sess = compute_sessions(
            duration=duration, seed=seed, keyframe_stride=keyframe_stride,
            chunk=chunk, verbose=verbose,
        )
        if cache_path:
            np.savez(cache_path, **sess)
    out = align_and_solve(
        sess, seed=seed, prior_yaw_deg=prior_yaw_deg,
        prior_trans_m=prior_trans_m, graph_iters=graph_iters,
        inter_weight=inter_weight, use_mesh=use_mesh, verbose=verbose,
    )
    out["unit"] = "m"
    out["duration_s"] = duration
    out["wall_s"] = round(time.time() - t0, 1)
    return out


def main():
    import jax

    if "MS_PLATFORM" in os.environ:
        jax.config.update("jax_platforms", os.environ["MS_PLATFORM"])
        if os.environ["MS_PLATFORM"] == "cpu":
            try:
                jax.config.update("jax_num_cpu_devices", 8)
            except Exception:
                pass

    out = run_multisession(
        duration=float(os.environ.get("MS_DURATION", "40")),
        seed=int(os.environ.get("MS_SEED", "0")),
        prior_yaw_deg=float(os.environ.get("MS_PRIOR_YAW_DEG", "10")),
        prior_trans_m=float(os.environ.get("MS_PRIOR_TRANS", "0.75")),
        keyframe_stride=int(os.environ.get("MS_STRIDE", "5")),
        chunk=int(os.environ.get("MS_CHUNK", "64")),
        graph_iters=int(os.environ.get("MS_GRAPH_ITERS", "12")),
        inter_weight=float(os.environ.get("MS_INTER_WEIGHT", "1.0")),
        cache=os.environ.get("MS_CACHE", "1") == "1",
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
