"""Distributed batch bundle adjustment (Schur-complement Gauss-Newton).

The reference engine has no global refinement — its back-end marginalizes
every feature immediately (SURVEY.md §2.4).  This module adds the scaling
tier this engine introduces: keyframe poses + landmarks from the VIO run
are refined by batch BA, with the landmark set partitioned into map blocks
sharded across the device mesh.  Each device reduces its landmarks'
contributions to the (6F x 6F) pose system; a ``psum`` across devices assembles
the global Schur complement; the pose solve is replicated; landmark
back-substitution stays local to the owning shard.

Measurement model: stereo-normalized observations z = [u0 v0 u1 v1] of
landmark j from keyframe i (world->cam0 rotation R_i, camera position t_i,
static stereo extrinsic p_c1 = R01 p_c0 + t01) — identical to the filter's
measurement (update.py) minus the OC projection (BA estimates everything
jointly, no FEJ needed).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.linalg import inv3x3
from ..utils.lie import skew, so3_exp
from ..utils.quaternion import jpl_to_rot, quat_multiply, rot_to_jpl, small_angle_quaternion


class BAProblem(NamedTuple):
    cam_q: jnp.ndarray  # (F, 4) JPL world->cam0
    cam_p: jnp.ndarray  # (F, 3) cam0 position in world
    landmarks: jnp.ndarray  # (L, 3)
    obs: jnp.ndarray  # (L, F, 4) stereo-normalized observations
    mask: jnp.ndarray  # (L, F) bool
    R_c0_c1: jnp.ndarray  # (3,3)
    t_c0_c1: jnp.ndarray  # (3,)


def _residual_jacobians(cam_q, cam_p, p_w, z, R01, t01):
    """Stereo reprojection residual + Jacobians for one (landmark, kf) pair.
    Returns r (4,), J_pose (4,6) [dtheta, dp], J_lm (4,3)."""
    dtype = p_w.dtype
    R0 = jpl_to_rot(cam_q)
    R1 = R01 @ R0
    p_c0 = R0 @ (p_w - cam_p)
    p_c1 = R01 @ p_c0 + t01
    z0 = jnp.where(jnp.abs(p_c0[2]) > 1e-9, p_c0[2], 1e-9)
    z1 = jnp.where(jnp.abs(p_c1[2]) > 1e-9, p_c1[2], 1e-9)

    pred = jnp.array([p_c0[0] / z0, p_c0[1] / z0, p_c1[0] / z1, p_c1[1] / z1], dtype)
    r = pred - z

    dz0 = jnp.zeros((4, 3), dtype)
    dz0 = dz0.at[0, 0].set(1 / z0).at[1, 1].set(1 / z0)
    dz0 = dz0.at[0, 2].set(-p_c0[0] / (z0 * z0)).at[1, 2].set(-p_c0[1] / (z0 * z0))
    dz1 = jnp.zeros((4, 3), dtype)
    dz1 = dz1.at[2, 0].set(1 / z1).at[3, 1].set(1 / z1)
    dz1 = dz1.at[2, 2].set(-p_c1[0] / (z1 * z1)).at[3, 2].set(-p_c1[1] / (z1 * z1))

    # d p_c0 / d[dtheta, dp] = [skew(p_c0), -R0] (same error convention as
    # the filter, update.py _measurement_jacobian).
    dpc0 = jnp.concatenate([skew(p_c0), -R0], axis=1)  # (3,6)
    dpc1 = jnp.concatenate([R01 @ skew(p_c0), -R1], axis=1)
    J_pose = dz0 @ dpc0 + dz1 @ dpc1
    J_lm = dz0 @ R0 + dz1 @ R1
    return r, J_pose, J_lm


_rj_over_kf = jax.vmap(_residual_jacobians, in_axes=(0, 0, None, 0, None, None))
_rj_grid = jax.vmap(_rj_over_kf, in_axes=(None, None, 0, 0, None, None))


def _local_blocks(prob: BAProblem, damping):
    """Per-shard reduction: (Hpp (F,F,6,6), bp (F,6), Hll^-1, W, bl)."""
    dtype = prob.landmarks.dtype
    L, F = prob.mask.shape
    r, Jp, Jl = _rj_grid(
        prob.cam_q, prob.cam_p, prob.landmarks, prob.obs, prob.R_c0_c1, prob.t_c0_c1
    )  # (L,F,4), (L,F,4,6), (L,F,4,3)
    m = prob.mask[..., None, None].astype(dtype)
    Jp = Jp * m
    Jl = Jl * m
    r = r * prob.mask[..., None].astype(dtype)

    # Landmark blocks.
    Hll = jnp.einsum("lfab,lfac->lbc", Jl, Jl) + damping * jnp.eye(3, dtype=dtype)
    Hll_inv = inv3x3(Hll)
    W = jnp.einsum("lfab,lfac->lfbc", Jp, Jl)  # (L,F,6,3) pose-landmark
    bl = jnp.einsum("lfab,lfa->lb", Jl, r)  # (L,3)
    bp = jnp.einsum("lfab,lfa->lfb", Jp, r)  # (L,F,6)

    # Schur contributions to the pose system.
    WHinv = jnp.einsum("lfab,lbc->lfac", W, Hll_inv)  # (L,F,6,3)
    Hpp_diag = jnp.einsum("lfab,lfac->fbc", Jp, Jp)  # (F,6,6) pose self terms
    Hpp_schur = jnp.einsum("lfab,lgcb->fgac", WHinv, W)  # (F,F,6,6)
    Hpp = -Hpp_schur
    Hpp = Hpp.at[jnp.arange(F), jnp.arange(F)].add(Hpp_diag)
    bp_red = jnp.einsum("lfb->fb", bp) - jnp.einsum("lfab,lb->fa", WHinv, bl)

    cost = jnp.sum(r * r)
    return Hpp, bp_red, Hll_inv, W, bl, cost


def _apply_pose_delta(cam_q, cam_p, delta):
    """delta (F,6) = [dtheta, dp]; left-multiplicative JPL update."""
    dq = small_angle_quaternion(delta[:, :3])
    return quat_multiply(dq, cam_q), cam_p + delta[:, 3:6]


def _solve_poses(Hpp, bp, F, dtype, damping, gauge_fix: int = 1):
    """Dense pose solve with the first ``gauge_fix`` poses clamped (gauge)."""
    H = Hpp.transpose(0, 2, 1, 3).reshape(6 * F, 6 * F)
    b = bp.reshape(6 * F)
    H = H + damping * jnp.eye(6 * F, dtype=dtype)
    # Gauge fixing: huge prior on the clamped poses' deltas.
    gmask = (jnp.arange(6 * F) < 6 * gauge_fix).astype(dtype)
    H = H + jnp.diag(gmask * 1e12)
    L = jnp.linalg.cholesky(H)
    delta = jax.scipy.linalg.cho_solve((L, True), b)
    return -delta.reshape(F, 6)  # GN step: delta = -H^-1 b


def ba_gauss_newton(prob: BAProblem, iters: int = 10, damping: float = 1e-6):
    """Single-device batch BA (used as the oracle for the sharded version)."""
    dtype = prob.landmarks.dtype
    L, F = prob.mask.shape

    def step(carry, _):
        q, p, lms = carry
        pr = prob._replace(cam_q=q, cam_p=p, landmarks=lms)
        Hpp, bp, Hll_inv, W, bl, cost = _local_blocks(pr, damping)
        dpose = _solve_poses(Hpp, bp, F, dtype, damping)
        # Landmark back-substitution: dl = -Hll^-1 (bl + W^T dpose).
        Wt_dp = jnp.einsum("lfab,fa->lb", W, dpose)
        dl = -jnp.einsum("lbc,lc->lb", Hll_inv, bl + Wt_dp)
        q, p = _apply_pose_delta(q, p, dpose)
        return (q, p, lms + dl), cost

    (q, p, lms), costs = jax.lax.scan(
        step, (prob.cam_q, prob.cam_p, prob.landmarks), None, length=iters
    )
    return prob._replace(cam_q=q, cam_p=p, landmarks=lms), costs


def make_distributed_ba(mesh: Mesh, iters: int = 10, damping: float = 1e-6, axis: str = "map"):
    """Build the jitted sharded BA: landmarks (and their obs) sharded over
    ``axis``; pose system assembled with psum across devices; pose state
    replicated."""
    from jax import shard_map

    def local(cam_q, cam_p, landmarks, obs, mask, R01, t01):
        dtype = landmarks.dtype
        F = cam_q.shape[0]

        def step(carry, _):
            q, p, lms = carry
            pr = BAProblem(q, p, lms, obs, mask, R01, t01)
            Hpp, bp, Hll_inv, W, bl, cost = _local_blocks(pr, damping)
            # Global pose system across devices.
            Hpp = jax.lax.psum(Hpp, axis)
            bp = jax.lax.psum(bp, axis)
            cost = jax.lax.psum(cost, axis)
            dpose = _solve_poses(Hpp, bp, F, dtype, damping)
            Wt_dp = jnp.einsum("lfab,fa->lb", W, dpose)
            dl = -jnp.einsum("lbc,lc->lb", Hll_inv, bl + Wt_dp)
            q, p = _apply_pose_delta(q, p, dpose)
            return (q, p, lms + dl), cost

        (q, p, lms), costs = jax.lax.scan(
            step, (cam_q, cam_p, landmarks), None, length=iters
        )
        return q, p, lms, costs

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(), P(), P(axis), P()),
        check_vma=False,
    )

    @jax.jit
    def run(prob: BAProblem):
        q, p, lms, costs = sharded(
            prob.cam_q, prob.cam_p, prob.landmarks, prob.obs, prob.mask,
            prob.R_c0_c1, prob.t_c0_c1,
        )
        return prob._replace(cam_q=q, cam_p=p, landmarks=lms), costs

    return run


def problem_from_vio(
    cam_q: np.ndarray,
    cam_p: np.ndarray,
    landmarks: np.ndarray,
    obs: np.ndarray,
    mask: np.ndarray,
    R_c0_c1: np.ndarray,
    t_c0_c1: np.ndarray,
    dtype=jnp.float64,
) -> BAProblem:
    return BAProblem(
        cam_q=jnp.asarray(cam_q, dtype),
        cam_p=jnp.asarray(cam_p, dtype),
        landmarks=jnp.asarray(landmarks, dtype),
        obs=jnp.asarray(obs, dtype),
        mask=jnp.asarray(mask),
        R_c0_c1=jnp.asarray(R_c0_c1, dtype),
        t_c0_c1=jnp.asarray(t_c0_c1, dtype),
    )
