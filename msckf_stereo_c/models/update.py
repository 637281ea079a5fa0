"""Multi-state-constraint measurement update, fully batched.

Re-design of the reference's ``measurementJacobian`` /
``featureJacobian`` / ``gatingTest`` / ``measurementUpdate``
(msckf_vio.cpp:610-935):

* per-(track, camera) 4x6 / 4x3 Jacobian blocks with the
  observability-constrained projection are computed for the whole
  (K tracks x M slots) grid in one vmapped shot;
* the per-feature left-nullspace projection of ``H_f`` uses a batched
  *complete* QR of the (4M, 3) stacks (replaces ``svd_fulluv``,
  msckf_vio.cpp:756-766) — masked observation rows are zero and drop out;
* the SPQR sparse-QR measurement compression (msckf_vio.cpp:795-811)
  becomes either one dense masked QR of the stacked rows (``method="qr"``,
  numerically identical) or a normal-equation Cholesky square-root
  (``method="cholesky"``) which is algebraically the same compressed
  measurement and runs as pure batched matmuls;
* the EKF gain solve and covariance update follow msckf_vio.cpp:832-904.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.linalg import inv3x3, ns_posdef_inverse
from ..utils.lie import skew
from ..utils.quaternion import jpl_to_rot, quat_multiply, small_angle_quaternion
from .state import CamStates, FilterState


class TrackJacobians(NamedTuple):
    H_o: jnp.ndarray  # (K, 4M, D) nullspace-projected stacked Jacobians
    r_o: jnp.ndarray  # (K, 4M) projected residuals
    rows_valid: jnp.ndarray  # (K, 4M) which projected rows carry information


class TrackBlocks(NamedTuple):
    """Compact per-(track, camera) Jacobian blocks — the sparse structure the
    'schur' path exploits (H_x only ever touches one camera's 6 columns,
    featureJacobian msckf_vio.cpp:700-707)."""

    H_x: jnp.ndarray  # (K, M, 4, 6)
    H_f: jnp.ndarray  # (K, M, 4, 3)
    r: jnp.ndarray  # (K, M, 4)
    obs_mask: jnp.ndarray  # (K, M)


def _cam1_pose(cam_q_i, cam_p_i, R_c0_c1, t_c0_c1):
    R_w_c0 = jpl_to_rot(cam_q_i)
    R_w_c1 = R_c0_c1 @ R_w_c0
    t_c1_w = cam_p_i - R_w_c1.T @ t_c0_c1
    return R_w_c0, R_w_c1, t_c1_w


def _measurement_jacobian(
    p_w, z, cam_q_i, cam_p_i, cam_qn_i, cam_pn_i, gravity, R_c0_c1, t_c0_c1
):
    """One (track, camera) stereo-reprojection Jacobian with OC projection
    (reference measurementJacobian, msckf_vio.cpp:610-677).

    Returns H_x (4,6), H_f (4,3), r (4,)."""
    dtype = p_w.dtype
    R_w_c0, R_w_c1, t_c1_w = _cam1_pose(cam_q_i, cam_p_i, R_c0_c1, t_c0_c1)

    p_c0 = R_w_c0 @ (p_w - cam_p_i)
    p_c1 = R_w_c1 @ (p_w - t_c1_w)
    # Guard divisions; masked pairs are zeroed by the caller.
    z0 = jnp.where(jnp.abs(p_c0[2]) > 1e-9, p_c0[2], 1e-9)
    z1 = jnp.where(jnp.abs(p_c1[2]) > 1e-9, p_c1[2], 1e-9)

    dz_dpc0 = jnp.zeros((4, 3), dtype)
    dz_dpc0 = dz_dpc0.at[0, 0].set(1.0 / z0)
    dz_dpc0 = dz_dpc0.at[1, 1].set(1.0 / z0)
    dz_dpc0 = dz_dpc0.at[0, 2].set(-p_c0[0] / (z0 * z0))
    dz_dpc0 = dz_dpc0.at[1, 2].set(-p_c0[1] / (z0 * z0))

    dz_dpc1 = jnp.zeros((4, 3), dtype)
    dz_dpc1 = dz_dpc1.at[2, 0].set(1.0 / z1)
    dz_dpc1 = dz_dpc1.at[3, 1].set(1.0 / z1)
    dz_dpc1 = dz_dpc1.at[2, 2].set(-p_c1[0] / (z1 * z1))
    dz_dpc1 = dz_dpc1.at[3, 2].set(-p_c1[1] / (z1 * z1))

    dpc0_dxc = jnp.concatenate([skew(p_c0), -R_w_c0], axis=1)  # (3,6)
    dpc1_dxc = jnp.concatenate([R_c0_c1 @ skew(p_c0), -R_w_c1], axis=1)

    H_x = dz_dpc0 @ dpc0_dxc + dz_dpc1 @ dpc1_dxc  # (4,6)

    # Observability constraint: project H_x onto the nullspace of u
    # (gravity-rotation + position unobservable directions).
    u = jnp.concatenate(
        [jpl_to_rot(cam_qn_i) @ gravity, skew(p_w - cam_pn_i) @ gravity]
    )
    Hu = H_x @ u
    H_x = H_x - jnp.outer(Hu, u) / jnp.dot(u, u)
    H_f = -H_x[:, 3:6]

    r = z - jnp.array([p_c0[0] / z0, p_c0[1] / z0, p_c1[0] / z1, p_c1[1] / z1], dtype)
    return H_x, H_f, r


# vmap over camera slots, then over tracks.
_jac_over_cams = jax.vmap(
    _measurement_jacobian, in_axes=(None, 0, 0, 0, 0, 0, None, None, None)
)
_jac_grid = jax.vmap(_jac_over_cams, in_axes=(0, 0, None, None, None, None, None, None, None))


def _cam_selector(M: int, D: int) -> np.ndarray:
    """Constant (M, 6, D) one-hot placing each camera's 6-dof block."""
    E = np.zeros((M, 6, D), dtype=np.float64)
    for i in range(M):
        for a in range(6):
            E[i, a, 21 + 6 * i + a] = 1.0
    return E


def track_blocks(
    pos_w: jnp.ndarray,  # (K, 3) triangulated positions
    obs: jnp.ndarray,  # (K, M, 4)
    obs_mask: jnp.ndarray,  # (K, M) which observations participate
    cams: CamStates,
    gravity: jnp.ndarray,
    R_c0_c1: jnp.ndarray,
    t_c0_c1: jnp.ndarray,
) -> TrackBlocks:
    """Per-(track, camera) OC-projected Jacobian blocks, masked."""
    H_x, H_f, r = _jac_grid(
        pos_w, obs, cams.q, cams.p, cams.q_null, cams.p_null, gravity, R_c0_c1, t_c0_c1
    )  # (K,M,4,6), (K,M,4,3), (K,M,4)
    # where-masking, NOT multiplication: masked pairs can carry inf/NaN from
    # degenerate triangulations (0 * inf = NaN would poison the whole update).
    m = obs_mask[..., None, None]  # (K,M,1,1) broadcasts over the 4x6 blocks
    zero = jnp.zeros((), H_x.dtype)
    return TrackBlocks(
        H_x=jnp.where(m, H_x, zero),
        H_f=jnp.where(m, H_f, zero),
        r=jnp.where(obs_mask[..., None], r, zero),
        obs_mask=obs_mask,
    )


def track_jacobians(
    pos_w: jnp.ndarray,  # (K, 3) triangulated positions
    obs: jnp.ndarray,  # (K, M, 4)
    obs_mask: jnp.ndarray,  # (K, M) which observations participate
    cams: CamStates,
    gravity: jnp.ndarray,
    R_c0_c1: jnp.ndarray,
    t_c0_c1: jnp.ndarray,
) -> TrackJacobians:
    """Stacked, nullspace-projected Jacobians for every track
    (reference featureJacobian, msckf_vio.cpp:679-776)."""
    K, M, _ = obs.shape
    dtype = pos_w.dtype
    D = 21 + 6 * M

    blocks = track_blocks(pos_w, obs, obs_mask, cams, gravity, R_c0_c1, t_c0_c1)
    H_x, H_f, r = blocks.H_x, blocks.H_f, blocks.r

    # Scatter the 4x6 blocks into full-width rows via the constant selector.
    E = jnp.asarray(_cam_selector(M, D), dtype)
    H_stack = jnp.einsum("kmab,mbd->kmad", H_x, E).reshape(K, 4 * M, D)
    H_f_stack = H_f.reshape(K, 4 * M, 3)
    r_stack = r.reshape(K, 4 * M)

    # Left-nullspace projection of H_f: A = Q[:, 3:] from a complete QR.
    Q, _ = jnp.linalg.qr(H_f_stack, mode="complete")  # (K, 4M, 4M)
    A = Q[:, :, 3:]  # (K, 4M, 4M-3)
    H_o = jnp.einsum("kro,krd->kod", A, H_stack)  # (K, 4M-3, D)
    r_o = jnp.einsum("kro,kr->ko", A, r_stack)
    # Pad back to 4M rows so downstream shapes are uniform; the extra rows
    # are identically zero.
    pad = jnp.zeros((K, 3, D), dtype)
    H_o = jnp.concatenate([H_o, pad], axis=1)
    r_o = jnp.concatenate([r_o, jnp.zeros((K, 3), dtype)], axis=1)

    rows_valid = jnp.arange(4 * M)[None, :] < (4 * jnp.sum(obs_mask, axis=1) - 3)[:, None]
    return TrackJacobians(H_o=H_o, r_o=r_o, rows_valid=rows_valid)


def gating_scores(jacs: TrackJacobians, P: jnp.ndarray, sigma2) -> jnp.ndarray:
    """Mahalanobis gamma per track (reference gatingTest, msckf_vio.cpp:909).

    gamma = r^T (H P H^T + sigma2 I)^-1 r over each track's projected rows;
    zero rows only touch the sigma2 I part and contribute nothing."""
    HP = jnp.einsum("krd,de->kre", jacs.H_o, P)
    S = jnp.einsum("kre,kse->krs", HP, jacs.H_o)
    R = jacs.H_o.shape[1]
    S = S + sigma2 * jnp.eye(R, dtype=P.dtype)
    sol = jax.scipy.linalg.cho_solve((jnp.linalg.cholesky(S), True), jacs.r_o[..., None])
    return jnp.einsum("kr,kr->k", jacs.r_o, sol[..., 0])


def compress_measurements(
    jacs: TrackJacobians,
    use_mask: jnp.ndarray,  # (K,)
    method: str = "qr",
):
    """Compress all selected tracks' rows into a (D, D) square-root
    measurement (replaces the SPQR thin-QR, msckf_vio.cpp:795-811).

    Returns (R_t, r_t) with R_t^T R_t = H^T H and R_t^T r_t = H^T r, which
    leaves the EKF update invariant (H = Q [R_t; 0] for orthogonal Q whose
    discarded rows have zero Jacobian).
    """
    dtype = jacs.H_o.dtype
    K, Rrows, D = jacs.H_o.shape
    m = use_mask[:, None, None].astype(dtype)
    H = (jacs.H_o * m).reshape(K * Rrows, D)
    r = (jacs.r_o * use_mask[:, None].astype(dtype)).reshape(K * Rrows)

    if method == "qr":
        Q1, R_t = jnp.linalg.qr(H, mode="reduced")  # (KR, D), (D, D)
        r_t = Q1.T @ r
        return R_t, r_t
    elif method == "cholesky":
        N = H.T @ H
        y = H.T @ r
        # Jitter scaled to the diagonal keeps zero-information directions
        # harmless (their y component is zero).
        eps = _info_jitter(dtype) * (jnp.trace(N) / D + 1.0)
        L = jnp.linalg.cholesky(N + eps * jnp.eye(D, dtype=dtype))
        R_t = L.T
        r_t = jax.scipy.linalg.solve_triangular(L, y, lower=True)
        return R_t, r_t
    else:
        raise ValueError(f"unknown compression method {method!r}")


def _feature_basis(blocks: TrackBlocks):
    """Orthonormal basis Q1 of col(H_f) per track via batched modified
    Gram-Schmidt over the 3 columns (shared by gating and information
    accumulation)."""
    K, M = blocks.obs_mask.shape
    F = blocks.H_f.reshape(K, 4 * M, 3)
    q0 = F[..., 0]
    q0 = q0 / jnp.maximum(jnp.linalg.norm(q0, axis=-1, keepdims=True), 1e-12)
    q1 = F[..., 1] - jnp.einsum("kr,kr->k", q0, F[..., 1])[:, None] * q0
    q1 = q1 / jnp.maximum(jnp.linalg.norm(q1, axis=-1, keepdims=True), 1e-12)
    q2 = (
        F[..., 2]
        - jnp.einsum("kr,kr->k", q0, F[..., 2])[:, None] * q0
        - jnp.einsum("kr,kr->k", q1, F[..., 2])[:, None] * q1
    )
    q2 = q2 / jnp.maximum(jnp.linalg.norm(q2, axis=-1, keepdims=True), 1e-12)
    return jnp.stack([q0, q1, q2], axis=-1)  # (K, 4M, 3)


def schur_information_cam(blocks: TrackBlocks, use_mask: jnp.ndarray):
    """Accumulated information of all selected tracks with the feature
    positions marginalized, restricted to the camera block — algebraically
    identical to H_o^T H_o / H_o^T r_o of the nullspace-projected system
    (whose rows only touch camera columns), but computed without any tall QR.

    The projected rows B = (I - Q1 Q1^T) H are formed explicitly in compact
    per-camera blocks and N accumulates as the Gram matrix sum B^T B, which
    keeps N PSD to rounding even in f32 (the equivalent Schur-complement
    subtraction D - W C^-1 W^T cancels catastrophically in single
    precision).  H's camera-block structure keeps everything batched small
    matmuls: B[k,i,j] = delta_ij H_x[k,i] - Q1[k,i] (Q1[k,j]^T H_x[k,j]).

    Returns (Ncc (6M,6M), ycc (6M,))."""
    dtype = blocks.H_x.dtype
    K, M = blocks.obs_mask.shape
    use = use_mask.astype(dtype)

    Q1 = _feature_basis(blocks).reshape(K, M, 4, 3)
    W = jnp.einsum("kjac,kjab->kjcb", Q1, blocks.H_x)  # (K,M,3,6) = Q1_j^T H_xj
    B = -jnp.einsum("kiac,kjcb->kijab", Q1, W)  # (K,M,M,4,6)
    B = B.at[:, jnp.arange(M), jnp.arange(M)].add(blocks.H_x)

    rho = jnp.einsum("kiac,kia->kc", Q1, blocks.r)  # (K,3)
    r_proj = blocks.r - jnp.einsum("kiac,kc->kia", Q1, rho)  # (K,M,4)

    Ncam = jnp.einsum("k,kijab,kiJaB->jbJB", use, B, B)  # (M,6,M,6)
    ycam = jnp.einsum("k,kijab,kia->jb", use, B, r_proj)  # (M,6)
    return Ncam.reshape(6 * M, 6 * M), ycam.reshape(6 * M)


def schur_information(blocks: TrackBlocks, use_mask: jnp.ndarray, D: int):
    """Full-width (D, D) scatter of ``schur_information_cam``."""
    dtype = blocks.H_x.dtype
    Ncc, ycc = schur_information_cam(blocks, use_mask)
    N = jnp.zeros((D, D), dtype).at[21:, 21:].set(Ncc)
    y = jnp.zeros((D,), dtype).at[21:].set(ycc)
    return N, y


def cam_cov_blocks(P: jnp.ndarray, cam_idx: jnp.ndarray) -> jnp.ndarray:
    """Gather the (Mc, Mc, 6, 6) camera-camera covariance blocks for the
    camera slots in ``cam_idx`` from the full (D, D) covariance."""
    M = (P.shape[0] - 21) // 6
    Pc = P[21:, 21:].reshape(M, 6, M, 6).transpose(0, 2, 1, 3)  # (M,M,6,6)
    return Pc[cam_idx][:, cam_idx]


def _constrained_gamma(Mk, Q1, r, sigma2, ns_iters: int):
    """gamma = r^T w with  M w + Q1 lam = r,  Q1^T w = 0  (block elimination).

    ``ns_iters > 0`` solves with the Newton–Schulz inverse (batched
    matmuls); 0 uses an exact Cholesky (CPU/f64 validation)."""
    dtype = Mk.dtype
    if ns_iters:
        X = ns_posdef_inverse(Mk, sigma2, ns_iters)
        Minv_r = jnp.einsum("krs,ks->kr", X, r)
        Minv_Q = X @ Q1
    else:
        cho = jnp.linalg.cholesky(Mk)
        Minv_r = jax.scipy.linalg.cho_solve((cho, True), r[..., None])[..., 0]
        Minv_Q = jax.scipy.linalg.cho_solve((cho, True), Q1)
    QMQ = jnp.einsum("kra,krb->kab", Q1, Minv_Q)
    QMr = jnp.einsum("kra,kr->ka", Q1, Minv_r)
    lam = jnp.einsum(
        "kab,kb->ka", inv3x3(QMQ + 1e-12 * jnp.eye(3, dtype=dtype)), QMr
    )
    w = Minv_r - jnp.einsum("kra,ka->kr", Minv_Q, lam)
    return jnp.einsum("kr,kr->k", r, w)


def schur_gating_compact(
    blocks: TrackBlocks, Pc: jnp.ndarray, sigma2, ns_iters: int = 0
) -> jnp.ndarray:
    """``schur_gating`` on a camera-compacted block set: ``blocks`` carries
    only Mc camera slots per track and ``Pc`` their (Mc, Mc, 6, 6)
    covariance blocks.  Exact when every observation the update uses lives
    in those slots (e.g. the 2-slot prune update) — the dropped slots'
    Jacobian blocks are identically zero, so their rows of the full system
    contribute sigma2*I only, which the Mahalanobis form ignores."""
    dtype = blocks.H_x.dtype
    K, Mc = blocks.obs_mask.shape
    R4 = 4 * Mc

    MP = jnp.einsum("kiab,ijbc,kjdc->kijad", blocks.H_x, Pc, blocks.H_x)
    Mk = MP.transpose(0, 1, 3, 2, 4).reshape(K, R4, R4)
    Mk = Mk + sigma2 * jnp.eye(R4, dtype=dtype)

    Q1 = _feature_basis(blocks)  # (K, 4Mc, 3)
    r = blocks.r.reshape(K, R4)
    return _constrained_gamma(Mk, Q1, r, sigma2, ns_iters)


def measurement_update_schur_compact(
    state: FilterState,
    blocks: TrackBlocks,
    use_mask: jnp.ndarray,
    sigma2,
    cam_idx: jnp.ndarray,  # (Mc,) camera slots the blocks refer to
    ns_iters: int = 0,
) -> FilterState:
    """Camera-compacted Schur update: the accumulated information lives
    entirely in the ``6*Mc`` state columns of the cameras in ``cam_idx``,
    so the EKF update is rank <= 6*Mc — one small Cholesky plus (D, 6Mc)
    matmuls instead of the (D, D) Cholesky/solve of the full path.
    Algebraically identical to ``measurement_update_schur`` on the
    equivalent full-width blocks (tested)."""
    dtype = state.P.dtype
    D = state.P.shape[0]
    Mc = cam_idx.shape[0]
    Rk = 6 * Mc
    use = use_mask.astype(dtype)

    # Accumulated information restricted to the compacted camera columns.
    Q1 = _feature_basis(blocks).reshape(-1, Mc, 4, 3)
    W = jnp.einsum("kjac,kjab->kjcb", Q1, blocks.H_x)  # (K,Mc,3,6)
    B = -jnp.einsum("kiac,kjcb->kijab", Q1, W)  # (K,Mc,Mc,4,6)
    B = B.at[:, jnp.arange(Mc), jnp.arange(Mc)].add(blocks.H_x)
    rho = jnp.einsum("kiac,kia->kc", Q1, blocks.r)
    r_proj = blocks.r - jnp.einsum("kiac,kc->kia", Q1, rho)
    Ncc = jnp.einsum("k,kijab,kiJaB->jbJB", use, B, B).reshape(Rk, Rk)
    ycc = jnp.einsum("k,kijab,kia->jb", use, B, r_proj).reshape(Rk)

    # State columns the compressed measurement touches.
    cols = (21 + 6 * cam_idx[:, None] + jnp.arange(6)[None, :]).reshape(Rk)
    P = state.P
    P_cols = P[:, cols]  # (D, Rk)
    P_cc = P_cols[cols]  # (Rk, Rk)

    if ns_iters:
        # Factorization-free information form (see measurement_update_schur).
        Mu = sigma2 * jnp.eye(Rk, dtype=dtype) + Ncc @ P_cc
        W = ns_posdef_inverse(Mu, sigma2, ns_iters)
        Gcc = W @ Ncc
        Gcc = 0.5 * (Gcc + Gcc.T)
        delta = P_cols @ (W @ ycc)
        P_new = P - P_cols @ Gcc @ P_cols.T
        P_new = 0.5 * (P_new + P_new.T)
        state = apply_correction(state, delta)
        return state._replace(P=P_new)

    eps = _info_jitter(dtype) * (jnp.trace(Ncc) / Rk + 1.0)
    L = jnp.linalg.cholesky(Ncc + eps * jnp.eye(Rk, dtype=dtype))
    R_c = L.T  # (Rk, Rk): R_c^T R_c = Ncc
    r_c = jax.scipy.linalg.solve_triangular(L, ycc, lower=True)

    S = R_c @ P_cc @ R_c.T + sigma2 * jnp.eye(Rk, dtype=dtype)
    K_T = jnp.linalg.solve(S, R_c @ P_cols.T)  # (Rk, D)
    K = K_T.T  # (D, Rk) = P H^T S^-1
    delta = K @ r_c

    # P <- (I - K H) P with H = R_c scattered at ``cols``.
    P_new = P - K @ (R_c @ P_cols.T)
    P_new = 0.5 * (P_new + P_new.T)

    state = apply_correction(state, delta)
    return state._replace(P=P_new)


def schur_gating(blocks: TrackBlocks, P: jnp.ndarray, sigma2, ns_iters: int = 0) -> jnp.ndarray:
    """Exact Mahalanobis gamma of the nullspace-projected system, computed
    without forming the projection basis.

    With M_k = H_stack P H_stack^T + sigma2 I and Q1 an orthonormal basis of
    col(H_f), the projected gamma equals r^T w where w solves the
    equality-constrained system  M w + Q1 lam = r,  Q1^T w = 0  (block
    elimination with two SPD solves — Cholesky, or Newton–Schulz matmuls
    when ``ns_iters > 0``)."""
    dtype = blocks.H_x.dtype
    K, M = blocks.obs_mask.shape
    R4 = 4 * M

    # M_k blocks (i,j) = H_xi Pc[i,j] H_xj^T from the camera part of P.
    Pc = P[21:, 21:].reshape(M, 6, M, 6).transpose(0, 2, 1, 3)  # (M,M,6,6)
    MP = jnp.einsum("kiab,ijbc,kjdc->kijad", blocks.H_x, Pc, blocks.H_x)
    Mk = MP.transpose(0, 1, 3, 2, 4).reshape(K, R4, R4)
    Mk = Mk + sigma2 * jnp.eye(R4, dtype=dtype)

    Q1 = _feature_basis(blocks)  # (K, 4M, 3)
    r = blocks.r.reshape(K, R4)
    return _constrained_gamma(Mk, Q1, r, sigma2, ns_iters)


def _info_jitter(dtype) -> float:
    """Relative Cholesky jitter for the accumulated information matrix.

    The per-track Schur complement D_i - W C^-1 W^T is PSD in exact
    arithmetic but the f32 subtraction leaves residual negative eigenvalues
    of order eps_machine * |N|; the jitter must dominate them or the
    Cholesky NaNs."""
    return 1e-10 if dtype == jnp.float64 else 1e-5


def measurement_update_schur(
    state: FilterState,
    blocks: TrackBlocks,
    use_mask: jnp.ndarray,
    sigma2,
    ns_iters: int = 0,
) -> FilterState:
    """EKF update from the accumulated Schur information — the fast path
    (no QR anywhere; equivalent to measurement_update(method='cholesky')).

    ``ns_iters > 0`` switches to the factorization-free information form:
    with the accumulated camera-block information (Ncc, ycc), the update is

        Gcc = (sigma2 I + Ncc Pcc)^-1 Ncc       (symmetric by push-through)
        delta = P[:, cam] (sigma2 I + Ncc Pcc)^-1 ycc
        P'    = P - P[:, cam] Gcc P[cam, :]

    which is algebraically identical to the square-root compressed EKF
    update (substitute R_t^T R_t = Ncc, R_t^T r_t = ycc and push through),
    but needs only one Newton–Schulz inverse — batched matmuls, no
    Cholesky / triangular / LU solves anywhere."""
    dtype = state.P.dtype
    D = state.P.shape[0]
    P = state.P

    if ns_iters:
        Ncc, ycc = schur_information_cam(blocks, use_mask)
        R6 = Ncc.shape[0]
        Pcc = P[21:, 21:]
        Mu = sigma2 * jnp.eye(R6, dtype=dtype) + Ncc @ Pcc
        W = ns_posdef_inverse(Mu, sigma2, ns_iters)
        Gcc = W @ Ncc
        Gcc = 0.5 * (Gcc + Gcc.T)
        gcc = W @ ycc
        P_cols = P[:, 21:]  # (D, 6M)
        delta = P_cols @ gcc
        P_new = P - P_cols @ Gcc @ P_cols.T
        P_new = 0.5 * (P_new + P_new.T)
        state = apply_correction(state, delta)
        return state._replace(P=P_new)

    N, y = schur_information(blocks, use_mask, D)

    eps = _info_jitter(dtype) * (jnp.trace(N) / D + 1.0)
    L = jnp.linalg.cholesky(N + eps * jnp.eye(D, dtype=dtype))
    R_t = L.T
    r_t = jax.scipy.linalg.solve_triangular(L, y, lower=True)

    S = R_t @ P @ R_t.T + sigma2 * jnp.eye(D, dtype=dtype)
    K_T = jnp.linalg.solve(S, R_t @ P)
    K = K_T.T
    delta = K @ r_t

    I_KH = jnp.eye(D, dtype=dtype) - K @ R_t
    P_new = I_KH @ P
    P_new = 0.5 * (P_new + P_new.T)

    state = apply_correction(state, delta)
    return state._replace(P=P_new)


def apply_correction(state: FilterState, delta: jnp.ndarray) -> FilterState:
    """Inject the error-state correction into the nominal state
    (reference measurementUpdate, msckf_vio.cpp:859-894)."""
    imu = state.imu
    M = state.cams.q.shape[0]

    dq_imu = small_angle_quaternion(delta[0:3])
    dq_ext = small_angle_quaternion(delta[15:18])
    new_imu = imu._replace(
        q=quat_multiply(dq_imu, imu.q),
        bg=imu.bg + delta[3:6],
        v=imu.v + delta[6:9],
        ba=imu.ba + delta[9:12],
        p=imu.p + delta[12:15],
        R_imu_cam0=jpl_to_rot(dq_ext) @ imu.R_imu_cam0,
        t_cam0_imu=imu.t_cam0_imu + delta[18:21],
    )

    cam_delta = delta[21:].reshape(M, 6)
    active = (jnp.arange(M) < state.num_cams)[:, None]
    dq_cam = small_angle_quaternion(cam_delta[:, 0:3])
    q_new = quat_multiply(dq_cam, state.cams.q)
    p_new = state.cams.p + cam_delta[:, 3:6]
    cams = state.cams._replace(
        q=jnp.where(active, q_new, state.cams.q),
        p=jnp.where(active, p_new, state.cams.p),
    )
    return state._replace(imu=new_imu, cams=cams)


def measurement_update(
    state: FilterState,
    jacs: TrackJacobians,
    use_mask: jnp.ndarray,
    sigma2,
    method: str = "qr",
) -> FilterState:
    """Compressed EKF update (reference measurementUpdate, msckf_vio.cpp:778-907).

    A zero ``use_mask`` makes this an exact no-op (R_t = 0 => K = 0)."""
    dtype = state.P.dtype
    D = state.P.shape[0]
    R_t, r_t = compress_measurements(jacs, use_mask, method=method)

    P = state.P
    S = R_t @ P @ R_t.T + sigma2 * jnp.eye(D, dtype=dtype)
    # K = P R_t^T S^-1, computed as the transpose of S^-1 (R_t P).
    K_T = jnp.linalg.solve(S, R_t @ P)
    K = K_T.T
    delta = K @ r_t

    I_KH = jnp.eye(D, dtype=dtype) - K @ R_t
    P_new = I_KH @ P
    P_new = 0.5 * (P_new + P_new.T)

    state = apply_correction(state, delta)
    return state._replace(P=P_new)
