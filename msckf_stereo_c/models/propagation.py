"""IMU process model: RK4 state propagation + observability-constrained
covariance propagation, as a ``lax.scan`` over a fixed per-frame IMU batch.

Re-design of the reference's ``batchImuProcessing`` /
``processModel`` / ``predictNewState`` (msckf_vio.cpp:377-531): the dynamic
"loop over buffered IMU messages" becomes a scan over ``L`` fixed slots with
invalid slots masked by ``dt = 0`` (which makes the step an exact no-op:
Phi = I, Q = 0, state unchanged) — no data-dependent control flow.

The covariance step multiplies the *full* (D, D) covariance by
``blockdiag(Phi_21, I)``; the inactive camera block is zero so this equals
the reference's partitioned update (msckf_vio.cpp:457-469) while staying a
single batched matmul.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.lie import skew
from ..utils.quaternion import jpl_to_rot, quat_normalize, rot_to_jpl
from .state import FilterState, ImuState


class ImuBatch(NamedTuple):
    """Fixed-size per-frame IMU slice; invalid slots have ``valid=False``.

    ``dt`` (optional) carries host-computed float64-exact per-sample time
    deltas.  Without it, propagation derives dt = t - state.time in the
    filter dtype — which is fine in f64 but loses ~1e-5 s per step once
    absolute times exceed ~30 s in float32 (f32 eps at t=130 s is 1e-5 s,
    0.2% of the 5 ms IMU interval), visibly degrading long-sequence
    accuracy on the f32 device path.  ``runner.pack_imu_batches`` fills it."""

    time: jnp.ndarray  # (L,)
    gyro: jnp.ndarray  # (L, 3)
    acc: jnp.ndarray  # (L, 3)
    valid: jnp.ndarray  # (L,) bool
    dt: jnp.ndarray = None  # (L,) optional host-exact deltas


def initialize_gravity_bias(gyro: jnp.ndarray, acc: jnp.ndarray):
    """Gravity/bias initialization from a static window of IMU samples
    (reference initializeGravityAndBias, msckf_vio.cpp:209-241).

    Returns (q0 world->IMU JPL, gyro_bias, gravity_world)."""
    bg = jnp.mean(gyro, axis=0)
    gravity_imu = jnp.mean(acc, axis=0)
    g = jnp.linalg.norm(gravity_imu)
    gravity_world = jnp.stack([jnp.zeros_like(g), jnp.zeros_like(g), -g])
    # R with R @ gravity_imu_hat = +z_hat;  q0 = quat(R^T) ... the reference
    # computes from_two_vector(gravity_imu, -gravity).transpose().quarternion().
    from ..utils.lie import rot_from_two_vectors

    R = rot_from_two_vectors(gravity_imu, -gravity_world)
    q0 = rot_to_jpl(R.T)
    return q0, bg, gravity_world


def _predict_new_state(imu: ImuState, dt, gyro, acc, gravity):
    """RK4 on (q, v, p) with closed-form quaternion integration
    (reference predictNewState, msckf_vio.cpp:482-531)."""
    dtype = imu.q.dtype
    gyro_norm = jnp.linalg.norm(gyro)
    Omega = jnp.zeros((4, 4), dtype)
    Omega = Omega.at[:3, :3].set(-skew(gyro))
    Omega = Omega.at[:3, 3].set(gyro)
    Omega = Omega.at[3, :3].set(-gyro)

    eye4 = jnp.eye(4, dtype=dtype)
    big = gyro_norm > 1e-5
    safe_norm = jnp.where(big, gyro_norm, 1.0)

    def dq_at(frac):
        ang = gyro_norm * dt * frac
        m_big = jnp.cos(ang) * eye4 + jnp.sin(ang) / safe_norm * Omega
        m_small = (eye4 + 2.0 * frac * dt * 0.5 * Omega) * jnp.cos(ang)
        return jnp.where(big, m_big, m_small) @ imu.q

    dq_dt = dq_at(0.5)
    dq_dt2 = dq_at(0.25)
    dR_dt_T = jpl_to_rot(quat_normalize(dq_dt)).T
    dR_dt2_T = jpl_to_rot(quat_normalize(dq_dt2)).T

    R_wi_T = jpl_to_rot(imu.q).T
    k1_v_dot = R_wi_T @ acc + gravity
    k1_p_dot = imu.v
    k1_v = imu.v + k1_v_dot * dt / 2
    k2_v_dot = dR_dt2_T @ acc + gravity
    k2_p_dot = k1_v
    k2_v = imu.v + k2_v_dot * dt / 2
    k3_v_dot = dR_dt2_T @ acc + gravity
    k3_p_dot = k2_v
    k3_v = imu.v + k3_v_dot * dt
    k4_v_dot = dR_dt_T @ acc + gravity
    k4_p_dot = k3_v

    q_new = quat_normalize(dq_dt)
    v_new = imu.v + dt / 6 * (k1_v_dot + 2 * k2_v_dot + 2 * k3_v_dot + k4_v_dot)
    p_new = imu.p + dt / 6 * (k1_p_dot + 2 * k2_p_dot + 2 * k3_p_dot + k4_p_dot)
    return q_new, v_new, p_new


def process_model_step(
    state: FilterState, t, m_gyro, m_acc, Q_imu: jnp.ndarray, valid
) -> FilterState:
    """One IMU propagation step (reference processModel, msckf_vio.cpp:409-480).

    ``valid=False`` (or a non-increasing timestamp) collapses to dt=0 which
    leaves the state exactly unchanged."""
    imu = state.imu
    dtype = state.P.dtype
    D = state.P.shape[0]
    imu_new, Phi, Q = _imu_step(imu, t, m_gyro, m_acc, Q_imu, state.gravity, valid)

    Phi_full = jnp.eye(D, dtype=dtype).at[:21, :21].set(Phi)
    P = Phi_full @ state.P @ Phi_full.T
    P = P.at[:21, :21].add(Q)
    P = 0.5 * (P + P.T)
    return state._replace(imu=imu_new, P=P)


def _imu_step(imu: ImuState, t, m_gyro, m_acc, Q_imu, gravity, valid, dt_packed=None):
    """Nominal-state RK4 step + the 21x21 (Phi, Q) pair for this sample.

    ``dt_packed``: host-exact time delta (see ImuBatch.dt); when absent the
    delta falls back to t - state.time in the filter dtype."""
    dtype = imu.q.dtype

    gyro = m_gyro - imu.bg
    acc = m_acc - imu.ba
    if dt_packed is None:
        dt_raw = jnp.asarray(t - imu.time, dtype)
    else:
        # Sentinel dt < 0 = "derive from the state clock" (see
        # runner.pack_imu_batches); >= 0 = host-exact delta.
        dt_raw = jnp.where(dt_packed < 0, t - imu.time, dt_packed).astype(dtype)
    dt = jnp.where(valid & (dt_raw > 0), dt_raw, jnp.zeros((), dtype))

    R_wi_T = jpl_to_rot(imu.q).T

    # Continuous-time error-state dynamics (21x21 F, 21x12 G).
    F = jnp.zeros((21, 21), dtype)
    F = F.at[0:3, 0:3].set(-skew(gyro))
    F = F.at[0:3, 3:6].set(-jnp.eye(3, dtype=dtype))
    F = F.at[6:9, 0:3].set(-R_wi_T @ skew(acc))
    F = F.at[6:9, 9:12].set(-R_wi_T)
    F = F.at[12:15, 6:9].set(jnp.eye(3, dtype=dtype))

    G = jnp.zeros((21, 12), dtype)
    G = G.at[0:3, 0:3].set(-jnp.eye(3, dtype=dtype))
    G = G.at[3:6, 3:6].set(jnp.eye(3, dtype=dtype))
    G = G.at[6:9, 6:9].set(-R_wi_T)
    G = G.at[9:12, 9:12].set(jnp.eye(3, dtype=dtype))

    # 3rd-order matrix-exponential approximation of Phi.
    Fdt = F * dt
    Fdt2 = Fdt @ Fdt
    Phi = jnp.eye(21, dtype=dtype) + Fdt + 0.5 * Fdt2 + (1.0 / 6.0) * (Fdt2 @ Fdt)

    q_new, v_new, p_new = _predict_new_state(imu, dt, gyro, acc, gravity)

    # Observability-constrained modification of Phi rows {0, 6, 12}
    # (msckf_vio.cpp:442-455) against the FEJ shadow states.
    R_kk_1 = jpl_to_rot(imu.q_null)
    Phi = Phi.at[0:3, 0:3].set(jpl_to_rot(q_new) @ R_kk_1.T)
    u = R_kk_1 @ gravity
    s = u / jnp.dot(u, u)
    A1 = Phi[6:9, 0:3]
    w1 = skew(imu.v_null - v_new) @ gravity
    Phi = Phi.at[6:9, 0:3].set(A1 - jnp.outer(A1 @ u - w1, s))
    A2 = Phi[12:15, 0:3]
    w2 = skew(dt * imu.v_null + imu.p_null - p_new) @ gravity
    Phi = Phi.at[12:15, 0:3].set(A2 - jnp.outer(A2 @ u - w2, s))

    Q = (Phi @ G @ Q_imu @ G.T @ Phi.T) * dt

    # A masked/no-op sample (dt == 0) must leave EVERYTHING unchanged —
    # including Phi (the OC projection rewrites rows {0,6,12} from the
    # *_null states, which differ from the current state right after a
    # measurement update, so the unguarded dt=0 Phi is NOT the identity)
    # and the FEJ shadows themselves.
    stepped = valid & (dt_raw > 0)
    eye = jnp.eye(21, dtype=dtype)
    Phi = jnp.where(stepped, Phi, eye)
    Q = jnp.where(stepped, Q, jnp.zeros_like(Q))
    new_imu = imu._replace(
        q=q_new,
        v=v_new,
        p=p_new,
        q_null=jnp.where(stepped, q_new, imu.q_null),
        v_null=jnp.where(stepped, v_new, imu.v_null),
        p_null=jnp.where(stepped, p_new, imu.p_null),
        time=jnp.where(stepped, t, imu.time),
    )
    return new_imu, Phi, Q


def propagate_sequential(state: FilterState, batch: ImuBatch, Q_imu: jnp.ndarray) -> FilterState:
    """Batch IMU propagation as a sequential scan (reference
    batchImuProcessing, msckf_vio.cpp:377-407) — the validation reference
    for ``propagate``.

    The scan composes the per-sample 21x21 transition/noise pairs
    (Phi_acc <- Phi_i Phi_acc, Q_acc <- Phi_i Q_acc Phi_i^T + Q_i) and the
    accumulated pair hits the full (D, D) covariance ONCE per frame — exact
    in exact arithmetic, and replaces L sequential D x D multiplies with
    L tiny 21 x 21 ones plus a single big one (the per-step symmetrization
    of the reference collapses into one final symmetrization)."""
    dtype = state.P.dtype
    eye21 = jnp.eye(21, dtype=dtype)
    # The IMU stream may arrive in f64 (host packing); the filter dtype wins.
    batch = ImuBatch(
        time=batch.time.astype(dtype),
        gyro=batch.gyro.astype(dtype),
        acc=batch.acc.astype(dtype),
        valid=batch.valid,
        dt=None if batch.dt is None else batch.dt.astype(dtype),
    )

    def step(carry, x):
        imu, Phi_acc, Q_acc = carry
        t, gyro, acc, valid, dt_p = x
        imu, Phi, Q = _imu_step(imu, t, gyro, acc, Q_imu, state.gravity, valid, dt_p)
        Phi_acc = Phi @ Phi_acc
        Q_acc = Phi @ Q_acc @ Phi.T + Q
        return (imu, Phi_acc, Q_acc), None

    (imu, Phi_acc, Q_acc), _ = jax.lax.scan(
        step,
        (state.imu, eye21, jnp.zeros((21, 21), dtype)),
        (batch.time, batch.gyro, batch.acc, batch.valid, batch.dt),
    )
    return _apply_propagation(state, imu, Phi_acc, Q_acc)


def _apply_propagation(state: FilterState, imu: ImuState, Phi_acc, Q_acc) -> FilterState:
    P = state.P
    P = P.at[:21, :].set(Phi_acc @ P[:21, :])
    P = P.at[:, :21].set(P[:, :21] @ Phi_acc.T)
    P = P.at[:21, :21].add(Q_acc)
    P = 0.5 * (P + P.T)
    return state._replace(imu=imu, P=P)


def propagate(state: FilterState, batch: ImuBatch, Q_imu: jnp.ndarray) -> FilterState:
    """Batch IMU propagation with log-depth sequential structure — the
    default path (equivalent to ``propagate_sequential`` up to fp
    reassociation; tested).

    The sequential scan's per-step work is almost entirely parallelizable
    once the quaternion prefix is known (gyro/acc biases are constant over
    the frame batch, as in the reference):

      1. dt per sample from a running max of accepted times (the scan's
         "time only advances on accepted samples" rule equals a cummax
         because acceptance is exactly a new running maximum).
      2. The closed-form quaternion update is a 4x4 matrix product chain
         -> associative prefix scan gives every step's start quaternion.
      3. RK4 v/p increments depend only on (q_i, acc_i, gravity), never on
         v_i or p_i -> batched evaluation + two cumsums.
      4. F_i, Phi_i, and the OC/FEJ row fix depend on per-step start/end
         states (the FEJ shadow at step i equals the step-i start state
         once any earlier sample stepped) -> batched evaluation.
      5. (Phi, Q) pairs compose associatively:
         (Phi_b, Q_b) o (Phi_a, Q_a) = (Phi_b Phi_a, Phi_b Q_a Phi_b^T + Q_b)
         -> associative reduction to the per-frame total.

    Wall-clock motivation: the scan is launch-bound (L sequential groups of
    ~40 tiny ops); this form is ~60 BATCHED ops with log2(L) matmul depth."""
    dtype = state.P.dtype
    L = batch.time.shape[0]
    t = batch.time.astype(dtype)
    gyro_m = batch.gyro.astype(dtype)
    acc_m = batch.acc.astype(dtype)
    valid = batch.valid
    imu0 = state.imu
    gravity = state.gravity

    # --- 1. Per-sample dt (sequential accept rule == running max).  With
    # host-packed deltas (ImuBatch.dt) the subtraction of near-equal
    # absolute times never happens on device — exact in any dtype. ---
    t_masked = jnp.where(valid, t, -jnp.inf)
    run_max = jnp.maximum(jax.lax.associative_scan(jnp.maximum, t_masked), imu0.time)
    t_prev = jnp.concatenate([imu0.time[None], run_max[:-1]])
    if batch.dt is None:
        dt_raw = t - t_prev
    else:
        # Sentinel dt < 0 = "derive from the clock chain" (see
        # runner.pack_imu_batches); >= 0 = host-exact delta.
        dt_raw = jnp.where(batch.dt < 0, t - t_prev, batch.dt).astype(dtype)
    stepped = valid & (dt_raw > 0)
    dt = jnp.where(stepped, dt_raw, jnp.zeros((), dtype))

    gyro = gyro_m - imu0.bg  # (L, 3) constant-bias correction
    acc = acc_m - imu0.ba

    # --- 2. Quaternion prefix: q_end_i = M_i ... M_0 q0. ---
    def omega_mat(g):
        O = jnp.zeros((4, 4), dtype)
        O = O.at[:3, :3].set(-skew(g))
        O = O.at[:3, 3].set(g)
        O = O.at[3, :3].set(-g)
        return O

    Omega = jax.vmap(omega_mat)(gyro)  # (L, 4, 4)
    gn = jnp.linalg.norm(gyro, axis=-1)  # (L,)
    eye4 = jnp.eye(4, dtype=dtype)
    big = gn > 1e-5
    safe = jnp.where(big, gn, 1.0)

    def step_mat(frac):
        ang = gn * dt * frac  # (L,)
        m_big = jnp.cos(ang)[:, None, None] * eye4 + (jnp.sin(ang) / safe)[:, None, None] * Omega
        m_small = (eye4 + (frac * dt)[:, None, None] * Omega) * jnp.cos(ang)[:, None, None]
        return jnp.where(big[:, None, None], m_big, m_small)

    # Half-angle convention of the closed form: frac=0.5 is the FULL step
    # (the sequential code's dq_at(0.5)), frac=0.25 the half step.
    M_full = step_mat(0.5)  # dt=0 -> exactly I (both branches)
    M_pre = jax.lax.associative_scan(lambda a, b: jnp.einsum("...ij,...jk->...ik", b, a), M_full)
    q_end = quat_normalize(jnp.einsum("lij,j->li", M_pre, imu0.q))  # (L, 4)
    q_start = jnp.concatenate([imu0.q[None], q_end[:-1]], axis=0)

    # Half-step quaternions for the RK4 midpoint stages.
    q_mid = quat_normalize(jnp.einsum("lij,lj->li", step_mat(0.25), q_start))

    R_start_T = jnp.swapaxes(jax.vmap(jpl_to_rot)(q_start), -1, -2)  # (L,3,3)
    R_mid_T = jnp.swapaxes(jax.vmap(jpl_to_rot)(q_mid), -1, -2)
    R_end_T = jnp.swapaxes(jax.vmap(jpl_to_rot)(q_end), -1, -2)

    # --- 3. RK4 v/p increments (independent of v_i, p_i). ---
    k1 = jnp.einsum("lij,lj->li", R_start_T, acc) + gravity  # (L, 3)
    k23 = jnp.einsum("lij,lj->li", R_mid_T, acc) + gravity  # k2 == k3
    k4 = jnp.einsum("lij,lj->li", R_end_T, acc) + gravity
    dv = (dt / 6.0)[:, None] * (k1 + 4.0 * k23 + k4)
    v_end = imu0.v + jnp.cumsum(dv, axis=0)
    v_start = jnp.concatenate([imu0.v[None], v_end[:-1]], axis=0)
    # dp = dt v_i + dt^2/6 (k1 + k2 + k3); see the sequential k*_p chain.
    dp = dt[:, None] * v_start + (dt * dt / 6.0)[:, None] * (k1 + 2.0 * k23)
    p_end = imu0.p + jnp.cumsum(dp, axis=0)
    p_start = jnp.concatenate([imu0.p[None], p_end[:-1]], axis=0)

    # --- 4. Per-step Phi + OC fix (batched). ---
    eye3 = jnp.eye(3, dtype=dtype)

    def phi_i(R_wi_T, dt_i, g_i, a_i, q_new, v_new, p_new, qn, vn, pn):
        F = jnp.zeros((21, 21), dtype)
        F = F.at[0:3, 0:3].set(-skew(g_i))
        F = F.at[0:3, 3:6].set(-eye3)
        F = F.at[6:9, 0:3].set(-R_wi_T @ skew(a_i))
        F = F.at[6:9, 9:12].set(-R_wi_T)
        F = F.at[12:15, 6:9].set(eye3)
        Fdt = F * dt_i
        Fdt2 = Fdt @ Fdt
        Phi = jnp.eye(21, dtype=dtype) + Fdt + 0.5 * Fdt2 + (1.0 / 6.0) * (Fdt2 @ Fdt)

        R_kk_1 = jpl_to_rot(qn)
        Phi = Phi.at[0:3, 0:3].set(jpl_to_rot(q_new) @ R_kk_1.T)
        u = R_kk_1 @ gravity
        s = u / jnp.dot(u, u)
        A1 = Phi[6:9, 0:3]
        w1 = skew(vn - v_new) @ gravity
        Phi = Phi.at[6:9, 0:3].set(A1 - jnp.outer(A1 @ u - w1, s))
        A2 = Phi[12:15, 0:3]
        w2 = skew(dt_i * vn + pn - p_new) @ gravity
        Phi = Phi.at[12:15, 0:3].set(A2 - jnp.outer(A2 @ u - w2, s))

        G = jnp.zeros((21, 12), dtype)
        G = G.at[0:3, 0:3].set(-eye3)
        G = G.at[3:6, 3:6].set(eye3)
        G = G.at[6:9, 6:9].set(-R_wi_T)
        G = G.at[9:12, 9:12].set(eye3)
        Q = (Phi @ G @ Q_imu @ G.T @ Phi.T) * dt_i
        return Phi, Q

    # FEJ shadow at step i = step-i start state once any earlier sample
    # stepped; before that it is the carried (possibly diverged) shadow.
    before = jnp.concatenate([jnp.zeros((1,), bool), jnp.cumsum(stepped)[:-1] > 0])
    q_null = jnp.where(before[:, None], q_start, imu0.q_null)
    v_null = jnp.where(before[:, None], v_start, imu0.v_null)
    p_null = jnp.where(before[:, None], p_start, imu0.p_null)

    Phi_all, Q_all = jax.vmap(phi_i)(
        R_start_T, dt, gyro, acc, q_end, v_end, p_end, q_null, v_null, p_null
    )
    eye21 = jnp.eye(21, dtype=dtype)
    Phi_all = jnp.where(stepped[:, None, None], Phi_all, eye21)
    Q_all = jnp.where(stepped[:, None, None], Q_all, jnp.zeros((), dtype))

    # --- 5. Associative (Phi, Q) reduction to the per-frame total. ---
    def compose(a, b):
        Phi_a, Q_a = a
        Phi_b, Q_b = b
        Phi_ba = jnp.einsum("...ij,...jk->...ik", Phi_b, Phi_a)
        Q_ba = (
            jnp.einsum("...ij,...jk,...lk->...il", Phi_b, Q_a, Phi_b) + Q_b
        )
        return Phi_ba, Q_ba

    Phi_pre, Q_pre = jax.lax.associative_scan(compose, (Phi_all, Q_all))
    Phi_acc, Q_acc = Phi_pre[-1], Q_pre[-1]

    any_stepped = jnp.any(stepped)
    last = jnp.where(any_stepped, run_max[-1], imu0.time)
    imu = imu0._replace(
        q=q_end[-1],
        v=v_end[-1],
        p=p_end[-1],
        q_null=jnp.where(any_stepped, q_end[-1], imu0.q_null),
        v_null=jnp.where(any_stepped, v_end[-1], imu0.v_null),
        p_null=jnp.where(any_stepped, p_end[-1], imu0.p_null),
        time=last,
    )
    return _apply_propagation(state, imu, Phi_acc, Q_acc)
