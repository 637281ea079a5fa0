"""Bundle-adjustment tests: convergence on synthetic problems and
single-device vs sharded (8-way map-block) equivalence."""
import jax
import jax.numpy as jnp
import numpy as np

from msckf_stereo_c.parallel.ba import (
    BAProblem,
    ba_gauss_newton,
    make_distributed_ba,
)
from msckf_stereo_c.utils.quaternion import jpl_to_rot, rot_to_jpl
from msckf_stereo_c.utils.lie import so3_exp

RNG = np.random.default_rng(17)

R01 = jnp.eye(3, dtype=jnp.float64)
T01 = jnp.asarray([-0.1, 0.0, 0.0], jnp.float64)


def _make_problem(F=6, L=64, noise=0.0, perturb=0.02):
    """Cameras on an arc observing a landmark cloud; returns (true, perturbed)."""
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
    lms = jnp.asarray(RNG.uniform(-1.0, 1.0, (L, 3)) + np.array([0, 0, 1.5]))

    R0 = jpl_to_rot(cam_q)
    p_c0 = jnp.einsum("fij,lfj->lfi", R0, lms[:, None] - cam_p[None])
    p_c1 = jnp.einsum("ij,lfj->lfi", R01, p_c0) + T01
    mask = (p_c0[..., 2] > 0.3) & (p_c1[..., 2] > 0.3)
    uv0 = p_c0[..., :2] / p_c0[..., 2:]
    uv1 = p_c1[..., :2] / p_c1[..., 2:]
    obs = jnp.concatenate([uv0, uv1], axis=-1)
    obs = obs + noise * jnp.asarray(RNG.standard_normal(obs.shape))
    obs = obs * mask[..., None]

    true = BAProblem(cam_q, cam_p, lms, obs, mask, R01, T01)

    # Perturb poses (except the gauge pose) and landmarks.
    dth = RNG.normal(0, perturb, (F, 3))
    dth[0] = 0
    dp = RNG.normal(0, perturb, (F, 3))
    dp[0] = 0
    q_pert = jax.vmap(lambda q, d: rot_to_jpl(so3_exp(d) @ jpl_to_rot(q)))(
        cam_q, jnp.asarray(dth)
    )
    pert = true._replace(
        cam_q=q_pert,
        cam_p=cam_p + jnp.asarray(dp),
        landmarks=lms + jnp.asarray(RNG.normal(0, perturb, (L, 3))),
    )
    return true, pert


def test_ba_converges_to_truth():
    true, pert = _make_problem()
    refined, costs = ba_gauss_newton(pert, iters=15)
    # Costs decrease monotonically-ish and end near zero.
    assert float(costs[-1]) < 1e-12, float(costs[-1])
    np.testing.assert_allclose(np.asarray(refined.cam_p), np.asarray(true.cam_p), atol=1e-5)
    np.testing.assert_allclose(np.asarray(refined.landmarks), np.asarray(true.landmarks), atol=1e-5)


def test_ba_noisy_improves():
    true, pert = _make_problem(noise=1e-3, perturb=0.05)
    refined, costs = ba_gauss_newton(pert, iters=15)
    err0 = np.linalg.norm(np.asarray(pert.cam_p) - np.asarray(true.cam_p))
    err1 = np.linalg.norm(np.asarray(refined.cam_p) - np.asarray(true.cam_p))
    assert err1 < 0.2 * err0, (err0, err1)


def test_distributed_ba_matches_single():
    from msckf_stereo_c.parallel.multiseq import make_mesh

    true, pert = _make_problem(L=64)
    mesh = make_mesh(8, axis="map")
    run = make_distributed_ba(mesh, iters=10)
    ref_single, costs_s = ba_gauss_newton(pert, iters=10)
    ref_shard, costs_d = run(pert)
    # Early costs match to fp-reduction-order noise; late ones are numerical
    # zeros (~1e-28) where relative comparison is meaningless.
    np.testing.assert_allclose(
        np.asarray(costs_d), np.asarray(costs_s), rtol=1e-6, atol=1e-20
    )
    assert float(costs_d[-1]) < 1e-12 and float(costs_s[-1]) < 1e-12
    np.testing.assert_allclose(
        np.asarray(ref_shard.cam_p), np.asarray(ref_single.cam_p), atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(ref_shard.landmarks), np.asarray(ref_single.landmarks), atol=1e-9
    )
