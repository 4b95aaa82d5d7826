"""Parity: lane-form WB kinematics/dynamics/partials (models/wb_lane.py)
vs the rbda reference path (models/rbda.py), f64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cafempc.models import rbda, wbm, wb_lane as wl


@pytest.fixture(scope="module")
def models():
    return wbm.load_model(), wl.load_lane_model()


def _rand_states(n, seed=0):
    rng = np.random.default_rng(seed)
    q = np.zeros((n, 18))
    q[:, 0:3] = rng.normal(0, 0.3, (n, 3))
    q[:, 2] += 0.25
    q[:, 3:6] = rng.normal(0, 0.4, (n, 3))
    q[:, 6:18] = np.tile([0.0, -0.8, 1.6], 4) \
        + rng.normal(0, 0.4, (n, 12))
    v = rng.normal(0, 1.0, (n, 18))
    u = rng.normal(0, 5.0, (n, 12))
    contact = (rng.random((n, 4)) > 0.4).astype(float)
    return q, v, u, contact


def test_fk_mass_bias_foot_parity(models):
    model, lm = models
    q, v, _, _ = _rand_states(5)
    qT = jnp.asarray(q.T)   # [18, K]
    vT = jnp.asarray(v.T)
    M_l = wl.mass_matrix_lane(lm, qT)
    h_l = wl.bias_force_lane(lm, qT, vT)
    pf_l = wl.foot_positions_lane(lm, qT)
    J_l = wl.foot_jacobians_lane(lm, qT)
    vf_l = wl.foot_velocities_lane(lm, qT, vT)
    dr_l = wl.foot_drift_lane(lm, qT, vT)
    for k in range(q.shape[0]):
        qk, vk = jnp.asarray(q[k]), jnp.asarray(v[k])
        np.testing.assert_allclose(M_l[:, :, k],
                                   rbda.mass_matrix(model, qk),
                                   rtol=0, atol=1e-11)
        np.testing.assert_allclose(h_l[:, k],
                                   rbda.bias_force(model, qk, vk),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(pf_l[:, :, k],
                                   rbda.foot_kinematics(model, qk),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(J_l[:, :, :, k],
                                   rbda.foot_jacobians(model, qk),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(vf_l[:, :, k],
                                   rbda.foot_velocities(model, qk, vk),
                                   rtol=0, atol=1e-11)
        np.testing.assert_allclose(dr_l[:, :, k],
                                   rbda.foot_drift(model, qk, vk),
                                   rtol=0, atol=1e-10)


def test_contact_dynamics_parity(models):
    model, lm = models
    q, v, u, contact = _rand_states(6, seed=1)
    tau = np.concatenate([np.zeros((6, q.shape[0])), u.T])
    qdd_l, lam_l = wl.contact_kkt_dynamics_lane(
        lm, jnp.asarray(q.T), jnp.asarray(v.T), jnp.asarray(tau),
        jnp.asarray(contact.T), bg_alpha=10.0)
    for k in range(q.shape[0]):
        qdd, lam = rbda.contact_kkt_dynamics(
            model, jnp.asarray(q[k]), jnp.asarray(v[k]),
            jnp.asarray(np.concatenate([np.zeros(6), u[k]])),
            jnp.asarray(contact[k]), 10.0)
        np.testing.assert_allclose(qdd_l[:, k], qdd, rtol=0, atol=1e-8)
        np.testing.assert_allclose(lam_l[:, k], lam, rtol=0, atol=1e-8)


def test_dyn_partials_parity(models):
    model, lm = models
    q, v, u, contact = _rand_states(4, seed=2)
    x = np.concatenate([q, v], axis=1)
    dt = np.full(q.shape[0], 0.01)
    A_l, B_l, C_l, D_l = wl.wb_dyn_partials_lane(
        lm, jnp.asarray(x.T), jnp.asarray(u.T), jnp.asarray(dt),
        jnp.asarray(contact.T), bg_alpha=10.0)
    for k in range(q.shape[0]):
        A, B, C, D = wbm.dynamics_partials_analytic(
            model, jnp.asarray(x[k]), jnp.asarray(u[k]), 0.01,
            jnp.asarray(contact[k]), 10.0)
        np.testing.assert_allclose(A_l[:, :, k], A, rtol=0, atol=1e-8)
        np.testing.assert_allclose(B_l[:, :, k], B, rtol=0, atol=1e-8)
        np.testing.assert_allclose(C_l[:, :, k], C, rtol=0, atol=1e-6)
        np.testing.assert_allclose(D_l[:, :, k], D, rtol=0, atol=1e-6)


def test_dynamics_step_parity(models):
    model, lm = models
    q, v, u, contact = _rand_states(4, seed=3)
    x = np.concatenate([q, v], axis=1)
    dt = np.full(q.shape[0], 0.01)
    xn_l, grf_l = wl.wb_dynamics_lane(
        lm, jnp.asarray(x.T), jnp.asarray(u.T), jnp.asarray(dt),
        jnp.asarray(contact.T), bg_alpha=10.0)
    for k in range(q.shape[0]):
        xn, grf = wbm.dynamics(model, jnp.asarray(x[k]),
                               jnp.asarray(u[k]), 0.01,
                               jnp.asarray(contact[k]), 10.0)
        np.testing.assert_allclose(xn_l[:, k], xn, rtol=0, atol=1e-8)
        np.testing.assert_allclose(grf_l[:, k], grf, rtol=0, atol=1e-8)


def test_impulse_parity(models):
    model, lm = models
    q, v, _, contact = _rand_states(5, seed=4)
    vp_l, imp_l = wl.impulse_dynamics_lane(
        lm, jnp.asarray(q.T), jnp.asarray(v.T), jnp.asarray(contact.T))
    dq_l, dv_l = wl.impulse_dynamics_partials_lane(
        lm, jnp.asarray(q.T), jnp.asarray(v.T), jnp.asarray(contact.T))
    for k in range(q.shape[0]):
        vp, imp = rbda.impulse_dynamics(model, jnp.asarray(q[k]),
                                        jnp.asarray(v[k]),
                                        jnp.asarray(contact[k]))
        np.testing.assert_allclose(vp_l[:, k], vp, rtol=0, atol=1e-9)
        np.testing.assert_allclose(imp_l[:, k], imp, rtol=0, atol=1e-8)
        dq, dv_ = rbda.impulse_dynamics_partials(
            model, jnp.asarray(q[k]), jnp.asarray(v[k]),
            jnp.asarray(contact[k]))
        np.testing.assert_allclose(dq_l[:, :, k], dq, rtol=0, atol=1e-8)
        np.testing.assert_allclose(dv_l[:, :, k], dv_, rtol=0, atol=1e-8)


def test_cf_bundle_derivatives_vs_ad(models):
    """The closed-form FK derivative stacks (ancestor cross-product
    rules, wb_lane.cf_bundle — PERF.md roadmap #2) match batched-jvp AD
    to machine precision."""
    _, lm = models
    q, _, _, _ = _rand_states(3, seed=5)
    qT = jnp.asarray(q.T)
    cf = wl.cf_bundle(lm, qT)

    def bj(q_):
        R, p, aw = wl.fk_lane(lm, q_)
        return wl._body_jacobians_lane(lm, R, p, aw)

    checks = [
        (cf.daw, lambda q_: wl.fk_lane(lm, q_)[2]),
        (cf.dp, lambda q_: wl.fk_lane(lm, q_)[1]),
        (cf.dpts, lambda q_: wl.foot_positions_lane(lm, q_)),
        (cf.dcom, lambda q_: bj(q_)[0]),
        (cf.dJw, lambda q_: bj(q_)[1]),
        (cf.dJv, lambda q_: bj(q_)[2]),
        (cf.dIw, lambda q_: bj(q_)[3]),
        (cf.dJ, lambda q_: wl.foot_jacobians_lane(lm, q_)),
    ]
    for got, fn in checks:
        ad = wl.jac_lane(fn, qT)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ad),
                                   rtol=0, atol=1e-12)


def test_cf_partials_match_jvp_path(models, monkeypatch):
    """KKT/impulse partials via the closed-form tangent assembly
    (CAFEMPC_WB_CF=1, the default) equal the batched-jvp residual
    tangents (CAFEMPC_WB_CF=0) on random states/contacts."""
    _, lm = models
    q, v, u, contact = _rand_states(4, seed=7)
    qT = jnp.asarray(q.T)
    vT = jnp.asarray(v.T)
    tauT = jnp.concatenate([jnp.zeros((6, q.shape[0])),
                            jnp.asarray(u.T)])
    cT = jnp.asarray(contact.T)

    monkeypatch.setenv("CAFEMPC_WB_CF", "0")
    ref = wl.contact_kkt_dynamics_partials_lane(lm, qT, vT, tauT, cT,
                                                10.0)
    ref_i = wl.impulse_dynamics_partials_lane(lm, qT, vT, cT)
    monkeypatch.setenv("CAFEMPC_WB_CF", "1")
    new = wl.contact_kkt_dynamics_partials_lane(lm, qT, vT, tauT, cT,
                                                10.0)
    new_i = wl.impulse_dynamics_partials_lane(lm, qT, vT, cT)
    for a, b in zip(ref, new):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=1e-9)
    for a, b in zip(ref_i, new_i):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=1e-9)
