"""Whole-body model validation: golden kinematics-derivative fixtures
(the reference's 107-kLoC generated MCKinematicsDerivativs surface) +
physics invariants + finite differences (testKKTDynamics.cpp analogue)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cafempc.models import rbda, wbm

TOL = 1e-10


@pytest.fixture(scope="module")
def model():
    return wbm.load_model()


@pytest.fixture(scope="module")
def kin_fix(fixtures_dir):
    p = os.path.join(fixtures_dir, "wb_kin_derivs.npz")
    if not os.path.exists(p):
        pytest.skip("golden fixtures not generated")
    return np.load(p)


def test_foot_vel_partials_match_reference(model, kin_fix):
    d = kin_fix
    out = jax.jit(jax.vmap(lambda q, v: rbda.foot_vel_dq(model, q, v)))(
        jnp.asarray(d["q"]), jnp.asarray(d["v"]))
    assert np.abs(np.asarray(out) - d["dvdq"]).max() < TOL


def test_foot_acc_partials_match_reference(model, kin_fix):
    d = kin_fix

    def foot_acc(q, v, qdd):
        J = rbda.foot_jacobians(model, q)
        return rbda.foot_drift(model, q, v) + jnp.einsum(
            "fij,j->fi", J, qdd)

    fa_q = jax.jit(jax.vmap(
        lambda q, v, qdd: jax.jacfwd(
            lambda q_: foot_acc(q_, v, qdd))(q)))
    out = fa_q(jnp.asarray(d["q"]), jnp.asarray(d["v"]),
               jnp.asarray(d["qdd"]))
    assert np.abs(np.asarray(out) - d["dadq"]).max() < TOL

    fa_v = jax.jit(jax.vmap(
        lambda q, v, qdd: jax.jacfwd(
            lambda v_: foot_acc(q, v_, qdd))(v)))
    out = fa_v(jnp.asarray(d["q"]), jnp.asarray(d["v"]),
               jnp.asarray(d["qdd"]))
    assert np.abs(np.asarray(out) - d["dadv"]).max() < TOL


def test_contact_force_partials_match_reference(model, kin_fix):
    d = kin_fix

    def JTF(q, F):
        J = rbda.foot_jacobians(model, q)
        return jnp.einsum("fij,fi->fj", J, F.reshape(4, 3))

    out = jax.jit(jax.vmap(
        lambda q, F: jax.jacfwd(lambda q_: JTF(q_, F))(q)))(
        jnp.asarray(d["q"]), jnp.asarray(d["F"]))
    assert np.abs(np.asarray(out) - d["dJTFdq"]).max() < TOL


def test_free_fall(model):
    q0 = jnp.zeros(18).at[2].set(0.35).at[6:].set(
        jnp.asarray([0.0, -0.8, 1.6] * 4))
    x0 = jnp.concatenate([q0, jnp.zeros(18)])
    xdot, grf = wbm.dynamics_continuous(model, x0, jnp.zeros(12),
                                        jnp.zeros(4))
    assert abs(float(xdot[20]) + 9.81) < 1e-9
    assert np.abs(np.asarray(grf)).max() == 0.0
    qdd = np.asarray(xdot[18:])
    assert np.abs(np.delete(qdd, 2)).max() < 1e-8


def test_baumgarte_contact_constraint(model, rng):
    q = jnp.asarray(rng.uniform(-0.3, 0.3, 18)).at[2].add(0.5)
    v = jnp.asarray(rng.uniform(-1, 1, 18))
    x = jnp.concatenate([q, v])
    u = jnp.asarray(rng.uniform(-5, 5, 12))
    c = jnp.asarray([1.0, 0.0, 1.0, 1.0])
    bg = 10.0
    xdot, grf = wbm.dynamics_continuous(model, x, u, c, bg)
    J = rbda.foot_jacobians(model, q).reshape(12, 18)
    a_feet = np.asarray(J @ xdot[18:]).reshape(4, 3) \
        + np.asarray(rbda.foot_drift(model, q, v)).reshape(4, 3)
    vf = np.asarray(rbda.foot_velocities(model, q, v))
    for leg in range(4):
        if c[leg] > 0:
            assert np.abs(a_feet[leg] + 2 * bg * vf[leg]).max() < 1e-8
        else:
            assert np.abs(np.asarray(grf)[3 * leg:3 * leg + 3]).max() == 0


def test_impact_zeroes_new_contact_velocity(model, rng):
    q = jnp.asarray(rng.uniform(-0.2, 0.2, 18)).at[2].add(0.4)
    v = jnp.asarray(rng.uniform(-1, 1, 18))
    x = jnp.concatenate([q, v])
    c_cur = jnp.asarray([0.0, 0.0, 1.0, 0.0])
    c_next = jnp.asarray([1.0, 1.0, 1.0, 0.0])
    xp, imp = wbm.impact(model, x, c_cur, c_next)
    vf_post = np.asarray(rbda.foot_velocities(model, xp[:18], xp[18:]))
    assert np.abs(vf_post[:2]).max() < 1e-9          # impacted legs
    assert np.allclose(np.asarray(xp[:18]), np.asarray(q))  # q unchanged
    # momentum exchange only through impacted feet: impulse on leg 3 zero
    assert np.abs(np.asarray(imp)[9:12]).max() == 0


def test_dynamics_partials_vs_fd(model, rng):
    q = jnp.asarray(rng.uniform(-0.2, 0.2, 18)).at[2].add(0.4)
    v = jnp.asarray(rng.uniform(-0.5, 0.5, 18))
    x = jnp.concatenate([q, v])
    u = jnp.asarray(rng.uniform(-5, 5, 12))
    c = jnp.asarray([1.0, 0.0, 0.0, 1.0])
    dt = 0.01
    A, B, C, D = wbm.dynamics_partials(model, x, u, dt, c)
    eps = 1e-6
    for i in range(0, 36, 7):
        dx = jnp.zeros(36).at[i].set(eps)
        fd = (wbm.dynamics(model, x + dx, u, dt, c)[0]
              - wbm.dynamics(model, x - dx, u, dt, c)[0]) / (2 * eps)
        assert np.abs(np.asarray(A[:, i] - fd)).max() < 1e-5
    for i in range(0, 12, 3):
        du = jnp.zeros(12).at[i].set(eps)
        fd = (wbm.dynamics(model, x, u + du, dt, c)[0]
              - wbm.dynamics(model, x, u - du, dt, c)[0]) / (2 * eps)
        assert np.abs(np.asarray(B[:, i] - fd)).max() < 1e-5


def test_mass_matrix_properties(model, rng):
    q = jnp.asarray(rng.uniform(-0.5, 0.5, 18))
    M = np.asarray(rbda.mass_matrix(model, q))
    assert np.allclose(M, M.T, atol=1e-12)
    w = np.linalg.eigvalsh(M)
    assert w.min() > 0
    # top-left 3x3 block is total mass * I (floating-base translation)
    assert np.allclose(M[:3, :3], 8.252 * np.eye(3), atol=1e-9)


def test_analytic_kkt_partials_match_jacfwd(model, rng):
    """Factored-KKT analytic derivative assembly
    (rbda.contact_kkt_dynamics_partials; reference WBM.cpp:459-505) ==
    jacfwd through the dynamics, over several contact sets."""
    for contact in ([1, 1, 1, 1], [1, 0, 1, 0], [0, 0, 0, 0]):
        c = jnp.asarray(contact, jnp.float64)
        x = jnp.asarray(np.concatenate([
            [0.0, 0.0, 0.26, 0.03, -0.05, 0.02],
            np.array([0.0, -0.8, 1.6] * 4) + rng.normal(0, 0.05, 12),
            rng.normal(0, 0.3, 18)]))
        u = jnp.asarray(rng.normal(0, 3.0, 12))
        dt = 0.01
        A0, B0, C0, D0 = wbm.dynamics_partials(model, x, u, dt, c, 10.0)
        A1, B1, C1, D1 = wbm.dynamics_partials_analytic(
            model, x, u, dt, c, 10.0)
        for a, b, nm in ((A0, A1, "A"), (B0, B1, "B"), (C0, C1, "C"),
                         (D0, D1, "D")):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       rtol=1e-8, atol=1e-10, err_msg=nm)


def test_analytic_impact_partial_matches_jacfwd(model, rng):
    for cur, nxt in (([0, 1, 0, 1], [1, 1, 1, 1]),
                     ([1, 1, 1, 1], [1, 1, 1, 1])):
        cc = jnp.asarray(cur, jnp.float64)
        cn = jnp.asarray(nxt, jnp.float64)
        x = jnp.asarray(np.concatenate([
            [0.0, 0.0, 0.26, 0.03, -0.05, 0.02],
            np.array([0.0, -0.8, 1.6] * 4) + rng.normal(0, 0.05, 12),
            rng.normal(0, 0.3, 18)]))
        P0 = wbm.impact_partial(model, x, cc, cn)
        P1 = wbm.impact_partial_analytic(model, x, cc, cn)
        np.testing.assert_allclose(np.asarray(P1), np.asarray(P0),
                                   rtol=1e-8, atol=1e-10)
