"""HKD model parity vs golden fixtures generated from the reference's
CasADi kernels (tools/golden_gen.py), plus finite-difference checks —
the analogue of the reference's test/testKKTDynamics.cpp strategy."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cafempc.models import hkd

TOL = 1e-10


@pytest.fixture(scope="module")
def dyn_fix(fixtures_dir):
    p = os.path.join(fixtures_dir, "hkd_dynamics.npz")
    if not os.path.exists(p):
        pytest.skip("golden fixtures not generated")
    return np.load(p)


@pytest.fixture(scope="module")
def fk_fix(fixtures_dir):
    p = os.path.join(fixtures_dir, "hkd_footpos.npz")
    if not os.path.exists(p):
        pytest.skip("golden fixtures not generated")
    return np.load(p)


def test_dynamics_matches_reference(dyn_fix):
    d = dyn_fix
    xn = jax.jit(jax.vmap(hkd.dynamics))(
        *map(jnp.asarray, (d["x"], d["u"], d["dt"], d["ctact"])))
    assert np.abs(np.asarray(xn) - d["xnext"]).max() < TOL


def test_dynamics_partials_match_reference(dyn_fix):
    d = dyn_fix
    A, B = jax.jit(jax.vmap(hkd.dynamics_partials))(
        *map(jnp.asarray, (d["x"], d["u"], d["dt"], d["ctact"])))
    assert np.abs(np.asarray(A) - d["A"]).max() < TOL
    assert np.abs(np.asarray(B) - d["B"]).max() < TOL


def test_foot_kinematics_match_reference(fk_fix):
    f = fk_fix
    for leg in range(4):
        idx = np.where(f["leg"] == leg)[0]
        if len(idx) == 0:
            continue
        fp = jax.jit(jax.vmap(
            lambda p, e, q: hkd.foot_position(p, e, q, leg)))
        fj = jax.jit(jax.vmap(
            lambda p, e, q: hkd.foot_jacobian(p, e, q, leg)))
        pf = fp(*map(jnp.asarray,
                     (f["pos"][idx], f["eul"][idx], f["qleg"][idx])))
        J = fj(*map(jnp.asarray,
                    (f["pos"][idx], f["eul"][idx], f["qleg"][idx])))
        assert np.abs(np.asarray(pf) - f["pf"][idx]).max() < TOL
        assert np.abs(np.asarray(J) - f["J"][idx]).max() < TOL


def test_partials_vs_finite_difference(rng):
    x = jnp.asarray(rng.uniform(-1, 1, 24))
    u = jnp.asarray(rng.uniform(-10, 10, 24))
    c = jnp.asarray([1.0, 0.0, 1.0, 0.0])
    dt = 0.01
    A, B = hkd.dynamics_partials(x, u, dt, c)
    eps = 1e-6
    for i in range(0, 24, 5):
        dx = jnp.zeros(24).at[i].set(eps)
        fd = (hkd.dynamics(x + dx, u, dt, c)
              - hkd.dynamics(x - dx, u, dt, c)) / (2 * eps)
        assert np.abs(np.asarray(A[:, i] - fd)).max() < 1e-6
        fdu = (hkd.dynamics(x, u + dx, dt, c)
               - hkd.dynamics(x, u - dx, dt, c)) / (2 * eps)
        assert np.abs(np.asarray(B[:, i] - fdu)).max() < 1e-6


def test_reset_map_semantics():
    x = jnp.arange(24.0) * 0.05
    c_cur = jnp.asarray([1.0, 0.0, 1.0, 0.0])
    c_next = jnp.asarray([0.0, 1.0, 1.0, 0.0])
    xn = hkd.reset_map(x, c_cur, c_next)
    # body state unchanged
    assert np.allclose(np.asarray(xn[:12]), np.asarray(x[:12]))
    # leg 0 stance->swing: default joint angle
    assert np.allclose(np.asarray(xn[12:15]), np.asarray(hkd.QLEG_DEFAULT))
    # leg 1 swing->stance: foot position with z zeroed
    pf = hkd.foot_position(x[3:6], x[0:3], x[15:18], 1)
    assert np.allclose(np.asarray(xn[15:18]),
                       np.asarray(pf * jnp.array([1.0, 1.0, 0.0])))
    # legs 2,3 unchanged
    assert np.allclose(np.asarray(xn[18:24]), np.asarray(x[18:24]))


def test_reset_partial_vs_fd():
    x = jnp.asarray(np.random.default_rng(1).uniform(-0.5, 0.5, 24))
    c_cur = jnp.asarray([1.0, 0.0, 0.0, 1.0])
    c_next = jnp.asarray([0.0, 1.0, 0.0, 1.0])
    P = hkd.reset_map_partial(x, c_cur, c_next)
    eps = 1e-6
    for i in range(24):
        dx = jnp.zeros(24).at[i].set(eps)
        fd = (hkd.reset_map(x + dx, c_cur, c_next)
              - hkd.reset_map(x - dx, c_cur, c_next)) / (2 * eps)
        assert np.abs(np.asarray(P[:, i] - fd)).max() < 1e-6


def test_reset_partial_closed_form_matches_ad(rng):
    """Closed-form reset_map_partial == jacfwd over all 4 transition kinds
    per leg (keep / touchdown / liftoff)."""
    cases = [([1.0, 0.0, 1.0, 0.0], [0.0, 1.0, 1.0, 0.0]),
             ([0.0, 0.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0]),
             ([1.0, 1.0, 1.0, 1.0], [0.0, 0.0, 0.0, 0.0]),
             ([1.0, 0.0, 0.0, 1.0], [1.0, 0.0, 0.0, 1.0])]
    for cc, cn in cases:
        x = jnp.asarray(rng.normal(size=24) * 0.4)
        P1 = hkd.reset_map_partial(x, jnp.asarray(cc), jnp.asarray(cn))
        P2 = hkd.reset_map_partial_ad(x, jnp.asarray(cc), jnp.asarray(cn))
        np.testing.assert_allclose(np.asarray(P1), np.asarray(P2),
                                   rtol=1e-9, atol=1e-12)


def test_foot_world_jacobians_match_ad(rng):
    for leg in range(4):
        pos = jnp.asarray(rng.normal(size=3) * 0.3)
        eul = jnp.asarray(rng.normal(size=3) * 0.5)
        qleg = jnp.asarray(rng.normal(size=3) * 0.8)
        J_eul, J_q = hkd.foot_world_jacobians(pos, eul, qleg, leg)
        Je_ad = jax.jacfwd(lambda e: hkd.foot_position(pos, e, qleg, leg))(
            eul)
        Jq_ad = jax.jacfwd(lambda q: hkd.foot_position(pos, eul, q, leg))(
            qleg)
        np.testing.assert_allclose(np.asarray(J_eul), np.asarray(Je_ad),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(J_q), np.asarray(Jq_ad),
                                   rtol=1e-9, atol=1e-12)


def test_touchdown_height_partials_match_ad(rng):
    x = jnp.asarray(rng.normal(size=24) * 0.4)

    def h(x_):
        return jnp.stack([hkd.foot_position(
            x_[3:6], x_[0:3], x_[12 + 3 * leg:15 + 3 * leg], leg)[2]
            for leg in range(4)])

    hx = hkd.touchdown_height_partials(x)
    hx_ad = jax.jacfwd(h)(x)
    np.testing.assert_allclose(np.asarray(hx), np.asarray(hx_ad),
                               rtol=1e-9, atol=1e-12)


def test_analytic_partials_match_ad(rng):
    """Closed-form dynamics_partials == jacfwd partials at random states."""
    import jax.numpy as jnp
    from cafempc.models import hkd
    for trial in range(5):
        x = jnp.asarray(rng.normal(size=24) * 0.5)
        u = jnp.asarray(rng.normal(size=24) * 2.0)
        contact = jnp.asarray(
            (rng.random(4) > 0.5).astype(float))
        A1, B1 = hkd.dynamics_partials(x, u, 0.01, contact)
        A2, B2 = hkd.dynamics_partials_ad(x, u, 0.01, contact)
        np.testing.assert_allclose(np.asarray(A1), np.asarray(A2),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(np.asarray(B1), np.asarray(B2),
                                   rtol=1e-5, atol=1e-7)
