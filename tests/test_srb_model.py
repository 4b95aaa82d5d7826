"""SRB model parity vs golden fixtures."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cafempc.models import srb

TOL = 1e-10


@pytest.fixture(scope="module")
def fix(fixtures_dir):
    p = os.path.join(fixtures_dir, "srb_dynamics.npz")
    if not os.path.exists(p):
        pytest.skip("golden fixtures not generated")
    return np.load(p)


def test_srb_dynamics_matches_reference(fix):
    xd = jax.jit(jax.vmap(srb.dynamics_continuous))(
        *map(jnp.asarray, (fix["x"], fix["u"], fix["pf"], fix["ctact"])))
    assert np.abs(np.asarray(xd) - fix["xdot"]).max() < TOL


def test_srb_partials_match_reference(fix):
    Ac, Bc = jax.jit(jax.vmap(srb.dynamics_partials_continuous))(
        *map(jnp.asarray, (fix["x"], fix["u"], fix["pf"], fix["ctact"])))
    assert np.abs(np.asarray(Ac) - fix["Ac"]).max() < TOL
    assert np.abs(np.asarray(Bc) - fix["Bc"]).max() < TOL


def test_discrete_step_is_forward_euler(fix):
    x = jnp.asarray(fix["x"][0])
    u = jnp.asarray(fix["u"][0])
    pf = jnp.asarray(fix["pf"][0])
    c = jnp.asarray(fix["ctact"][0])
    dt = 0.05
    xn = srb.dynamics(x, u, pf, c, dt)
    xd = srb.dynamics_continuous(x, u, pf, c)
    assert np.allclose(np.asarray(xn), np.asarray(x + dt * xd))
