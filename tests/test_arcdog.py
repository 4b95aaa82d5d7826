"""Arcdog robot support (second URDF, gen_regular_arcdog.py + BASELINE
config 5): model build, whole-body dynamics FD check, reference
generation with model-derived mass and IK."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cafempc.models import rbda, wbm


@pytest.fixture(scope="module")
def arcdog():
    return wbm.load_model(wbm.ARCDOG_URDF)


def test_arcdog_model_builds(arcdog):
    m = arcdog
    assert np.asarray(m.mass).shape[0] == 18   # 6 base + 12 joint dofs
    total = float(np.asarray(m.mass).sum())
    assert 5.0 < total < 40.0
    # mass matrix SPD at a nominal configuration
    q = jnp.asarray(np.concatenate([[0, 0, 0.36, 0, 0, 0],
                                    [0.0, -0.8, 1.6] * 4]))
    M = np.asarray(rbda.mass_matrix(arcdog, q))
    assert np.allclose(M, M.T, atol=1e-10)
    assert np.linalg.eigvalsh(M).min() > 0


def test_arcdog_dynamics_fd(arcdog, rng):
    """Contact-KKT dynamics partials vs finite differences
    (testKKTDynamics.cpp analogue, on the second robot)."""
    x = np.concatenate([[0.0, 0.0, 0.36, 0.05, -0.03, 0.02],
                        [0.0, -0.8, 1.6] * 4,
                        rng.normal(0, 0.1, 18)])
    u = rng.normal(0, 2.0, 12)
    contact = jnp.asarray([1.0, 0.0, 1.0, 1.0])
    dt = 0.01

    def f(x_, u_):
        xn, _ = wbm.dynamics(arcdog, jnp.asarray(x_), jnp.asarray(u_), dt,
                             contact, 20.0)
        return xn

    A, B = jax.jacfwd(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(u))
    eps = 1e-6
    for i in [0, 5, 17, 20, 30]:
        dx = np.zeros(36)
        dx[i] = eps
        fd = (np.asarray(f(x + dx, u)) - np.asarray(f(x - dx, u))) / (2 * eps)
        assert np.abs(np.asarray(A[:, i]) - fd).max() < 5e-5
    for i in [0, 7, 11]:
        du = np.zeros(12)
        du[i] = eps
        fd = (np.asarray(f(x, u + du)) - np.asarray(f(x, u - du))) / (2 * eps)
        assert np.abs(np.asarray(B[:, i]) - fd).max() < 5e-5


def test_arcdog_reference_generation(arcdog):
    """gen_regular_arcdog.py analogue: trot at z=0.36, swing 0.15, with
    arcdog IK; verify FK consistency and model-derived stance GRF."""
    from cafempc.reference.generator import G, generate_reference
    d = generate_reference(gait_name="trot", duration=1.0, vx=0.5,
                           z_des=0.36, swing_height=0.15,
                           transition_time=0.5, model=arcdog)
    assert np.allclose(d.body_state[:, 2], 0.36)
    # IK consistency on a full-stance knot
    c = d.contact.sum(axis=1)
    ks = np.where(c == 4)[0]
    k = int(ks[len(ks) // 2])
    q = jnp.concatenate([jnp.asarray(d.body_state[k][:6]),
                         jnp.asarray(d.qJ[k])])
    pf = np.asarray(rbda.foot_kinematics(arcdog, q)).reshape(12)
    assert np.abs(pf - d.foot_placements[k]).max() < 1e-5
    # stance GRF shares the arcdog weight, not the mini-cheetah's
    total = float(np.asarray(arcdog.mass).sum())
    assert abs(d.grf[k][2::3].sum() - total * G) < 1e-6
