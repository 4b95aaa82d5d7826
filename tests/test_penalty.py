"""Unit tests for the ReB / AL penalty math against naive per-element
reference implementations (ConstraintsBase.h formulas)."""
import jax.numpy as jnp
import numpy as np

from cafempc.solver import penalty


def naive_reb_cost(g, delta, eps, active):
    out = 0.0
    for gi, di, ei, ai in zip(g, delta, eps, active):
        if not ai:
            continue
        if gi > di:
            barr = -np.log(gi)
        else:
            barr = 0.5 * (((gi - 2 * di) / di) ** 2 - 1) - np.log(di)
        out += ei * barr
    return out


def test_reb_cost_matches_reference_formula(rng):
    n = 12
    g = rng.uniform(-0.5, 2.0, n)
    delta = rng.uniform(0.05, 0.3, n)
    eps = rng.uniform(0.1, 1.0, n)
    active = (rng.uniform(0, 1, n) > 0.3).astype(float)
    ours = float(penalty.reb_cost(jnp.asarray(g), jnp.asarray(delta),
                                  jnp.asarray(eps), jnp.asarray(active)))
    assert abs(ours - naive_reb_cost(g, delta, eps, active)) < 1e-12


def test_reb_partials_finite_difference(rng):
    n = 6
    g = rng.uniform(0.05, 1.0, n)
    delta = np.full(n, 0.2)
    eps = np.full(n, 0.5)
    active = np.ones(n)
    gx = rng.normal(size=(n, 4))
    gu = rng.normal(size=(n, 3))
    gy = np.zeros((n, 0))
    grad_x, grad_u, _, hess_x, hess_u, _ = penalty.reb_partials(
        jnp.asarray(g), jnp.asarray(gx), jnp.asarray(gu), jnp.asarray(gy),
        jnp.asarray(delta), jnp.asarray(eps), jnp.asarray(active))
    # gradient chain rule: d/dx sum eps*barr(g(x)) = gx^T (eps*barr')
    h = 1e-7
    for j in range(4):
        gp = g + h * gx[:, j]
        gm = g - h * gx[:, j]
        fd = (naive_reb_cost(gp, delta, eps, active)
              - naive_reb_cost(gm, delta, eps, active)) / (2 * h)
        assert abs(float(grad_x[j]) - fd) < 1e-5
    # Gauss-Newton Hessian is PSD
    w = np.linalg.eigvalsh(np.asarray(hess_x))
    assert w.min() > -1e-12


def test_al_cost_and_partials(rng):
    n = 4
    h = rng.normal(size=n)
    lam = rng.normal(size=n)
    sigma = rng.uniform(1, 10, n)
    active = np.asarray([1.0, 1.0, 0.0, 1.0])
    hx = rng.normal(size=(n, 5))
    c = float(penalty.al_cost(jnp.asarray(h), jnp.asarray(lam),
                              jnp.asarray(sigma), jnp.asarray(active)))
    expect = sum(0.5 * s * hi ** 2 + li * hi
                 for hi, li, s, a in zip(h, lam, sigma, active) if a)
    assert abs(c - expect) < 1e-12
    grad, hess = penalty.al_partials(jnp.asarray(h), jnp.asarray(hx),
                                     jnp.asarray(lam), jnp.asarray(sigma),
                                     jnp.asarray(active))
    expect_g = sum((s * hi + li) * hx[i]
                   for i, (hi, li, s, a) in enumerate(
                       zip(h, lam, sigma, active)) if a)
    assert np.abs(np.asarray(grad) - expect_g).max() < 1e-12
    # the reference's AL Hessian quirk: sigma*(1+h)+lambda weights
    expect_h = sum((s * (1 + hi) + li) * np.outer(hx[i], hx[i])
                   for i, (hi, li, s, a) in enumerate(
                       zip(h, lam, sigma, active)) if a)
    assert np.abs(np.asarray(hess) - expect_h).max() < 1e-12


def test_al_update_schedule():
    h = jnp.asarray([0.0005, 0.01, 0.003, 0.5])
    lam = jnp.zeros(4)
    sigma = jnp.full(4, 5.0)
    active = jnp.ones(4)
    lam2, sig2 = penalty.al_update_params(h, lam, sigma, active,
                                          thresh=1e-3, beta=8.0,
                                          sigma_max=20.0)
    # |h| < thresh: untouched
    assert float(sig2[0]) == 5.0 and float(lam2[0]) == 0.0
    # |h| > 0.005: penalty bump, capped
    assert float(sig2[1]) == 40.0 or float(sig2[1]) == 20.0
    assert float(sig2[1]) == 20.0  # min(5*8, 20)
    assert float(sig2[3]) == 20.0
    # thresh <= |h| <= 0.005: Lagrange update
    assert abs(float(lam2[2]) - 0.003 * 5.0) < 1e-12
    assert float(sig2[2]) == 5.0
