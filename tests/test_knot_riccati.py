"""Knot-axis-sharded Riccati sweep (parallel/knot_riccati.py) vs the
sequential backward recursion, on the virtual 8-device CPU mesh —
SURVEY 2.7's horizon-partitioned (sequence-parallel) axis, with reset
transforms composed across shard boundaries."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cafempc.parallel.knot_riccati import (knot_mesh,
                                           sharded_riccati_GH)


def _sequential_GH(A, B, lx, lu, lxx, luu, lux, phix, phixx, defect, w,
                   reg):
    N, xs = A.shape[0], A.shape[1]
    us = B.shape[2]
    G = phix[-1].copy()
    H = phixx[-1].copy()
    Gs = np.zeros((N + 1, xs))
    Hs = np.zeros((N + 1, xs, xs))
    Gs[-1], Hs[-1] = G, H
    for k in reversed(range(N)):
        Gn = G + H @ defect[k + 1]
        if w[k]:
            G = phix[k] + A[k].T @ Gn
            H = phixx[k] + A[k].T @ H @ A[k]
        else:
            Qx = lx[k] + A[k].T @ Gn
            Qu = lu[k] + B[k].T @ Gn
            Qxx = lxx[k] + A[k].T @ H @ A[k] + reg * np.eye(xs)
            Quu = luu[k] + B[k].T @ H @ B[k] + reg * np.eye(us)
            Qux = lux[k] + B[k].T @ H @ A[k]
            Qi = np.linalg.inv(Quu)
            G = Qx - Qux.T @ (Qi @ Qu)
            Hn = Qxx - Qux.T @ (Qi @ Qux)
            H = 0.5 * (Hn + Hn.T)
        Gs[k], Hs[k] = G, H
    Gs[0] = Gs[0] + Hs[0] @ defect[0]
    return Gs, Hs


@pytest.mark.parametrize("N", [23, 32])
def test_sharded_matches_sequential(N, rng):
    """N=23 exercises identity padding (8 devices, 24 knots incl.
    terminal); resets land both inside blocks and at block boundaries."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    xs, us, ys = 6, 3, 2
    reg = 0.05

    def mk(shape, s=0.4):
        return rng.normal(size=shape) * s

    def mkspd(n, count, s=0.3):
        M = rng.normal(size=(count, n, n)) * s
        return np.einsum("kij,kmj->kim", M, M) + 0.5 * np.eye(n)

    A = mk((N, xs, xs))
    B = mk((N, xs, us))
    C = mk((N, ys, xs), 0.2)
    D = mk((N, ys, us), 0.2)
    lx = mk((N, xs))
    lu = mk((N, us))
    ly = mk((N, ys))
    lxx = mkspd(xs, N)
    luu = mkspd(us, N)
    lux = mk((N, us, xs), 0.05)
    lyy = mkspd(ys, N, 0.1)
    phix = mk((N + 1, xs))
    phixx = mkspd(xs, N + 1)
    defect = mk((N + 1, xs), 0.01)
    # resets: one mid-block, one exactly at a shard boundary (knot 8*q)
    w = np.zeros(N, bool)
    w[[5, 8, 16]] = True

    # fold the y-output streams into the plain recursion's cost arrays
    lx_eff = lx + np.einsum("kij,ki->kj", C, ly)
    lu_eff = lu + np.einsum("kij,ki->kj", D, ly)
    lxx_eff = lxx + np.einsum("kji,kjl,klm->kim", C, lyy, C)
    luu_eff = luu + np.einsum("kji,kjl,klm->kim", D, lyy, D)
    lux_eff = lux + np.einsum("kji,kjl,klm->kim", D, lyy, C)
    G_ref, H_ref = _sequential_GH(A, B, lx_eff, lu_eff, lxx_eff,
                                  luu_eff, lux_eff, phix, phixx, defect,
                                  w, reg)

    mesh = knot_mesh(8)
    G, H = jax.jit(lambda *a: sharded_riccati_GH(*a, reg=reg, mesh=mesh))(
        *map(jnp.asarray, (A, B, C, D, lx, lu, ly, lxx, luu, lux, lyy,
                           phix, phixx, defect, w)))
    np.testing.assert_allclose(np.asarray(G), G_ref, rtol=0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(H), H_ref, rtol=0, atol=1e-8)


@pytest.mark.slow
def test_sharded_matches_sequential_cascade500_horizon(rng):
    """Equality at BASELINE.json's primary-metric scale: N=526 knots
    (250 WB dynamics + resets + 250 SRB tail structure), xs=36, us=12,
    26 reset transforms — the shapes of the cascade500 bench config
    (VERDICT r4 #3)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    N, xs, us, ys = 526, 36, 12, 12
    reg = 0.05

    def mk(shape, s=0.2):
        return rng.normal(size=shape) * s

    def mkspd(n, count, s=0.15):
        M = rng.normal(size=(count, n, n)) * s
        return np.einsum("kij,kmj->kim", M, M) + 0.8 * np.eye(n)

    # near-identity A keeps the 526-step product well-conditioned (the
    # real discretized dynamics have A ~ I + dt*J)
    A = np.broadcast_to(np.eye(xs), (N, xs, xs)) + mk((N, xs, xs), 0.03)
    B = mk((N, xs, us), 0.1)
    C = mk((N, ys, xs), 0.05)
    D = mk((N, ys, us), 0.05)
    lx, lu, ly = mk((N, xs)), mk((N, us)), mk((N, ys))
    lxx, luu = mkspd(xs, N), mkspd(us, N)
    lux = mk((N, us, xs), 0.02)
    lyy = mkspd(ys, N, 0.05)
    phix = mk((N + 1, xs))
    phixx = mkspd(xs, N + 1)
    defect = mk((N + 1, xs), 0.005)
    w = np.zeros(N, bool)
    w[np.linspace(10, N - 10, 26).astype(int)] = True

    lx_eff = lx + np.einsum("kij,ki->kj", C, ly)
    lu_eff = lu + np.einsum("kij,ki->kj", D, ly)
    lxx_eff = lxx + np.einsum("kji,kjl,klm->kim", C, lyy, C)
    luu_eff = luu + np.einsum("kji,kjl,klm->kim", D, lyy, D)
    lux_eff = lux + np.einsum("kji,kjl,klm->kim", D, lyy, C)
    G_ref, H_ref = _sequential_GH(A, B, lx_eff, lu_eff, lxx_eff,
                                  luu_eff, lux_eff, phix, phixx, defect,
                                  w, reg)

    mesh = knot_mesh(8)
    G, H = jax.jit(lambda *a: sharded_riccati_GH(*a, reg=reg, mesh=mesh))(
        *map(jnp.asarray, (A, B, C, D, lx, lu, ly, lxx, luu, lux, lyy,
                           phix, phixx, defect, w)))
    scale = np.maximum(1.0, np.abs(G_ref).max())
    np.testing.assert_allclose(np.asarray(G) / scale, G_ref / scale,
                               rtol=0, atol=1e-7)
    hscale = np.maximum(1.0, np.abs(H_ref).max())
    np.testing.assert_allclose(np.asarray(H) / hscale, H_ref / hscale,
                               rtol=0, atol=1e-7)


def test_knot_sharded_solver_matches_vmap():
    """The PRODUCTION solver with the knot-sharded sweep
    (make_batched_solver over a 2D (scenario=2, knot=4) mesh;
    hsddp.backward_sweep_knot) reproduces the plain vmap batched solver
    with the associative-scan sweep on a real HKD problem — the wiring
    VERDICT r4 #3 asked for."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    import jax.numpy as jnp
    from cafempc.models import hkd
    from cafempc.parallel.mesh import (make_batched_solver, replicate,
                                       scenario_knot_mesh, shard_batch)
    from cafempc.problems import hkd_problem as hp
    from cafempc.data import hkd_reference
    from cafempc.reference.quad_reference import QuadReference
    from cafempc.solver.options import SolverOptions
    from cafempc.solver.plan import host_plan_to_device

    qr = QuadReference(hkd_reference("bound"))
    qr.initialize(0.3)
    cfg = hp.HKDConfig(plan_duration=0.3, n_steps_max=40)
    plan_np, pen_np, Xbar0, Ubar0, meta = hp.build_hkd_plan(qr, cfg)
    dtype = jnp.float64
    plan = host_plan_to_device(plan_np, dtype=dtype)
    pen = hp.pen_to_device(pen_np, dtype=dtype)
    body = np.zeros(12)
    body[5] = 0.2486
    qJ = np.array([0, -0.8, 1.6] * 4, dtype=float)
    qd = hkd.compute_hkd_state(
        jnp.asarray(body[0:3], dtype), jnp.asarray(body[3:6], dtype),
        jnp.asarray(qJ, dtype), jnp.asarray(meta["phases"][0][3], dtype))
    x0 = np.concatenate([body, np.asarray(qd)])

    B = 2
    rng2 = np.random.default_rng(0)
    x0_b = jnp.asarray(x0[None] + rng2.normal(0, 0.01, (B, x0.shape[-1])),
                       dtype)
    pen_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), pen)
    Xb_b = jnp.broadcast_to(jnp.asarray(Xbar0, dtype), (B,) + Xbar0.shape)
    Ub_b = jnp.broadcast_to(jnp.asarray(Ubar0, dtype), (B,) + Ubar0.shape)

    opts = SolverOptions(max_AL_iter=2, max_DDP_iter=1)
    kwargs = dict(trim_output=True, parallel_line_search=False,
                  max_resets=16, reg_floor=1e-3)
    solve_ref = make_batched_solver(hp.make_hkd_fns(), opts,
                                    parallel_riccati=True, **kwargs)
    mesh2 = scenario_knot_mesh(2, 4)
    solve_ks = make_batched_solver(hp.make_hkd_fns(), opts, mesh=mesh2,
                                   **kwargs)

    s_ref = solve_ref(plan, pen_b, x0_b, Xb_b, Ub_b)
    plan_r = replicate(plan, mesh2)
    pen_s, x0_s, Xb_s, Ub_s = shard_batch((pen_b, x0_b, Xb_b, Ub_b),
                                          mesh2)
    s_ks = solve_ks(plan_r, pen_s, x0_s, Xb_s, Ub_s)

    assert bool(np.asarray(s_ks.success).all())
    np.testing.assert_allclose(np.asarray(s_ks.cost),
                               np.asarray(s_ref.cost), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(s_ks.Xbar),
                               np.asarray(s_ref.Xbar), atol=1e-8)
    np.testing.assert_allclose(np.asarray(s_ks.Ubar),
                               np.asarray(s_ref.Ubar), atol=1e-8)
    np.testing.assert_allclose(np.asarray(s_ks.K),
                               np.asarray(s_ref.K), atol=1e-7)
