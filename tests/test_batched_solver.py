"""Solve-level parity of the batched scenario engine (parallel/mesh.py):

  * the vmap-batched solve == one un-batched solve per scenario, with the
    bench's solver settings (gather-site resets, sequential line search,
    reg floor);
  * the same batch sharded over the 8-device CPU mesh == vmap.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cafempc.parallel.mesh import (make_batched_solver, replicate,
                                   scenario_mesh, shard_batch)
from cafempc.problems import hkd_problem as hp
from cafempc.solver.hsddp import make_solver
from cafempc.solver.options import SolverOptions

from tests.test_hkd_solver import build

RUNTIME_OPTS = SolverOptions(max_AL_iter=2, max_DDP_iter=1)
BENCH_KW = dict(trim_output=True, max_resets=16, parallel_line_search=False,
                reg_floor=RUNTIME_OPTS.reg_min_init)


@pytest.fixture(scope="module")
def problem():
    return build(plan_dur=0.3)


def _batch_inputs(pen, x0, Xb, Ub, B, rng):
    pen_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), pen)
    x0_b = jnp.asarray(x0)[None] + jnp.asarray(
        rng.normal(0, 0.01, (B, x0.shape[0])))
    Xb_b = jnp.broadcast_to(Xb, (B,) + Xb.shape)
    Ub_b = jnp.broadcast_to(Ub, (B,) + Ub.shape)
    return pen_b, x0_b, Xb_b, Ub_b


def test_vmap_batched_solve_default_path(problem, rng):
    """Default solver settings under plain vmap."""
    plan, pen, x0, Xb, Ub, _ = problem
    B = 4
    solve_b = make_batched_solver(hp.make_hkd_fns(), RUNTIME_OPTS)
    pen_b, x0_b, Xb_b, Ub_b = _batch_inputs(pen, x0, Xb, Ub, B, rng)
    s = solve_b(plan, pen_b, x0_b, Xb_b, Ub_b)
    assert s.traj.Xbar.shape[0] == B
    assert bool(jnp.all(s.success))
    # different initial states -> different solutions
    assert float(jnp.abs(s.traj.Ubar[0] - s.traj.Ubar[1]).max()) > 0


def test_batched_matches_unbatched(problem, rng):
    """The batched sweep rule (one op for the whole batch) and the
    un-batched recursion give the same solves, scenario by scenario."""
    plan, pen, x0, Xb, Ub, _ = problem
    B = 3
    pen_b, x0_b, Xb_b, Ub_b = _batch_inputs(pen, x0, Xb, Ub, B, rng)
    s_b = make_batched_solver(hp.make_hkd_fns(), RUNTIME_OPTS, **BENCH_KW)(
        plan, pen_b, x0_b, Xb_b, Ub_b)
    solve_1 = jax.jit(make_solver(hp.make_hkd_fns(), RUNTIME_OPTS,
                                  **BENCH_KW))
    for i in range(B):
        s_1 = solve_1(plan, pen, x0_b[i], Xb, Ub)
        np.testing.assert_allclose(np.asarray(s_b.Xbar[i]),
                                   np.asarray(s_1.Xbar), rtol=1e-9,
                                   atol=1e-11)
        np.testing.assert_allclose(np.asarray(s_b.Ubar[i]),
                                   np.asarray(s_1.Ubar), rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(float(s_b.cost[i]), float(s_1.cost),
                                   rtol=1e-10)
        assert bool(s_b.success[i]) and bool(s_1.success)


def test_sharded_matches_vmap(problem, rng):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    plan, pen, x0, Xb, Ub, _ = problem
    B = 8
    mesh = scenario_mesh(8)
    pen_b, x0_b, Xb_b, Ub_b = _batch_inputs(pen, x0, Xb, Ub, B, rng)
    s_ref = make_batched_solver(hp.make_hkd_fns(), RUNTIME_OPTS,
                                **BENCH_KW)(plan, pen_b, x0_b, Xb_b, Ub_b)
    solve_s = make_batched_solver(hp.make_hkd_fns(), RUNTIME_OPTS,
                                  mesh=mesh, **BENCH_KW)
    s_sh = solve_s(replicate(plan, mesh),
                   *shard_batch((pen_b, x0_b, Xb_b, Ub_b), mesh))
    np.testing.assert_allclose(np.asarray(s_sh.Ubar), np.asarray(s_ref.Ubar),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(s_sh.cost), np.asarray(s_ref.cost),
                               rtol=1e-8)


def test_knot_axis_excludes_parallel_riccati():
    with pytest.raises(ValueError, match="knot-sharded"):
        make_solver(hp.make_hkd_fns(), RUNTIME_OPTS, knot_axis="knot",
                    knot_shards=2, parallel_riccati=True)
