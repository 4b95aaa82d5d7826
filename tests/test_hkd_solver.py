"""End-to-end HS-DDP solver tests on the HKD problem (bounding reference
with flight phases — stresses reset maps and impact-aware value
propagation).  Mirrors the role of the reference's integration harnesses
(testMHPCProblem / testTrajOptInLoop)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cafempc.data import hkd_reference
from cafempc.models import hkd
from cafempc.problems import hkd_problem as hp
from cafempc.reference.quad_reference import QuadReference
from cafempc.solver.hsddp import make_solver
from cafempc.solver.options import SolverOptions
from cafempc.solver.plan import host_plan_to_device

# iteration caps under which the 0.6 s bound solve converges
OPTS = SolverOptions(max_DDP_iter=20, max_AL_iter=6)


def build(gait="bound", plan_dur=0.6):
    qr = QuadReference(hkd_reference(gait))
    qr.initialize(plan_dur)
    cfg = hp.HKDConfig(plan_duration=plan_dur)
    plan_np, pen_np, Xbar0, Ubar0, meta = hp.build_hkd_plan(qr, cfg)
    plan = host_plan_to_device(plan_np, dtype=jnp.float64)
    pen = hp.pen_to_device(pen_np, dtype=jnp.float64)
    body = np.zeros(12)
    body[5] = 0.2486
    qJ = np.array([0, -0.8, 1.6] * 4, dtype=float)
    qdummy = hkd.compute_hkd_state(
        jnp.asarray(body[0:3]), jnp.asarray(body[3:6]), jnp.asarray(qJ),
        jnp.asarray(meta["phases"][0][3], dtype=float))
    x0 = jnp.asarray(np.concatenate([body, np.asarray(qdummy)]))
    return plan, pen, x0, jnp.asarray(Xbar0), jnp.asarray(Ubar0), meta


@pytest.fixture(scope="module")
def solved():
    plan, pen, x0, Xb, Ub, meta = build()
    opts = OPTS
    solve = jax.jit(make_solver(hp.make_hkd_fns(), opts))
    s = solve(plan, pen, x0, Xb, Ub)
    return s, plan, meta


def test_solve_converges(solved):
    s, _, _ = solved
    assert bool(s.success)
    n = int(s.info.n_entries)
    costs = np.asarray(s.info.cost_buf[:n])
    # cost decreases substantially from the post-warm-start level
    assert costs[-1] < 0.1 * costs[1]
    # dynamics feasibility driven to threshold
    assert float(s.feas) < 1e-3
    # touchdown constraint satisfied to near threshold
    assert float(s.max_tconstr) < 5e-3


def test_friction_cone_satisfied(solved):
    s, plan, _ = solved
    U = np.asarray(s.traj.Ubar)
    mask = np.asarray(s.pen.reb_active)
    F = np.asarray(hp._facets())
    for k in range(U.shape[0]):
        grf = U[k, :12].reshape(4, 3)
        g = (F @ grf.T).T.reshape(20)
        viol = g[mask[k] > 0]
        if viol.size:
            assert viol.min() > -1e-6, f"friction violated at step {k}"


def test_stance_feet_stationary(solved):
    """Stance-leg qdummy (foot positions) must not drift within a phase."""
    s, plan, _ = solved
    X = np.asarray(s.traj.Xbar)
    contact = np.asarray(plan.step.contact)
    active = np.asarray(plan.step.active)
    is_reset = np.asarray(plan.step.is_reset)
    for k in range(X.shape[0] - 1):
        if active[k] and not is_reset[k]:
            for leg in range(4):
                if contact[k, leg] > 0:
                    d = X[k + 1, 12 + 3 * leg:15 + 3 * leg] \
                        - X[k, 12 + 3 * leg:15 + 3 * leg]
                    # shooting states can have small defects pre-convergence
                    assert np.abs(d).max() < 5e-3


def test_single_shooting_mode_runs():
    plan, pen, x0, Xb, Ub, _ = build(plan_dur=0.3)
    opts = OPTS
    import dataclasses
    opts = dataclasses.replace(opts, MS=False, max_AL_iter=2,
                               max_DDP_iter=3)
    solve = jax.jit(make_solver(hp.make_hkd_fns(), opts,
                                all_shooting=False))
    s = solve(plan, pen, x0, Xb, Ub)
    assert bool(s.success)
    n = int(s.info.n_entries)
    costs = np.asarray(s.info.cost_buf[:n])
    assert costs[-1] <= costs[0]
    # single shooting: no defects by construction
    assert float(s.feas) < 1e-8


def test_parallel_riccati_end_to_end():
    """Associative-scan Riccati sweep produces the same solve as the
    sequential reverse scan."""
    plan, pen, x0, Xb, Ub, _ = build(plan_dur=0.3)
    opts = OPTS
    s1 = jax.jit(make_solver(hp.make_hkd_fns(), opts,
                             parallel_riccati=False))(plan, pen, x0, Xb, Ub)
    s2 = jax.jit(make_solver(hp.make_hkd_fns(), opts,
                             parallel_riccati=True))(plan, pen, x0, Xb, Ub)
    assert bool(s2.success)
    assert abs(float(s1.cost) - float(s2.cost)) < 1e-5 * max(
        1.0, abs(float(s1.cost)))
    assert float(jnp.abs(s1.traj.Ubar - s2.traj.Ubar).max()) < 1e-4


def test_trajectory_logging(solved, tmp_path):
    """Reference-format text logs round-trip (HSDDP_Utils.h:81-142
    analogue)."""
    from cafempc.utils.traj_logging import log_trajectory_sequence, \
        load_log
    s, plan, meta = solved
    import cafempc.solver.plan as planmod
    log_trajectory_sequence(str(tmp_path), s, plan)
    X = load_log(str(tmp_path), "state_log.txt")
    U = load_log(str(tmp_path), "control_log.txt")
    assert X.shape[1] == 24 and U.shape[1] == 24
    # n_phases extra rows: one duplicated control + terminal state per phase
    n_phases = len(meta["phases"])
    n_active = int(np.asarray(plan.knot.active).sum())
    assert X.shape[0] == n_active


def test_gather_reset_matches_masked(solved):
    """max_resets gather-based reset evaluation (the bench configuration)
    == the mask-everywhere default, end to end."""
    s_ref, plan, meta = solved
    plan_, pen, x0, Xb, Ub, _ = build()
    opts = OPTS
    solve_g = jax.jit(make_solver(hp.make_hkd_fns(), opts, max_resets=16))
    s_g = solve_g(plan_, pen, x0, Xb, Ub)
    np.testing.assert_allclose(np.asarray(s_g.traj.Xbar),
                               np.asarray(s_ref.traj.Xbar),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(s_g.traj.Ubar),
                               np.asarray(s_ref.traj.Ubar),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(float(s_g.cost), float(s_ref.cost),
                               rtol=1e-10)


def test_sequential_ls_matches_parallel(solved):
    """The sequential backtracking line search (the bench configuration)
    and the batched-candidate parallel search accept identical
    trajectories (MultiPhaseDDP.cpp:95-133 semantics)."""
    s_ref, plan, meta = solved
    plan_, pen, x0, Xb, Ub, _ = build()
    opts = OPTS
    solve_seq = jax.jit(make_solver(hp.make_hkd_fns(), opts,
                                    parallel_line_search=False))
    s_seq = solve_seq(plan_, pen, x0, Xb, Ub)
    np.testing.assert_allclose(np.asarray(s_seq.traj.Xbar),
                               np.asarray(s_ref.traj.Xbar),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(s_seq.cost), float(s_ref.cost),
                               rtol=1e-10)
    assert int(s_seq.info.iters) == int(s_ref.info.iters)
