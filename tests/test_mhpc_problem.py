"""MHPC cascaded-fidelity problem tests (testMHPCProblem.cpp analogue):
whole-body front horizon + embedded-SRB tail, impact resets, model-switch
projection."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cafempc.problems import mhpc_problem as mp
from cafempc.reference.quad_reference import (QuadReference,
                                              load_quad_reference,
                                              wb_state_ref_at)
from cafempc.solver.hsddp import make_solver
from cafempc.solver.options import load_solver_options
from cafempc.solver.plan import host_plan_to_device

REF = "/root/reference"


def build_problem(gait="bound"):
    ref = load_quad_reference(
        f"{REF}/Reference/Data/{gait}/quad_reference.csv")
    qr = QuadReference(ref)
    qr.initialize(0.75)
    cfg = mp.load_mhpc_config(f"{REF}/MHPC/settings/mhpc_config.info")
    cfg = mp.load_cost_weights(
        f"{REF}/MHPC/settings/cost_weights_regular.JSON", cfg)
    cfg = mp.load_constraint_params(
        f"{REF}/MHPC/settings/constraint_params_regular.info", cfg)
    plan_np, pen_np, Xbar0, Ubar0, meta = mp.build_mhpc_plan(qr, cfg)
    plan = host_plan_to_device(plan_np, dtype=jnp.float64)
    pen = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                       pen_np)
    x0 = jnp.asarray(wb_state_ref_at(qr, 0.0))
    return (cfg, plan, plan_np, pen, x0, jnp.asarray(Xbar0),
            jnp.asarray(Ubar0), meta)


def test_plan_structure():
    cfg, plan, plan_np, pen, x0, Xb, Ub, meta = build_problem()
    step = plan_np.step
    # cascade: exactly one model switch, WB steps before, SRB after
    sw = np.where(np.asarray(step.model_switch) > 0)[0]
    assert len(sw) == 1
    assert np.all(np.asarray(step.model_id)[:sw[0] + 1] == 0)
    act = np.asarray(step.active) > 0
    assert np.all(np.asarray(step.model_id)[sw[0] + 1:][act[sw[0] + 1:]]
                  == 1)
    # SRB segment uses dt_srb
    srb_steps = (np.asarray(step.model_id) == 1) & act
    assert np.allclose(np.asarray(step.dt)[srb_steps], cfg.dt_srb)
    # WB horizon: 25 dyn steps at dt_wb
    wb_dyn = (np.asarray(step.model_id) == 0) & act & \
        (np.asarray(step.is_reset) == 0)
    assert wb_dyn.sum() == int(round(cfg.plan_dur_wb / cfg.dt_wb))
    assert srb_steps.sum() == int(round(cfg.plan_dur_srb / cfg.dt_srb))


@pytest.fixture(scope="module")
def solved():
    cfg, plan, plan_np, pen, x0, Xb, Ub, meta = build_problem()
    opts = load_solver_options(f"{REF}/MHPC/settings/ddp_setting.info")
    opts = dataclasses.replace(opts, max_AL_iter=3, max_DDP_iter=4)
    solve = jax.jit(make_solver(mp.make_mhpc_fns(cfg), opts))
    s = solve(plan, pen, x0, Xb, Ub)
    return s, plan_np, meta


@pytest.mark.slow
def test_cascaded_solve_converges(solved):
    s, plan_np, meta = solved
    assert bool(s.success)
    assert float(s.feas) < 5e-3
    n = int(s.info.n_entries)
    feas = np.asarray(s.info.dyn_feas_buf[:n])
    assert feas[-1] < 1e-2 * feas[0]
    # touchdown constraint near threshold
    assert float(s.max_tconstr) < 5e-2


@pytest.mark.slow
def test_srb_segment_dead_dims_zero(solved):
    s, plan_np, meta = solved
    Xbar = np.asarray(s.traj.Xbar)
    model_id = np.asarray(plan_np.knot.model_id)
    active = np.asarray(plan_np.knot.active)
    srb_knots = (model_id == 1) & (active > 0)
    dead = np.r_[6:18, 24:36]
    assert np.abs(Xbar[srb_knots][:, dead]).max() < 1e-9


@pytest.mark.slow
def test_grf_z_nonnegative_in_stance(solved):
    s, plan_np, meta = solved
    Y = np.asarray(s.traj.Y)
    contact = np.asarray(plan_np.step.contact)
    wb_dyn = (np.asarray(plan_np.step.model_id) == 0) & \
        (np.asarray(plan_np.step.active) > 0) & \
        (np.asarray(plan_np.step.is_reset) == 0)
    for k in np.where(wb_dyn)[0]:
        for leg in range(4):
            if contact[k, leg] > 0:
                assert Y[k, 3 * leg + 2] > -1.0, (k, leg, Y[k])
