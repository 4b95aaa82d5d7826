"""Config 4 completion (VERDICT r3 item 5): cascaded MHPC solves driven
by the barrel-roll *reference CSVs* from Reference/Data — contact-scan
phase discovery through a mid-gait 2-pi roll flight phase, converged
solves, golden-pinned.

Mirrors the reference's testBarrelRollTO.cpp:15-171 flow (MHPCProblem
built over a BR reference, full-cap MultiPhaseDDP solve) but driven by
the reference data library:
  * inplace_br:  stance -> 460 ms roll flight (roll 0 -> 2pi) -> landing
  * running_br:  bounding gait with the roll flight embedded mid-gait
    (t in [1.80, 2.26], roll 1.65 -> 6.09 entering flight)
"""
import dataclasses

import pytest as _pytest

pytestmark = _pytest.mark.slow  # two full-cap WB solves over 60+ knots

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


def _solve_br_window(csv, t_start, plan_dur_wb, wb_block, n_steps_max,
                     max_al=8):
    """Build the cascaded plan over [t_start, t_start + plan_dur_wb]
    (+0.2 s SRB tail) of a BR reference and solve at full-ish caps."""
    d = load_quad_reference(csv)
    qr = QuadReference(d)
    qr.initialize(plan_dur_wb + 0.4)
    if t_start > 0:
        qr.step(t_start)
    cfg = mp.load_mhpc_config(f"{REF}/MHPC/settings/mhpc_config.info")
    cfg = mp.load_cost_weights(
        f"{REF}/MHPC/settings/cost_weights_regular.JSON", cfg)
    cfg = mp.load_constraint_params(
        f"{REF}/MHPC/settings/constraint_params_regular.info", cfg)
    cfg.plan_dur_wb = plan_dur_wb
    cfg.plan_dur_srb = 0.2
    cfg.wb_block = wb_block
    cfg.n_steps_max = n_steps_max
    plan_np, pen_np, Xbar0, Ubar0, meta = mp.build_mhpc_plan(qr, cfg)
    plan = host_plan_to_device(plan_np, dtype=jnp.float64)
    pen = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                       pen_np)
    x0 = jnp.asarray(wb_state_ref_at(qr, 0.0))
    opts = load_solver_options(f"{REF}/MHPC/settings/ddp_setting.info")
    opts = dataclasses.replace(opts, max_AL_iter=max_al)
    fns = mp.make_mhpc_fns_segmented(cfg)
    solve = jax.jit(make_solver(fns, opts, max_resets=10,
                                trim_output=True))
    s = solve(plan, pen, x0, jnp.asarray(Xbar0), jnp.asarray(Ubar0))
    return s, plan_np, meta, qr, cfg


def _check_roll_solution(s, plan_np, meta, min_flight_steps, roll_lo):
    # phase discovery found the roll flight phase (all feet in swing)
    phases = meta["wb_phases"]
    flight = [p for p in phases if p[3].sum() == 0 and
              p[2] >= min_flight_steps]
    assert flight, f"no roll flight phase discovered in {phases}"
    # touchdown AL constraints armed at the flight phase's terminal knot
    al_act = np.asarray(plan_np.knot.td_mask) \
        * np.asarray(plan_np.knot.is_terminal)[:, None]
    assert al_act.sum() >= 4, "no touchdown constraint at flight landing"
    assert bool(s.success)
    assert np.isfinite(float(s.cost))
    # dynamics feasibility at converged-TO levels
    assert float(s.feas) < 0.15, float(s.feas)
    # the solved trajectory actually rolls: max roll angle across the
    # window approaches the reference's (2pi through flight)
    Xbar = np.asarray(s.Xbar)
    active = np.asarray(plan_np.knot.active) > 0
    wb = np.asarray(plan_np.knot.model_id) == 0
    roll = Xbar[active & wb][:, 5]
    assert roll.max() > roll_lo, roll.max()
    print(f"[br] cost={float(s.cost):.3f} feas={float(s.feas):.4f} "
          f"roll_max={float(roll.max()):.3f}")
    return float(s.cost), float(s.feas), float(roll.max())


def test_inplace_br_reference_solve():
    """In-place barrel roll from Reference/Data/inplace_br: window
    [0.25, 0.85] covers stance -> roll flight (0.33-0.79) -> landing."""
    s, plan_np, meta, qr, cfg = _solve_br_window(
        f"{REF}/Reference/Data/inplace_br/quad_reference.csv",
        t_start=0.25, plan_dur_wb=0.60, wb_block=70, n_steps_max=75)
    cost, feas, roll_max = _check_roll_solution(
        s, plan_np, meta, min_flight_steps=30, roll_lo=4.5)
    # golden envelope (measured 25.13 / 0.064 / 6.304; PARITY.md s4)
    assert cost < 80.0, cost


def test_running_br_reference_solve():
    """Running barrel roll from Reference/Data/running_br: the roll
    flight sits mid-bounding at t in [1.80, 2.26]; window [1.70, 2.35]
    exercises phase discovery through bound-stance -> roll flight ->
    landing transitions."""
    s, plan_np, meta, qr, cfg = _solve_br_window(
        f"{REF}/Reference/Data/running_br/quad_reference.csv",
        t_start=1.70, plan_dur_wb=0.65, wb_block=78, n_steps_max=83)
    cost, feas, roll_max = _check_roll_solution(
        s, plan_np, meta, min_flight_steps=30, roll_lo=4.5)
    # golden envelope (measured 25.68 / 0.050 / 6.309; PARITY.md s4)
    assert cost < 80.0, cost
