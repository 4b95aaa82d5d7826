"""Cascaded MHPC receding-horizon runtime test (MHPCLocomotion analogue):
initialize + one MPC update, command-tape message integrity; warm-start
alignment equivalence (vectorized vs reference scan)."""
import types

import pytest as _pytest

import dataclasses

import jax.numpy as jnp
import numpy as np

from cafempc.comms import lcm_wire as w
from cafempc.problems import mhpc_problem as mp
from cafempc.reference.quad_reference import (QuadReference,
                                              load_quad_reference,
                                              wb_state_ref_at)
from cafempc.runtime.mhpc_runtime import MHPCRuntime
from cafempc.solver.options import load_solver_options

REF = "/root/reference"


def _warm_start_scan(rt, plan_np, Xbar0, Ubar0):
    """Per-knot candidate scan, kept as the semantics oracle for the
    vectorized _warm_start: time + model match, preferring a source with
    the SAME is_terminal flag (keeps pre-/post-reset states on their own
    side of duplicated phase-boundary times), time-only fallback."""
    dt_mpc = rt.cfg.dt_mpc
    old_t = np.asarray(rt.plan_np.knot.t) + (rt.mpc_time - dt_mpc)
    old_active = np.asarray(rt.plan_np.knot.active) > 0
    old_model = np.asarray(rt.plan_np.knot.model_id)
    old_term = np.asarray(rt.plan_np.knot.is_terminal) > 0
    new_t = np.asarray(plan_np.knot.t) + rt.mpc_time
    new_active = np.asarray(plan_np.knot.active) > 0
    new_model = np.asarray(plan_np.knot.model_id)
    new_term = np.asarray(plan_np.knot.is_terminal) > 0
    oXb = np.asarray(rt.state.traj.Xbar)
    oUb = np.asarray(rt.state.traj.Ubar)
    Xb, Ub = Xbar0.copy(), Ubar0.copy()
    for j in np.where(new_active)[0]:
        base = (old_active
                & (np.abs(old_t - new_t[j]) < 1e-6)
                & (old_model == new_model[j]))
        cand = np.where(base & (old_term == new_term[j]))[0]
        if not len(cand):
            # fallback requires an equal contact tuple (window edges)
            oc = np.asarray(rt.plan_np.knot.contact) > 0.5
            nc = np.asarray(plan_np.knot.contact)[j] > 0.5
            cand = np.where(base & np.all(oc == nc, axis=1))[0]
        if len(cand):
            Xb[j] = oXb[cand[-1]]
            if j < len(Ub) and cand[-1] < len(oUb) and not new_term[j] \
                    and not old_term[cand[-1]]:
                Ub[j] = oUb[cand[-1]]
    return Xb, Ub


def test_warm_start_vectorized_matches_scan():
    """The searchsorted warm-start alignment produces the IDENTICAL
    (Xb, Ub) mapping as the former per-knot scan over several receding
    steps of the real cascaded plan (no solves involved)."""
    ref = load_quad_reference(
        f"{REF}/Reference/Data/bound/quad_reference.csv")
    qr = QuadReference(ref)
    qr.initialize(0.75)
    cfg = mp.load_mhpc_config(f"{REF}/MHPC/settings/mhpc_config.info")
    opts = load_solver_options(f"{REF}/MHPC/settings/ddp_setting.info")
    rt = MHPCRuntime(qr, cfg, opts)
    rng = np.random.default_rng(7)

    plan_np, _, Xbar0, Ubar0, _ = rt._build()
    rt.plan_np = plan_np
    for step in range(6):
        # fake a previous solution with distinguishable per-knot rows
        rt.state = types.SimpleNamespace(traj=types.SimpleNamespace(
            Xbar=rng.normal(size=(plan_np.knot.t.shape[0], 36)),
            Ubar=rng.normal(size=(plan_np.step.t.shape[0], 12))))
        rt.qr.step(cfg.dt_mpc)
        rt.mpc_time += cfg.dt_mpc
        plan2, _, Xb0, Ub0, _ = rt._build()
        Xb_v, Ub_v = rt._warm_start(plan2, Xb0, Ub0)
        Xb_s, Ub_s = _warm_start_scan(rt, plan2, Xb0, Ub0)
        np.testing.assert_array_equal(Xb_v, Xb_s)
        np.testing.assert_array_equal(Ub_v, Ub_s)
        # the mapping is non-trivial (some knots actually carried over)
        assert not np.array_equal(Xb_v, Xb0)
        rt.plan_np = plan2
        plan_np = plan2


@_pytest.mark.slow  # multi-update receding-horizon WB solves
def test_mhpc_runtime_init_and_update():
    ref = load_quad_reference(
        f"{REF}/Reference/Data/bound/quad_reference.csv")
    qr = QuadReference(ref)
    qr.initialize(0.75)
    cfg = mp.load_mhpc_config(f"{REF}/MHPC/settings/mhpc_config.info")
    cfg = mp.load_cost_weights(
        f"{REF}/MHPC/settings/cost_weights_regular.JSON", cfg)
    cfg = mp.load_constraint_params(
        f"{REF}/MHPC/settings/constraint_params_regular.info", cfg)
    opts = load_solver_options(f"{REF}/MHPC/settings/ddp_setting.info")
    opts = dataclasses.replace(opts, max_AL_iter=3, max_DDP_iter=4,
                               max_AL_iter_runtime=2,
                               max_DDP_iter_runtime=1)
    rt = MHPCRuntime(qr, cfg, opts)

    x0 = wb_state_ref_at(qr, 0.0)
    msg = rt.initialize(x0)
    assert bool(rt.state.success)
    assert msg.N_mpcsteps == 8
    # message encodes/decodes through the LCM wire format
    out = w.MHPC_Command_lcmt.decode(msg.encode())
    assert out.N_mpcsteps == 8
    assert np.isfinite(np.asarray(out.torque)).all()
    assert np.isfinite(np.asarray(out.feedback)).all()
    assert out.Quu.shape == (8, 144)

    # one receding-horizon update from the predicted state
    x1 = np.asarray(rt.state.traj.Xbar[2])   # state after dt_mpc (2 wb steps)
    msg2 = rt.update(x1)
    assert bool(rt.state.success)
    assert float(rt.state.feas) < 5.0
    assert np.isfinite(np.asarray(msg2.torque)).all()
