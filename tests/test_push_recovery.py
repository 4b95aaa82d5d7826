"""Closed-loop push recovery (VERDICT r3 item 6): run the MPC loop with
plant = own dynamics, inject a velocity impulse mid-run (the reference's
hard-push scenario, demo/hard_push.gif), and assert the controller
recovers height/attitude within a few replans."""
import dataclasses

import pytest as _pytest

pytestmark = _pytest.mark.slow

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cafempc.data import hkd_reference
from cafempc.models import hkd, wbm
from cafempc.problems import hkd_problem as hp
from cafempc.problems import mhpc_problem as mp
from cafempc.reference.quad_reference import (QuadReference,
                                              load_quad_reference,
                                              wb_state_ref_at)
from cafempc.runtime.mpc import HKDMPCRuntime
from cafempc.runtime.mhpc_runtime import MHPCRuntime
from cafempc.solver.options import SolverOptions, load_solver_options

REF_DATA = "/root/reference/Reference/Data"


def test_hkd_push_recovery():
    """HKD-MPC pace: vertical/roll-axis velocity impulse at replan 3;
    recovery = vertical velocity damped back out and height/attitude in
    band within 6 replans.

    Scope note: this plant applies the 20 ms command tape open loop
    (+ the published GRF feedback gains); the reference rejects LATERAL
    pushes through its 1 kHz value-based WBC between replans
    (hard_push.gif), which this tape-only plant cannot reproduce —
    pace's lateral axis is open-loop marginal here.  The lateral-push
    recovery case is covered closed-loop on the cascaded MHPC problem
    below (test_mhpc_push_recovery), where torques are the controls and
    the plant has full whole-body dynamics authority."""
    qr = QuadReference(hkd_reference("pace"))
    qr.initialize(0.6)
    cfg = hp.HKDConfig()
    opts = SolverOptions(max_DDP_iter=6, max_AL_iter=3,
                         max_DDP_iter_runtime=1, max_AL_iter_runtime=2)
    rt = HKDMPCRuntime(qr, cfg, opts)

    body = np.zeros(12)
    body[5] = 0.2486
    qJ = np.array([0, -0.8, 1.6] * 4, dtype=float)
    c0 = np.array(qr.contact_at_t(0.0), dtype=float)
    qd = hkd.compute_hkd_state(jnp.asarray(body[0:3]),
                               jnp.asarray(body[3:6]),
                               jnp.asarray(qJ), jnp.asarray(c0))
    x = np.concatenate([body, np.asarray(qd)])
    tape = rt.initialize(x)

    push_at, n_iters = 3, 12
    recovered_at = None
    for it in range(n_iters):
        for k in range(cfg.nsteps_between_mpc):
            # command tape + published GRF feedback gains (the
            # hkd_command_lcmt contract the downstream WBC applies)
            u = np.array(tape.controls[k])
            u[:12] += tape.feedback[k] @ (x[:12]
                                          - tape.des_body_state[k])
            x = np.array(hkd.dynamics(
                jnp.asarray(x), jnp.asarray(u),
                cfg.dt_sim, jnp.asarray(tape.contacts[k], dtype=float)))
        c_next = np.array(qr.contact_at_t(rt.dt_mpc), dtype=float)
        c_cur = tape.contacts[cfg.nsteps_between_mpc - 1]
        if (c_next != c_cur).any():
            x = np.array(hkd.reset_map(
                jnp.asarray(x), jnp.asarray(c_cur, dtype=float),
                jnp.asarray(c_next)))
        if it == push_at:
            # vertical + roll-axis velocity impulse
            x[11] += 0.35     # vz
            x[8] += 0.5       # roll rate
        tape = rt.update(x)
        assert bool(rt.state.success), f"solve failed at iter {it}"
        in_bounds = (0.15 < x[5] < 0.40 and abs(x[2]) < 0.3
                     and abs(x[11]) < 0.15 and abs(x[8]) < 0.4)
        if it > push_at and in_bounds and recovered_at is None:
            recovered_at = it
        # never catastrophically diverges
        assert x[5] > 0.05, f"fell at iter {it}: z={x[5]}"
    assert recovered_at is not None and recovered_at <= push_at + 6, \
        f"no recovery within 6 replans (recovered_at={recovered_at})"


def test_mhpc_push_recovery():
    """Cascaded MHPC bound: velocity impulse at replan 2, plant = own
    whole-body contact dynamics stepped through the commanded torque
    tape; recovery asserted on body height/roll."""
    ref = load_quad_reference(f"{REF_DATA}/bound/quad_reference.csv")
    qr = QuadReference(ref)
    qr.initialize(0.9)
    cfg = mp.load_mhpc_config(
        "/root/reference/MHPC/settings/mhpc_config.info")
    cfg = mp.load_cost_weights(
        "/root/reference/MHPC/settings/cost_weights_regular.JSON", cfg)
    cfg = mp.load_constraint_params(
        "/root/reference/MHPC/settings/constraint_params_regular.info",
        cfg)
    opts = load_solver_options(
        "/root/reference/MHPC/settings/ddp_setting.info")
    opts = dataclasses.replace(opts, max_AL_iter=4,
                               max_AL_iter_runtime=4,
                               max_DDP_iter_runtime=1)
    rt = MHPCRuntime(qr, cfg, opts, dtype=jnp.float64)
    model = rt.model

    x = np.array(wb_state_ref_at(qr, 0.0))
    cmd = rt.initialize(x)
    assert bool(rt.state.success)

    push_at, n_iters = 2, 8
    n_sim = int(round(cfg.dt_mpc / cfg.dt_wb))
    recovered_at = None
    for it in range(n_iters):
        # plant: WB contact dynamics under the commanded torques; apply
        # the impact map when the commanded contact set changes
        for k in range(n_sim):
            tau = np.asarray(cmd.torque[k])
            c = np.asarray(cmd.contacts[k], dtype=float)
            xn, _ = wbm.dynamics(model, jnp.asarray(x), jnp.asarray(tau),
                                 cfg.dt_wb, jnp.asarray(c), cfg.BG_alpha)
            x = np.array(xn)
            if k + 1 < n_sim:
                c2 = np.asarray(cmd.contacts[k + 1], dtype=float)
                if (c2 != c).any():
                    xi, _ = wbm.impact(model, jnp.asarray(x),
                                       jnp.asarray(c), jnp.asarray(c2))
                    x = np.array(xi)
        if it == push_at:
            x[18:21] += np.array([0.4, 0.4, 0.0])   # vWorld impulse
        cmd = rt.update(x)
        assert bool(rt.state.success), f"solve failed at iter {it}"
        assert x[2] > 0.08, f"fell at iter {it}: z={x[2]}"
        in_bounds = (0.15 < x[2] < 0.45 and abs(x[5]) < 0.5)
        if it > push_at and in_bounds and recovered_at is None:
            recovered_at = it
    assert recovered_at is not None and recovered_at <= push_at + 5, \
        f"no recovery within 5 replans (recovered_at={recovered_at})"
