#!/usr/bin/env python3
"""Closed-loop HKD-MPC demo: receding-horizon solves against a simulated
plant (the HKD model itself), with convergence/gait plots.

Usage: python examples/hkd_mpc_demo.py [--gait pace] [--steps 15]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from cafempc.data import GAITS, hkd_reference
from cafempc.models import hkd
from cafempc.problems import hkd_problem as hp
from cafempc.reference.quad_reference import QuadReference
from cafempc.runtime.mpc import HKDMPCRuntime
from cafempc.solver.options import SolverOptions
from cafempc.viz import plots


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gait", default="pace", choices=sorted(GAITS))
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--out", default="/tmp/hkd_mpc_demo")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    qr = QuadReference(hkd_reference(args.gait))
    qr.initialize(0.6)
    cfg = hp.HKDConfig()
    opts = SolverOptions(max_DDP_iter=6, max_AL_iter=3)
    rt = HKDMPCRuntime(qr, cfg, opts)

    body = np.zeros(12)
    body[5] = 0.2486
    qJ = np.array([0, -0.8, 1.6] * 4, dtype=float)
    c0 = np.asarray(qr.contact_at_t(0.0), dtype=float)
    qd = hkd.compute_hkd_state(jnp.asarray(body[0:3]),
                               jnp.asarray(body[3:6]),
                               jnp.asarray(qJ), jnp.asarray(c0))
    x = np.concatenate([body, np.asarray(qd)])

    tape = rt.initialize(x)
    print("initial solve:", tape.solve_info)
    history = [x.copy()]
    for it in range(args.steps):
        for k in range(cfg.nsteps_between_mpc):
            x = np.asarray(hkd.dynamics(
                jnp.asarray(x), jnp.asarray(tape.controls[k]), cfg.dt_sim,
                jnp.asarray(tape.contacts[k], dtype=float)))
        c_next = np.asarray(qr.contact_at_t(rt.dt_mpc), dtype=float)
        c_cur = tape.contacts[cfg.nsteps_between_mpc - 1]
        if (c_next != c_cur).any():
            x = np.asarray(hkd.reset_map(
                jnp.asarray(x), jnp.asarray(c_cur, dtype=float),
                jnp.asarray(c_next)))
        tape = rt.update(x)
        history.append(x.copy())
        print(f"mpc {it:3d}: z={x[5]:.3f} cost={tape.solve_info['cost'][-1]:.2f}"
              f" feas={tape.solve_info['dyn_feas']:.2e}")

    plots.plot_solve_convergence(rt.state.info,
                                 os.path.join(args.out, "convergence.png"))
    contacts = np.asarray(rt.plan_np.step.contact)[
        np.asarray(rt.plan_np.step.active) > 0]
    plots.plot_gait_schedule(contacts, cfg.dt_sim,
                             os.path.join(args.out, "gait.png"))
    print("plots written to", args.out)


if __name__ == "__main__":
    main()
