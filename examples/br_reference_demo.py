#!/usr/bin/env python3
"""Barrel-roll solves driven by the reference CSV library (config 4):
build the cascaded MHPC problem over a window of
Reference/Data/{inplace_br,running_br}/quad_reference.csv spanning the
2-pi roll flight phase, solve to convergence, publish the whole-body
trajectory on the reference's `visualize_wb_traj` channel and render a
roll/height/contact summary plot.

The reference's testBarrelRollTO.cpp:15-171 flow, reference-data-driven.
Usage:  python examples/br_reference_demo.py [--ref running_br]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from cafempc.utils.platform import enable_compile_cache  # noqa: E402

enable_compile_cache()

import dataclasses
import time

import jax.numpy as jnp
import numpy as np

from cafempc.problems import mhpc_problem as mp
from cafempc.reference.quad_reference import (QuadReference,
                                              load_quad_reference,
                                              wb_state_ref_at)
from cafempc.solver.hsddp import make_solver
from cafempc.solver.options import load_solver_options
from cafempc.solver.plan import host_plan_to_device

REF = "/root/reference"
WINDOWS = {
    # name: (t_start, plan_dur_wb, wb_block, n_steps_max)
    "inplace_br": (0.25, 0.60, 70, 75),
    "running_br": (1.70, 0.65, 78, 83),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", choices=sorted(WINDOWS), default="inplace_br")
    ap.add_argument("--max-al", type=int, default=8)
    ap.add_argument("--out", default="/tmp/br_reference_demo")
    ap.add_argument("--publish", action="store_true",
                    help="publish wbTraj_lcmt on visualize_wb_traj")
    args = ap.parse_args()

    t_start, dur_wb, wb_block, n_max = WINDOWS[args.ref]
    qr = QuadReference(load_quad_reference(
        f"{REF}/Reference/Data/{args.ref}/quad_reference.csv"))
    qr.initialize(dur_wb + 0.4)
    if t_start > 0:
        qr.step(t_start)
    cfg = mp.load_mhpc_config(f"{REF}/MHPC/settings/mhpc_config.info")
    cfg = mp.load_cost_weights(
        f"{REF}/MHPC/settings/cost_weights_regular.JSON", cfg)
    cfg = mp.load_constraint_params(
        f"{REF}/MHPC/settings/constraint_params_regular.info", cfg)
    cfg.plan_dur_wb, cfg.plan_dur_srb = dur_wb, 0.2
    cfg.wb_block, cfg.n_steps_max = wb_block, n_max
    plan_np, pen_np, Xbar0, Ubar0, meta = mp.build_mhpc_plan(qr, cfg)
    print("phases:", [(round(a, 2), round(b, 2), h, c.tolist())
                      for a, b, h, c in meta["wb_phases"]])
    plan = host_plan_to_device(plan_np, dtype=jnp.float64)
    pen = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                       pen_np)
    opts = load_solver_options(f"{REF}/MHPC/settings/ddp_setting.info")
    opts = dataclasses.replace(opts, max_AL_iter=args.max_al)
    solve = jax.jit(make_solver(mp.make_mhpc_fns_segmented(cfg), opts,
                                max_resets=10, trim_output=True))
    x0 = jnp.asarray(wb_state_ref_at(qr, 0.0))
    t0 = time.time()
    s = solve(plan, pen, x0, jnp.asarray(Xbar0), jnp.asarray(Ubar0))
    jax.block_until_ready(s)
    Xbar = np.asarray(s.Xbar)
    active = np.asarray(plan_np.knot.active) > 0
    wb = np.asarray(plan_np.knot.model_id) == 0
    roll = Xbar[active & wb][:, 5]
    print(f"solved in {time.time() - t0:.1f} s: cost {float(s.cost):.2f} "
          f"feas {float(s.feas):.4f} roll max {roll.max():.3f} rad "
          f"success {bool(s.success)}")

    if args.publish:
        from cafempc.comms.udpm import LCMEndpoint
        from cafempc.viz.plots import publish_wb_traj
        ep = LCMEndpoint()
        publish_wb_traj(ep, Xbar[wb], np.asarray(plan_np.knot.active)[wb],
                        cfg.dt_wb,
                        contacts=np.asarray(plan_np.knot.contact)[wb])
        print("published visualize_wb_traj")

    os.makedirs(args.out, exist_ok=True)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    t = np.asarray(plan_np.knot.t)[active & wb]
    fig, ax = plt.subplots(3, 1, figsize=(8, 8), sharex=True)
    X_ref = np.asarray(plan_np.knot.x_ref)[active & wb]
    ax[0].plot(t, roll, label="solved roll")
    ax[0].plot(t, X_ref[:, 5], "--", label="reference roll")
    ax[0].set_ylabel("roll [rad]")
    ax[0].legend()
    ax[1].plot(t, Xbar[active & wb][:, 2], label="solved z")
    ax[1].plot(t, X_ref[:, 2], "--", label="reference z")
    ax[1].set_ylabel("height [m]")
    ax[1].legend()
    c = np.asarray(plan_np.knot.contact)[active & wb]
    for leg in range(4):
        ax[2].step(t, c[:, leg] * 0.8 + leg, where="post")
    ax[2].set_ylabel("contact per leg")
    ax[2].set_xlabel("t [s] (window-relative)")
    fig.suptitle(f"{args.ref}: barrel roll through the reference window")
    fig.tight_layout()
    path = os.path.join(args.out, f"{args.ref}.png")
    fig.savefig(path, dpi=110)
    print("wrote", path)


if __name__ == "__main__":
    main()
