#!/usr/bin/env python3
"""Barrel-roll trajectory optimization demo (full reference budget):
solves the 6-phase acrobatic whole-body TO and renders a stick-figure
side view + convergence plots."""
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

from cafempc.problems import barrel_roll as br
from cafempc.solver.hsddp import make_solver
from cafempc.solver.options import load_solver_options
from cafempc.solver.plan import host_plan_to_device
from cafempc.viz import plots

SETTINGS = "/root/reference/MHPC/MHPC-Trajopt/BarrelRoll/setting"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/barrel_roll_demo")
    ap.add_argument("--max-al", type=int, default=30)
    ap.add_argument("--max-ddp", type=int, default=10)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    plan_np, pen_np, Xbar0, Ubar0, meta = br.build_barrel_roll_plan(
        SETTINGS)
    plan = host_plan_to_device(plan_np, dtype=jnp.float64)
    pen = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                       pen_np)
    opts = load_solver_options(f"{SETTINGS}/br_ddp_setting.info")
    opts = dataclasses.replace(opts, max_AL_iter=args.max_al,
                               max_DDP_iter=args.max_ddp)
    solve = jax.jit(make_solver(br.make_barrel_roll_fns(), opts,
                                info_len=512))
    x0 = jnp.asarray(br.initial_state())
    t0 = time.time()
    s = solve(plan, pen, x0, jnp.asarray(Xbar0), jnp.asarray(Ubar0))
    jax.block_until_ready(s)
    print(f"solved in {time.time() - t0:.1f}s, iters={int(s.info.iters)}, "
          f"feas={float(s.feas):.3e}, tconstr={float(s.max_tconstr):.3e}")

    plots.plot_solve_convergence(s.info,
                                 os.path.join(args.out, "convergence.png"))
    plots.plot_body_trajectory(s.traj.Xbar, plan_np.knot.active,
                               os.path.join(args.out, "body.png"))
    plots.plot_wb_stickfigure(None, s.traj.Xbar, plan_np.knot.active,
                              os.path.join(args.out, "stickfigure.png"))
    print("plots written to", args.out)


if __name__ == "__main__":
    main()
