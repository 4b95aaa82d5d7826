"""Standalone locomotion trajectory optimization (Loco_TO).

Mirror of the reference's third TO entry point
(MHPC/MHPC-Trajopt/Locomotion/LocoProblem.cpp:7-89, Loco_TO.cpp:16-82):
a WB-only multi-phase problem over a long horizon (loco_config.info:
plan_dur_wb 1.0, plan_dur_srb 0) with the reduced constraint set —
torque + GRF ReB path constraints and TD AL terminal constraints, no
joint box / minimum height — solved once offline at full iteration caps
from a standing initial pose.
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp

from cafempc.problems import mhpc_problem as mp
from cafempc.reference.quad_reference import (QuadReference,
                                              load_quad_reference)
from cafempc.solver.hsddp import make_solver
from cafempc.solver.options import load_solver_options
from cafempc.solver.plan import host_plan_to_device

LOCO_DIR = "/root/reference/MHPC/MHPC-Trajopt/Locomotion/settings"
REF_ROOT = "/root/reference"

# Loco_TO.cpp:53-55 initial condition (standing crouch)
X0_QJ = np.array([0.0, -1.0, 2.0] * 4)
X0_POS_Z = 0.2183


def load_loco_config(settings_dir=LOCO_DIR, n_steps_max=128):
    """loco_config.info + loco_cost_weights.JSON +
    loco_constraint_params.info (LocoProblem::initialize_parameters)."""
    cfg = mp.load_mhpc_config(os.path.join(settings_dir, "loco_config.info"))
    cfg = mp.load_cost_weights(
        os.path.join(settings_dir, "loco_cost_weights.JSON"), cfg)
    cfg = mp.load_constraint_params(
        os.path.join(settings_dir, "loco_constraint_params.info"), cfg)
    cfg.pcon_set = "loco"
    cfg.n_steps_max = n_steps_max
    return cfg


def build_loco_problem(cfg=None, plan_dur=None, gait=None,
                       dtype=jnp.float64):
    """Build (fns, opts, plan, pen, x0, Xbar0, Ubar0, meta) for the Loco
    TO.  plan_dur/gait override the .info values (for fast tests)."""
    cfg = load_loco_config() if cfg is None else cfg
    if plan_dur is not None:
        cfg = dataclasses.replace(cfg, plan_dur_wb=plan_dur)
    gait = gait or cfg.reference_file or "flypace"
    ref = load_quad_reference(
        f"{REF_ROOT}/Reference/Data/{gait}/quad_reference.csv")
    qr = QuadReference(ref)
    qr.initialize(cfg.plan_dur_wb + 2 * cfg.dt_mpc)

    plan_np, pen_np, Xbar0, Ubar0, meta = mp.build_mhpc_plan(qr, cfg)
    plan = host_plan_to_device(plan_np, dtype=dtype)
    pen = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), dtype), pen_np)

    opts = load_solver_options(
        os.path.join(LOCO_DIR, "loco_ddp_setting.info"))

    x0 = np.zeros(36)
    x0[2] = X0_POS_Z
    x0[6:18] = X0_QJ
    # WB-only problem: every step uses the WB model — single-model fns
    fns = mp.make_mhpc_fns(cfg, mode="wb")
    return (fns, opts, plan, pen, jnp.asarray(x0, dtype),
            jnp.asarray(Xbar0, dtype), jnp.asarray(Ubar0, dtype), meta, qr)


def solve_loco_to(plan_dur=None, gait=None, dtype=jnp.float64,
                  max_AL_iter=None, max_DDP_iter=None, max_resets=16):
    """One-shot offline solve (Loco_TO.cpp:59-79).  Returns
    (state, plan_np-equivalent plan, meta, qr)."""
    (fns, opts, plan, pen, x0, Xb, Ub, meta, qr) = build_loco_problem(
        plan_dur=plan_dur, gait=gait, dtype=dtype)
    if max_AL_iter is not None:
        opts = dataclasses.replace(opts, max_AL_iter=max_AL_iter)
    if max_DDP_iter is not None:
        opts = dataclasses.replace(opts, max_DDP_iter=max_DDP_iter)
    solve = jax.jit(make_solver(fns, opts, max_resets=max_resets))
    s = solve(plan, pen, x0, Xb, Ub)
    return jax.block_until_ready(s), plan, meta, qr
