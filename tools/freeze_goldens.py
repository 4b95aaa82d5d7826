#!/usr/bin/env python3
"""Freeze f64 full-solve regression goldens (VERDICT r1 #3b).

The reference C++ solver cannot be built in this image (Eigen and Boost
headers are absent and there is no network egress — see docs/PARITY.md),
so solver-level parity is pinned by FROZEN f64 solutions of three
benchmark problems:

  * HKD bounding       (BASELINE config 1)
  * MHPC cascaded trot (BASELINE config 2)
  * barrel-roll TO     (BASELINE config 4, reduced iteration budget)

tests/test_regression_goldens.py asserts the current solver — default,
gather-reset and segmented paths, f64 and f32 — reproduces the frozen
Xbar/Ubar/K/cost traces within stated tolerances.  The HKD golden is a
solve on the in-repo bound gait (cafempc/data); the MHPC and barrel-roll
goldens still need the reference's whole-body inputs.

Run on CPU:  JAX_PLATFORMS=cpu python tools/freeze_goldens.py [hkd|mhpc|br]
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import dataclasses
import os

import jax
# goldens are float64 CPU solves
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from cafempc.utils.platform import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

FIX = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "fixtures")


def _save(name, s, extra=None):
    n = int(s.info.n_entries)
    out = dict(
        Xbar=np.asarray(s.traj.Xbar), Ubar=np.asarray(s.traj.Ubar),
        K=np.asarray(s.traj.K), cost=np.asarray(s.cost),
        feas=np.asarray(s.feas),
        cost_trace=np.asarray(s.info.cost_buf[:n]),
        feas_trace=np.asarray(s.info.dyn_feas_buf[:n]),
        iters=np.asarray(int(s.info.iters)),
        max_tconstr=np.asarray(s.max_tconstr),
        max_pconstr=np.asarray(s.max_pconstr))
    if extra:
        out.update(extra)
    path = os.path.join(FIX, f"golden_{name}.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path}: cost={out['cost']:.6f} feas={out['feas']:.2e} "
          f"iters={int(out['iters'])}")


def hkd_bound():
    from tests.test_hkd_solver import OPTS, build
    from cafempc.problems import hkd_problem as hp
    from cafempc.solver.hsddp import make_solver
    plan, pen, x0, Xb, Ub, meta = build()
    s = jax.jit(make_solver(hp.make_hkd_fns(), OPTS))(plan, pen, x0, Xb, Ub)
    _save("hkd_bound", jax.block_until_ready(s))


def mhpc_trot():
    from cafempc.problems import mhpc_problem as mp
    from cafempc.reference.quad_reference import (
        QuadReference, load_quad_reference, wb_state_ref_at)
    from cafempc.solver.hsddp import make_solver
    from cafempc.solver.options import load_solver_options
    from cafempc.solver.plan import host_plan_to_device
    REF = "/root/reference"
    ref = load_quad_reference(f"{REF}/Reference/Data/trot/dynfeas/quad_reference.csv")
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
    opts = load_solver_options(f"{REF}/MHPC/settings/ddp_setting.info")
    opts = dataclasses.replace(opts, max_AL_iter=3, max_DDP_iter=4)
    s = jax.jit(make_solver(mp.make_mhpc_fns(cfg), opts))(
        plan, pen, x0, jnp.asarray(Xbar0), jnp.asarray(Ubar0))
    _save("mhpc_trot", jax.block_until_ready(s))


def barrel_roll():
    from cafempc.problems import barrel_roll as br
    from cafempc.solver.hsddp import make_solver
    from cafempc.solver.options import load_solver_options
    from cafempc.solver.plan import host_plan_to_device
    SETTINGS = "/root/reference/MHPC/MHPC-Trajopt/BarrelRoll/setting"
    plan_np, pen_np, Xbar0, Ubar0, meta = br.build_barrel_roll_plan(
        SETTINGS)
    plan = host_plan_to_device(plan_np, dtype=jnp.float64)
    pen = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                       pen_np)
    opts = load_solver_options(f"{SETTINGS}/br_ddp_setting.info")
    opts = dataclasses.replace(opts, max_AL_iter=6, max_DDP_iter=8)
    s = jax.jit(make_solver(br.make_barrel_roll_fns(), opts))(
        plan, pen, jnp.asarray(br.initial_state()), jnp.asarray(Xbar0),
        jnp.asarray(Ubar0))
    _save("barrel_roll", jax.block_until_ready(s))


if __name__ == "__main__":
    which = _sys.argv[1] if len(_sys.argv) > 1 else "all"
    if which in ("all", "hkd"):
        hkd_bound()
    if which in ("all", "mhpc"):
        mhpc_trot()
    if which in ("all", "br"):
        barrel_roll()
