"""Full-solve regression goldens (PARITY hardening, VERDICT r1 #3).

The reference C++ solver cannot be built in this image (no Eigen/Boost,
no egress — docs/PARITY.md), so solver-level behavior is pinned by frozen
f64 solutions (tools/freeze_goldens.py).  These tests assert the current
solver reproduces them:

  * f64 default path: near-exact (guards against semantic regressions);
  * f32 path (the bench precision) with gather-reset: within float
    tolerance on states/controls and cost.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cafempc.problems import hkd_problem as hp
from cafempc.solver.hsddp import make_solver
from cafempc.solver.options import load_solver_options
from cafempc.solver.plan import host_plan_to_device

from tests.test_hkd_solver import OPTS, build


def _golden(fixtures_dir, name):
    p = os.path.join(fixtures_dir, f"golden_{name}.npz")
    if not os.path.exists(p):
        pytest.skip(f"golden {name} not frozen (tools/freeze_goldens.py)")
    return np.load(p)


def test_hkd_bound_f64_matches_golden(fixtures_dir):
    g = _golden(fixtures_dir, "hkd_bound")
    plan, pen, x0, Xb, Ub, meta = build()
    s = jax.jit(make_solver(hp.make_hkd_fns(), OPTS))(plan, pen, x0, Xb, Ub)
    np.testing.assert_allclose(np.asarray(s.traj.Xbar), g["Xbar"],
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(np.asarray(s.traj.Ubar), g["Ubar"],
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(float(s.cost), float(g["cost"]), rtol=1e-10)
    assert int(s.info.iters) == int(g["iters"])


def test_hkd_bound_f32_within_tolerance(fixtures_dir, tmp_path):
    """The bench configuration (f32 end to end, x64 OFF, gather-reset)
    against the f64 golden: states to 5e-3, cost to 0.2%.  Runs in a
    subprocess so that x64 is off from the start, as in the bench."""
    import subprocess
    import sys
    g = _golden(fixtures_dir, "hkd_bound")
    script = tmp_path / "run_f32.py"
    out = tmp_path / "f32_out.npz"
    script.write_text(f"""
import os, sys
sys.path.insert(0, {repr(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))})
import jax
jax.config.update("jax_platforms", "cpu")
from cafempc.utils.platform import enable_compile_cache
enable_compile_cache()
import jax.numpy as jnp
import numpy as np
from tests.test_hkd_solver import OPTS, build
from cafempc.problems import hkd_problem as hp
from cafempc.solver.hsddp import make_solver
plan, pen, x0, Xb, Ub, meta = build()
s = jax.jit(make_solver(hp.make_hkd_fns(), OPTS, max_resets=16))(
    plan, pen, x0, Xb, Ub)
np.savez({repr(str(out))}, Xbar=np.asarray(s.traj.Xbar),
         cost=np.asarray(s.cost),
         active=np.asarray(plan.knot.active))
""")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_ENABLE_X64", None)
    subprocess.run([sys.executable, str(script)], check=True, env=env,
                   timeout=1500)
    r = np.load(out)
    act = r["active"] > 0
    dx = np.abs(r["Xbar"] - g["Xbar"])[act]
    assert dx.max() < 5e-3, dx.max()
    assert abs(float(r["cost"]) - float(g["cost"])) / float(g["cost"]) \
        < 2e-3


def test_mhpc_trot_f64_matches_golden(fixtures_dir):
    g = _golden(fixtures_dir, "mhpc_trot")
    from cafempc.problems import mhpc_problem as mp
    from cafempc.reference.quad_reference import (
        QuadReference, load_quad_reference, wb_state_ref_at)
    REF = "/root/reference"
    ref = load_quad_reference(
        f"{REF}/Reference/Data/trot/dynfeas/quad_reference.csv")
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
    # segmented + gather-reset (the optimized production path) must also
    # land on the frozen joint-fns golden
    fns = mp.make_mhpc_fns_segmented(cfg)
    s = jax.jit(make_solver(fns, opts, max_resets=8))(
        plan, pen, x0, jnp.asarray(Xbar0), jnp.asarray(Ubar0))
    np.testing.assert_allclose(np.asarray(s.traj.Xbar), g["Xbar"],
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(float(s.cost), float(g["cost"]), rtol=1e-8)


test_mhpc_trot_f64_matches_golden = pytest.mark.slow(
    test_mhpc_trot_f64_matches_golden)


@pytest.mark.slow
def test_barrel_roll_f64_matches_golden(fixtures_dir):
    g = _golden(fixtures_dir, "barrel_roll")
    from cafempc.problems import barrel_roll as br
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
    np.testing.assert_allclose(np.asarray(s.traj.Xbar), g["Xbar"],
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(float(s.cost), float(g["cost"]), rtol=1e-9)
