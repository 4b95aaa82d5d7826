"""Two-segment LQ fan-out (SegmentedFns) + gather-based reset evaluation:
the segmented cascade solver must reproduce the joint (where-select) solver
exactly — same math, restricted evaluation ranges."""
import dataclasses

import pytest as _pytest

pytestmark = _pytest.mark.slow  # compiles 4 WB solver variants

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

REF = "/root/reference"


@pytest.fixture(scope="module")
def small_problem():
    ref = load_quad_reference(
        f"{REF}/Reference/Data/bound/quad_reference.csv")
    qr = QuadReference(ref)
    qr.initialize(0.4)
    cfg = mp.MHPCConfig(plan_dur_wb=0.1, plan_dur_srb=0.2,
                        n_steps_max=24, wb_block=16)
    plan_np, pen_np, Xbar0, Ubar0, meta = mp.build_mhpc_plan(qr, cfg)
    from cafempc.solver.plan import host_plan_to_device
    plan = host_plan_to_device(plan_np, dtype=jnp.float64)
    pen = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                       pen_np)
    x0 = jnp.asarray(wb_state_ref_at(qr, 0.0))
    opts = load_solver_options(f"{REF}/MHPC/settings/ddp_setting.info")
    opts = dataclasses.replace(opts, max_AL_iter=2, max_DDP_iter=2)
    return cfg, opts, plan, pen, x0, jnp.asarray(Xbar0), jnp.asarray(Ubar0)


@pytest.mark.xslow
def test_segmented_matches_joint(small_problem):
    cfg, opts, plan, pen, x0, Xb, Ub = small_problem
    model = mp.wbm.load_model()
    s_joint = jax.jit(make_solver(mp.make_mhpc_fns(cfg, model), opts))(
        plan, pen, x0, Xb, Ub)
    fns_seg = mp.make_mhpc_fns_segmented(cfg, model)
    s_seg = jax.jit(make_solver(fns_seg, opts, max_resets=6))(
        plan, pen, x0, Xb, Ub)
    np.testing.assert_allclose(np.asarray(s_seg.traj.Xbar),
                               np.asarray(s_joint.traj.Xbar),
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.asarray(s_seg.traj.Ubar),
                               np.asarray(s_joint.traj.Ubar),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(float(s_seg.cost), float(s_joint.cost),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(s_seg.traj.K),
                               np.asarray(s_joint.traj.K),
                               rtol=1e-6, atol=1e-7)
    assert bool(s_seg.success)


@pytest.mark.xslow
def test_lq_knot_chunk_matches_unchunked(small_problem):
    """lq_knot_chunk (sequential chunk-wise LQ evaluation, the
    long-horizon HBM enabler) must be bit-identical math to the whole-
    horizon vmap; chunk=5 deliberately does not divide either segment so
    the padding path is exercised."""
    cfg, opts, plan, pen, x0, Xb, Ub = small_problem
    model = mp.wbm.load_model()
    fns_seg = mp.make_mhpc_fns_segmented(cfg, model)
    s_a = jax.jit(make_solver(fns_seg, opts, max_resets=6))(
        plan, pen, x0, Xb, Ub)
    s_b = jax.jit(make_solver(fns_seg, opts, max_resets=6,
                              lq_knot_chunk=5))(plan, pen, x0, Xb, Ub)
    np.testing.assert_allclose(np.asarray(s_b.traj.Xbar),
                               np.asarray(s_a.traj.Xbar),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(s_b.traj.K),
                               np.asarray(s_a.traj.K),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(float(s_b.cost), float(s_a.cost),
                               rtol=1e-10)
    assert bool(s_b.success)


@pytest.mark.xslow
def test_gather_reset_matches_masked(small_problem):
    """max_resets gather path == mask-everywhere path on the joint fns."""
    cfg, opts, plan, pen, x0, Xb, Ub = small_problem
    model = mp.wbm.load_model()
    fns = mp.make_mhpc_fns(cfg, model)
    s_a = jax.jit(make_solver(fns, opts))(plan, pen, x0, Xb, Ub)
    s_b = jax.jit(make_solver(fns, opts, max_resets=6))(
        plan, pen, x0, Xb, Ub)
    np.testing.assert_allclose(np.asarray(s_b.traj.Xbar),
                               np.asarray(s_a.traj.Xbar),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(float(s_b.cost), float(s_a.cost), rtol=1e-10)
