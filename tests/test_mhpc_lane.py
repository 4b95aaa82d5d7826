"""Lane-form WB batch overrides (problems/mhpc_lane.py) must reproduce
the vmapped per-knot problem functions exactly — same math, lane-minor
layout — including under the scenario vmap (custom_vmap lane folding)
and the lane-chunked path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cafempc.problems import mhpc_problem as mp
from cafempc.reference.quad_reference import (QuadReference,
                                              load_quad_reference,
                                              wb_state_ref_at)
from cafempc.solver.hsddp import SegmentedFns, make_solver
from cafempc.solver.options import load_solver_options

REF = "/root/reference"

BATCH_FIELDS = ("dyn_batch", "dyn_partials_batch", "reset_batch",
                "reset_partial_batch", "run_cost_batch",
                "run_cost_partials_batch", "term_cost_batch",
                "term_cost_partials_batch", "term_con_batch",
                "term_con_partials_batch")


def strip_overrides(fns_seg: SegmentedFns) -> SegmentedFns:
    return SegmentedFns(
        counts=fns_seg.counts,
        fns=tuple(f._replace(**{k: None for k in BATCH_FIELDS})
                  for f in fns_seg.fns))


@pytest.fixture(scope="module")
def prob():
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
    opts = dataclasses.replace(opts, max_AL_iter=2, max_DDP_iter=1)
    return cfg, opts, plan, pen, x0, jnp.asarray(Xbar0), jnp.asarray(Ubar0)


def _wb_slice(cfg, plan, Xb, Ub, seed=0):
    """Perturbed states/controls on the WB step range."""
    n = cfg.wb_block
    rng = np.random.default_rng(seed)
    X = np.asarray(Xb)[:n] + rng.normal(0, 0.05, (n, 36))
    U = np.asarray(Ub)[:n] + rng.normal(0, 1.0, (n, 12))
    sd = jax.tree.map(lambda a: a[:n], plan.step)
    kd = jax.tree.map(lambda a: a[:n], plan.knot)
    return jnp.asarray(X), jnp.asarray(U), sd, kd


def test_piece_parity(prob):
    """Each *_batch override == vmap of its per-knot callable (same fns
    object carries both)."""
    cfg, opts, plan, pen, x0, Xb, Ub = prob
    fns = mp.make_mhpc_fns(cfg, mode="wb")
    assert fns.dyn_partials_batch is not None, \
        "lane overrides missing (CAFEMPC_WB_LANE disabled?)"
    X, U, sd, kd = _wb_slice(cfg, plan, Xb, Ub)
    Y = jnp.zeros((X.shape[0], 12), X.dtype)

    out_b = fns.dyn_partials_batch(X, U, sd)
    out_v = jax.vmap(fns.dyn_partials)(X, U, sd)
    for a, b in zip(out_b, out_v):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=1e-8)

    xn_b, y_b = fns.dyn_batch(X, U, sd)
    xn_v, y_v = jax.vmap(fns.dyn)(X, U, sd)
    np.testing.assert_allclose(np.asarray(xn_b), np.asarray(xn_v),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(y_b), np.asarray(y_v),
                               rtol=0, atol=1e-7)

    np.testing.assert_allclose(
        np.asarray(fns.reset_batch(X, sd)),
        np.asarray(jax.vmap(fns.reset)(X, sd)),
        rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(fns.reset_partial_batch(X, sd)),
        np.asarray(jax.vmap(fns.reset_partial)(X, sd)),
        rtol=0, atol=1e-8)

    np.testing.assert_allclose(
        np.asarray(fns.run_cost_batch(X, U, Y, sd)),
        np.asarray(jax.vmap(fns.run_cost)(X, U, Y, sd)),
        rtol=0, atol=1e-10)
    for a, b in zip(fns.run_cost_partials_batch(X, U, Y, sd),
                    jax.vmap(fns.run_cost_partials)(X, U, Y, sd)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=1e-9)

    np.testing.assert_allclose(
        np.asarray(fns.term_cost_batch(X, kd)),
        np.asarray(jax.vmap(fns.term_cost)(X, kd)),
        rtol=0, atol=1e-10)
    for a, b in zip(fns.term_cost_partials_batch(X, kd),
                    jax.vmap(fns.term_cost_partials)(X, kd)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=1e-9)

    np.testing.assert_allclose(
        np.asarray(fns.term_con_batch(X, kd)),
        np.asarray(jax.vmap(fns.term_con)(X, kd)),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(fns.term_con_partials_batch(X, kd)),
        np.asarray(jax.vmap(fns.term_con_partials)(X, kd)),
        rtol=0, atol=1e-12)


def test_scenario_vmap_folds_into_lanes(prob):
    """Under vmap the custom_vmap rule folds B into the lane axis; results
    must match the per-sample calls."""
    cfg, opts, plan, pen, x0, Xb, Ub = prob
    fns = mp.make_mhpc_fns(cfg, mode="wb")
    B = 3
    slices = [_wb_slice(cfg, plan, Xb, Ub, seed=s) for s in range(B)]
    Xs = jnp.stack([s[0] for s in slices])
    Us = jnp.stack([s[1] for s in slices])
    sd = slices[0][2]                                # shared plan

    out_v = jax.vmap(fns.dyn_partials_batch, in_axes=(0, 0, None))(
        Xs, Us, sd)
    for k in range(B):
        out_1 = fns.dyn_partials_batch(Xs[k], Us[k], sd)
        for a, b in zip(out_v, out_1):
            np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b),
                                       rtol=0, atol=1e-10)


def test_lane_chunk_parity(prob, monkeypatch):
    """CAFEMPC_LANE_CHUNK (lax.map over lane chunks) is exact; chunk=7
    deliberately does not divide the lane count."""
    cfg, opts, plan, pen, x0, Xb, Ub = prob
    X, U, sd, kd = _wb_slice(cfg, plan, Xb, Ub)
    fns_a = mp.make_mhpc_fns(cfg, mode="wb")
    monkeypatch.setenv("CAFEMPC_LANE_CHUNK", "7")
    fns_b = mp.make_mhpc_fns(cfg, mode="wb")
    for a, b in zip(fns_a.dyn_partials_batch(X, U, sd),
                    fns_b.dyn_partials_batch(X, U, sd)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=1e-12)


@pytest.mark.slow
def test_solve_parity_lane_vs_generic(prob):
    """Full cascaded solve: lane overrides vs the generic per-knot path."""
    cfg, opts, plan, pen, x0, Xb, Ub = prob
    fns_seg = mp.make_mhpc_fns_segmented(cfg)
    s_lane = jax.jit(make_solver(fns_seg, opts, max_resets=6))(
        plan, pen, x0, Xb, Ub)
    s_gen = jax.jit(make_solver(strip_overrides(fns_seg), opts,
                                max_resets=6))(plan, pen, x0, Xb, Ub)
    np.testing.assert_allclose(np.asarray(s_lane.traj.Xbar),
                               np.asarray(s_gen.traj.Xbar),
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.asarray(s_lane.traj.Ubar),
                               np.asarray(s_gen.traj.Ubar),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(float(s_lane.cost), float(s_gen.cost),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(s_lane.traj.K),
                               np.asarray(s_gen.traj.K),
                               rtol=1e-6, atol=1e-7)
    assert bool(s_lane.success)
