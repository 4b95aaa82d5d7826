#!/usr/bin/env python3
"""Smoke test of the batched HKD-MPC solver on the GPU.

Usage, from the repository root:

  python chip_smoke.py           # one card, phases 1-5
  python chip_smoke.py --four    # four cards: the sharded solves only

Phases on one card, all in this one process:
  1. device: platform, kind, count, card name and power limit; no GPU fails;
  2. kernel: the Triton Riccati-sweep kernel compiled at its real widths
     (xs=24/us=24/N=112 and xs=36/us=12/N=48, 526; B=256) against the
     float64 recursion;
  3. main path: bench.build_bench_setup("hkd") at B=256 in float32, three
     solves, then 8 scenarios against the un-batched float64 solve;
  4. single robot: runtime/mpc.HKDMPCRuntime, initialize + 5 replans;
  5. the GPU-marked tests (pytest -m gpu), through pytest.main.

--four runs the scenario-sharded solve over scenario_mesh(4) and the
knot-sharded solve over scenario_knot_mesh(1, 4), each against the one-card
vmap solve on the same inputs.

A failing phase raises: the process exits non-zero.  The last line is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_default_matmul_precision", "highest")

import bench
from cafempc.data import hkd_reference
from cafempc.models import hkd
from cafempc.ops.riccati_sweep import _recursion, kernel_sweep
from cafempc.parallel.mesh import (replicate, scenario_knot_mesh,
                                   scenario_mesh, shard_batch)
from cafempc.problems import hkd_problem as hp
from cafempc.reference.quad_reference import QuadReference
from cafempc.runtime.mpc import HKDMPCRuntime
from cafempc.solver.hsddp import make_solver
from cafempc.solver.options import SolverOptions
from cafempc.utils.platform import (card_info, device_fields,
                                    enable_compile_cache, require_gpu)

# Kernel vs float64 recursion on well-conditioned synthetic data: max abs
# error over max abs value, per output.  float32 rounding through a
# 526-step recursion stays near 1e-5.
KERNEL_RTOL = 1e-4
KERNEL_SHAPES = ((256, 112, 24, 24), (256, 48, 36, 12), (256, 526, 36, 12))

# float32 batched solve vs un-batched float64 solve, per scenario: states
# (rad, m, rad/s, m/s) absolute over active knots, controls (N) absolute,
# cost relative.  On the CPU, with the float32 recursion in place of the
# kernel, the worst of 8 scenarios is 1.6e-3 (the body roll rate around
# touchdown, where the inertia is smallest), 4e-3 N and 2e-7; the bounds
# leave room for the GPU's other summation orders.
X_ATOL = 1e-2
U_ATOL = 5e-2
COST_RTOL = 1e-4
# --four compares two float32 solves over all 256 scenarios, (states,
# controls N, cost relative).  Scenario sharding: each card runs XLA's
# batched kernels at B=64 instead of 256, which may sum in another order;
# on four H100s the worst scenario differed by 1.2e-2, 3.1e-2 N and 1.2e-5.
SHARD_BOUNDS = (5e-2, 0.2, 1e-4)
# The knot-sharded sweep composes linear-fractional-transform elements
# across the four blocks of the horizon; in float32 that composition loses
# far more than the sequential recursion (in float64 both agree to 1e-8,
# tests/test_knot_riccati.py).  On four virtual CPU devices at B=64 its
# solve differed from the one-device solve by up to 0.29 in the states,
# 1.23 N in the controls and 1.5e-3 in the cost.
KNOT_BOUNDS = (0.5, 2.5, 5e-3)


def log(msg):
    print(msg, flush=True)


def _max_rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


# ------------------------------------------------------------- phase 1 --

def phase_device():
    devs = require_gpu()
    log(f"[device] platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    name, limit = card_info()
    log(f"{name}, {limit}")


# ------------------------------------------------------------- phase 2 --

def synthetic_sweep(rng, B, N, xs, us, dtype=np.float32):
    """Well-conditioned sweep operands: A ~ I + dt J (the discretized
    dynamics), SPD cost Hessians, small defects, a transform step every
    ~20 knots, reg 1e-3 per scenario."""
    def mk(shape, s):
        return rng.normal(size=shape) * s

    def spd(n, lead, s, d):
        M = rng.normal(size=lead + (n, n)) * s
        return np.einsum("...ij,...kj->...ik", M, M) + d * np.eye(n)

    A = np.eye(xs) + mk((B, N, xs, xs), 0.03)
    ops = [A, mk((B, N, xs, us), 0.1), mk((B, N, xs), 0.2),
           mk((B, N, us), 0.2), spd(xs, (B, N), 0.15, 0.8),
           spd(us, (B, N), 0.15, 0.8), mk((B, N, us, xs), 0.02),
           mk((B, xs), 0.2), spd(xs, (B,), 0.15, 0.8),
           mk((B, N + 1, xs), 0.005)]
    w = np.zeros(N, np.int32)
    w[np.arange(N // 20 + 1) * 20 % N] = 1
    reg = np.full(B, 1e-3)
    return [jnp.asarray(o, dtype) for o in ops], jnp.asarray(w), \
        jnp.asarray(reg, dtype)


def phase_kernel(shapes=KERNEL_SHAPES, interpret=False):
    rng = np.random.default_rng(0)
    names = ("G", "H", "K", "dU")
    for (B, N, xs, us) in shapes:
        ops, w, reg = synthetic_sweep(rng, B, N, xs, us)
        t0 = time.perf_counter()
        compiled = jax.jit(
            lambda *a: kernel_sweep(*a, interpret=interpret)).lower(
                *ops, w, reg).compile()
        log(f"[kernel] B={B} N={N} xs={xs} us={us} compiled in "
            f"{time.perf_counter() - t0:.1f} s; "
            f"{compiled.memory_analysis()}")
        out = jax.block_until_ready(compiled(*ops, w, reg))
        with jax.enable_x64(True):
            ref = jax.jit(jax.vmap(
                _recursion, in_axes=(0,) * 10 + (None, 0)))(
                *[o.astype(jnp.float64) for o in ops], w,
                reg.astype(jnp.float64))
            ref = jax.device_get(ref)
        errs = {n: _max_rel(o, r) for n, o, r in zip(names, out, ref)}
        ok_k, ok_r = np.asarray(out[7]) > 0.5, np.asarray(ref[7]) > 0.5
        log(f"[kernel]   max rel err vs float64 {errs}; "
            f"ok flags {int(ok_k.sum())}/{B} (reference {int(ok_r.sum())})")
        if not np.array_equal(ok_k, ok_r):
            raise AssertionError("kernel PSD flags differ from the "
                                 "float64 recursion")
        bad = {n: e for n, e in errs.items() if not e <= KERNEL_RTOL}
        if bad:
            raise AssertionError(f"kernel error above {KERNEL_RTOL}: {bad}")


# ------------------------------------------------------------- phase 3 --

def reference_solves(x0s):
    """The plain path: un-batched float64 make_solver (sequential sweep,
    no kernel), same plan, caps and solver settings as the bench."""
    with jax.enable_x64(True):
        fns, opts, plan, pen, _, Xbar0, Ubar0 = bench.build_hkd(jnp.float64)
        solve = jax.jit(make_solver(
            fns, opts, trim_output=True, parallel_line_search=False,
            max_resets=16, reg_floor=opts.reg_min_init))
        out = [jax.device_get(solve(plan, pen, jnp.asarray(x, jnp.float64),
                                    jnp.asarray(Xbar0, jnp.float64),
                                    jnp.asarray(Ubar0, jnp.float64)))
               for x in x0s]
        active = np.asarray(plan.knot.active) > 0
    return out, active


def compare_solves(tag, s, refs, idx, active):
    """Per scenario: success flags equal, then X/U/cost within bounds."""
    worst = dict(X=0.0, U=0.0, cost=0.0)
    for i, r in zip(idx, refs):
        ok, ok_r = bool(np.asarray(s.success)[i]), bool(r.success)
        if ok != ok_r:
            raise AssertionError(f"{tag}: scenario {i} success {ok} vs "
                                 f"reference {ok_r}")
        dX = np.abs(np.asarray(s.Xbar[i], np.float64) - r.Xbar)[active]
        dU = np.abs(np.asarray(s.Ubar[i], np.float64) - r.Ubar)
        c, c_r = float(np.asarray(s.cost)[i]), float(r.cost)
        worst["X"] = max(worst["X"], float(dX.max()))
        worst["U"] = max(worst["U"], float(dU.max()))
        worst["cost"] = max(worst["cost"], abs(c - c_r) / abs(c_r))
    log(f"[{tag}] worst over {len(idx)} scenarios: |dX| {worst['X']:.3e} "
        f"(bound {X_ATOL}), |dU| {worst['U']:.3e} (bound {U_ATOL}), "
        f"cost rel {worst['cost']:.3e} (bound {COST_RTOL})")
    if not (worst["X"] <= X_ATOL and worst["U"] <= U_ATOL
            and worst["cost"] <= COST_RTOL):
        raise AssertionError(f"{tag}: outside the stated bounds")


def check_batch(tag, s):
    ok = np.asarray(s.success)
    cost = np.asarray(s.cost)
    if not ok.all():
        raise AssertionError(f"{tag}: success=False on "
                             f"{int((~ok).sum())}/{ok.size} scenarios")
    if not np.isfinite(cost).all():
        raise AssertionError(f"{tag}: non-finite cost")


def phase_main(B=256, n_solves=3, n_ref=8):
    solve_b, plan, pen_b, x0_b, Xb_b, Ub_b = bench.build_bench_setup(B=B)
    t0 = time.perf_counter()
    s = jax.block_until_ready(solve_b(plan, pen_b, x0_b, Xb_b, Ub_b))
    log(f"[main] B={B} warm-up (compile + solve) "
        f"{time.perf_counter() - t0:.1f} s")
    check_batch("main warm-up", s)
    for i in range(n_solves):
        t0 = time.perf_counter()
        s = jax.block_until_ready(solve_b(plan, pen_b, x0_b, Xb_b, Ub_b))
        check_batch(f"main solve {i}", s)
        log(f"[main] solve {i}: {time.perf_counter() - t0:.4f} s, cost "
            f"mean {float(np.mean(np.asarray(s.cost))):.3f}")
    idx = np.linspace(0, B - 1, n_ref).astype(int)
    refs, active = reference_solves(np.asarray(x0_b)[idx])
    compare_solves("main vs float64", s, refs, idx, active)


# ------------------------------------------------------------- phase 4 --

def phase_runtime(n_replans=5, dtype=jnp.float32):
    qr = QuadReference(hkd_reference("bound"))
    qr.initialize(0.6)
    cfg = hp.HKDConfig()
    opts = SolverOptions(max_DDP_iter=6, max_AL_iter=3,
                         max_DDP_iter_runtime=1, max_AL_iter_runtime=2)
    rt = HKDMPCRuntime(qr, cfg, opts, dtype=dtype)
    body = np.zeros(12)
    body[5] = 0.2486
    c0 = np.asarray(qr.contact_at_t(0.0), float)
    qd = hkd.compute_hkd_state(jnp.asarray(body[0:3], dtype),
                               jnp.asarray(body[3:6], dtype),
                               jnp.asarray([0.0, -0.8, 1.6] * 4, dtype),
                               jnp.asarray(c0, dtype))
    x = np.concatenate([body, np.asarray(qd)])
    tape = rt.initialize(x)
    log(f"[runtime] initialize (compile + solve) {rt.last_solve_ms:.1f} ms")
    for it in range(n_replans):
        # plant: the model itself under the commanded controls
        for k in range(cfg.nsteps_between_mpc):
            x = np.asarray(hkd.dynamics(
                jnp.asarray(x, dtype), jnp.asarray(tape.controls[k], dtype),
                cfg.dt_sim, jnp.asarray(tape.contacts[k], dtype)))
        c_next = np.asarray(qr.contact_at_t(rt.dt_mpc), float)
        c_cur = tape.contacts[cfg.nsteps_between_mpc - 1]
        if (c_next != c_cur).any():
            x = np.asarray(hkd.reset_map(jnp.asarray(x, dtype),
                                         jnp.asarray(c_cur, dtype),
                                         jnp.asarray(c_next, dtype)))
        tape = rt.update(x)
        if not bool(rt.state.success):
            raise AssertionError(f"runtime replan {it} failed")
        if not np.isfinite(tape.controls).all():
            raise AssertionError(f"runtime replan {it}: non-finite tape")
        log(f"[runtime] replan {it}: {rt.last_solve_ms:.2f} ms wall "
            f"(ends in block_until_ready; replan 0 compiles), "
            f"z={x[5]:.3f}")


# ------------------------------------------------------------- phase 5 --

def phase_gpu_tests():
    import pytest
    root = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(root, "tests", "test_riccati_sweep.py")])
    if rc != 0:
        raise AssertionError(f"pytest -m gpu exited {rc}")


# ---------------------------------------------------------------- four --

def phase_four(B=256):
    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four needs 4 devices, found {len(devs)}")
    solve_v, plan, pen_b, x0_b, Xb_b, Ub_b = bench.build_bench_setup(B=B)
    ref = jax.block_until_ready(solve_v(plan, pen_b, x0_b, Xb_b, Ub_b))
    check_batch("one-card vmap", ref)
    failed = []
    for tag, mesh, (x_tol, u_tol, c_tol) in (
            ("scenario_mesh(4)", scenario_mesh(4), SHARD_BOUNDS),
            ("scenario_knot_mesh(1, 4)", scenario_knot_mesh(1, 4),
             KNOT_BOUNDS)):
        solve_m = bench.build_bench_setup(B=B, mesh=mesh)[0]
        t0 = time.perf_counter()
        s = jax.block_until_ready(solve_m(
            replicate(plan, mesh),
            *shard_batch((pen_b, x0_b, Xb_b, Ub_b), mesh)))
        log(f"[four] {tag}: compile + solve {time.perf_counter() - t0:.1f} s")
        check_batch(tag, s)
        if not np.array_equal(np.asarray(s.success), np.asarray(ref.success)):
            raise AssertionError(f"{tag}: success flags differ from vmap")
        dX = float(np.abs(np.asarray(s.Xbar) - np.asarray(ref.Xbar)).max())
        dU = float(np.abs(np.asarray(s.Ubar) - np.asarray(ref.Ubar)).max())
        dc = float(np.max(np.abs(np.asarray(s.cost) - np.asarray(ref.cost))
                          / np.abs(np.asarray(ref.cost))))
        log(f"[four] {tag} vs one-card vmap: |dX| {dX:.3e} (bound {x_tol})"
            f", |dU| {dU:.3e} (bound {u_tol}), cost rel {dc:.3e} "
            f"(bound {c_tol})")
        if not (dX <= x_tol and dU <= u_tol and dc <= c_tol):
            failed.append(tag)
    if failed:
        raise AssertionError(f"outside the stated bounds: {failed}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card sharded phases only")
    args = ap.parse_args()
    t_start = time.perf_counter()
    phase_device()
    enable_compile_cache()
    phases = ([phase_four] if args.four else
              [phase_kernel, phase_main, phase_runtime, phase_gpu_tests])
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        log(f"[{phase.__name__}] passed in {time.perf_counter() - t0:.1f} s")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": device_fields()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
