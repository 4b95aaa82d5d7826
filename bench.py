#!/usr/bin/env python3
"""Benchmark: batched HS-DDP MPC re-solves per second on one GPU.

Config 1 of BASELINE.json (`hkd`): HKD-MPC mini-cheetah bound, 1.0 s
kinodynamic horizon (112 plan steps), runtime iteration caps (1 DDP x 2 AL,
HKDMPC.cpp:102-103), batched over B=256 scenarios (perturbed initial
states) and solved entirely on the device through
parallel/mesh.make_batched_solver.  Every input comes from the repository
(cafempc/data).

The whole-body configurations (`mhpc`, `cascade500`) need a 36-state robot
description that the repository does not contain yet; they stop at once.

Prints one JSON line per run:
  {"metric": "hsddp_solves_per_s", "value": N, "unit": "solves/s",
   "vs_baseline": N/5000, "device": {...}, "card": {...}, ...}
Without a GPU it exits non-zero and prints no result.
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_default_matmul_precision", "highest")

from cafempc.data import hkd_reference
from cafempc.models import hkd
from cafempc.parallel.mesh import make_batched_solver
from cafempc.problems import hkd_problem as hp
from cafempc.reference.quad_reference import QuadReference
from cafempc.solver.options import SolverOptions
from cafempc.solver.plan import host_plan_to_device
from cafempc.utils.platform import (card_info, device_fields,
                                    enable_compile_cache, require_gpu)

# BASELINE.json's stated >= 5000 solves/s target for config 1
BASELINE_SOLVES_PER_S = 5000.0
WB_MISSING = ("needs the 36-state whole-body robot description (URDF) of "
              "the mini cheetah, which this repository does not contain "
              "yet (ROADMAP.md, Reach #1)")


def hkd_x0(meta, dtype):
    """Standing HKD state at the plan start: level body at 0.2486 m, legs
    at the default posture, stance legs' qdummy from FK."""
    body = np.zeros(12)
    body[5] = 0.2486
    qJ = np.array([0, -0.8, 1.6] * 4, dtype=float)
    qdummy = hkd.compute_hkd_state(
        jnp.asarray(body[0:3], dtype), jnp.asarray(body[3:6], dtype),
        jnp.asarray(qJ, dtype), jnp.asarray(meta["phases"][0][3], dtype))
    return np.concatenate([body, np.asarray(qdummy)])


def build_hkd(dtype, plan_dur=1.0, n_steps_max=112):
    """Config 1 (headline): HKD-MPC bound, ~100-knot horizon.  Returns
    (fns, opts, plan, pen, x0, Xbar0, Ubar0)."""
    qr = QuadReference(hkd_reference("bound"))
    qr.initialize(plan_dur)
    cfg = hp.HKDConfig(plan_duration=plan_dur, n_steps_max=n_steps_max)
    plan_np, pen_np, Xbar0, Ubar0, meta = hp.build_hkd_plan(qr, cfg)
    plan = host_plan_to_device(plan_np, dtype=dtype)
    pen = hp.pen_to_device(pen_np, dtype=dtype)
    opts = SolverOptions(max_AL_iter=2, max_DDP_iter=1)
    return (hp.make_hkd_fns(), opts, plan, pen, hkd_x0(meta, dtype), Xbar0,
            Ubar0)


def _check_config(config):
    if config in ("mhpc", "cascade500"):
        raise SystemExit(f"BENCH_CONFIG={config} {WB_MISSING}")
    if config != "hkd":
        raise SystemExit(f"BENCH_CONFIG must be hkd, mhpc or cascade500, "
                         f"got {config!r}")


def build_bench_setup(B=None, dtype=jnp.float32, config=None, mesh=None,
                      **solver_kwargs):
    """Bench-config solver + batched inputs; shared by bench.main,
    chip_smoke.py and the profiling tools so they all run the SAME
    program.  Scenario i starts from x0 plus N(0, 0.01) noise (seed 0).
    solver_kwargs go to make_batched_solver (e.g. parallel_riccati)."""
    _check_config(config or os.environ.get("BENCH_CONFIG", "hkd"))
    B = B or int(os.environ.get("BENCH_BATCH", "256"))
    fns, opts, plan, pen, x0, Xbar0, Ubar0 = build_hkd(dtype)

    rng = np.random.default_rng(0)
    x0_b = jnp.asarray(x0[None] + rng.normal(0, 0.01, (B, x0.shape[-1])),
                       dtype)
    pen_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), pen)
    Xb_b = jnp.broadcast_to(jnp.asarray(Xbar0, dtype), (B,) + Xbar0.shape)
    Ub_b = jnp.broadcast_to(jnp.asarray(Ubar0, dtype), (B,) + Ubar0.shape)
    # sequential line search; gather-site resets (the cap covers every
    # reset step of the plan); reg floor = reg_min_init, which lands on
    # the reg the reference's reg=0-then-retry schedule reaches in f32
    solve_b = make_batched_solver(fns, opts, mesh=mesh, trim_output=True,
                                  parallel_line_search=False, max_resets=16,
                                  reg_floor=opts.reg_min_init,
                                  **solver_kwargs)
    return solve_b, plan, pen_b, x0_b, Xb_b, Ub_b


class BenchInvalid(RuntimeError):
    """A measurement failed self-validation; nothing was printed."""


def _check(config, what, cost, ok):
    cost, ok = np.asarray(cost), np.asarray(ok)
    if not ok.all():
        raise BenchInvalid(f"{config}: {what} success=False on "
                           f"{int((~ok).sum())}/{ok.size} scenarios")
    if not np.isfinite(cost).all():
        raise BenchInvalid(f"{config}: {what} cost not finite")


def run_one(config, iters, windows):
    """Measure one config; returns the validated JSON line (also printed).

    Each window dispatches `iters` solves back to back and stops the clock
    once every solve's (cost, success) has reached the host, so the
    interval contains the device execution of all of them."""
    t_setup = time.perf_counter()
    solve_b, plan, pen_b, x0_b, Xb_b, Ub_b = build_bench_setup(config=config)
    B = x0_b.shape[0]
    t_built = time.perf_counter()
    s = solve_b(plan, pen_b, x0_b, Xb_b, Ub_b)
    _check(config, "warmup solve", s.cost, s.success)
    t_warm = time.perf_counter()

    window_rates = []
    t_bench0 = time.perf_counter()
    for wi in range(windows):
        handles = []
        t0 = time.perf_counter()
        for _ in range(iters):
            s = solve_b(plan, pen_b, x0_b, Xb_b, Ub_b)
            handles.append((s.cost, s.success))
        cost_all = np.asarray(jnp.stack([c for c, _ in handles]))
        ok_all = np.asarray(jnp.stack([ok for _, ok in handles]))
        dt = (time.perf_counter() - t0) / iters
        _check(config, f"window {wi}", cost_all, ok_all)
        window_rates.append(B / dt)
    name, limit = card_info()
    solves_per_s = max(window_rates)
    line = json.dumps({
        "metric": "hsddp_solves_per_s",
        "value": round(solves_per_s, 2),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / BASELINE_SOLVES_PER_S, 4),
        "config": config,
        "elapsed_s": round(time.perf_counter() - t_bench0, 3),
        "iters": iters,
        "windows": [round(r, 1) for r in window_rates],
        "batch": B,
        "build_s": round(t_built - t_setup, 1),
        "warmup_s": round(t_warm - t_built, 1),
        "device": device_fields(),
        "card": {"name": name, "power_limit": limit},
        "ok": True,
    })
    print(line, flush=True)
    return line


def main():
    """One JSON line for BENCH_CONFIG (default hkd); the value is the best
    of BENCH_WINDOWS windows, every window's rate is in the line."""
    config = os.environ.get("BENCH_CONFIG", "hkd")
    _check_config(config)
    require_gpu()
    enable_compile_cache()
    run_one(config, int(os.environ.get("BENCH_ITERS", "5")),
            int(os.environ.get("BENCH_WINDOWS", "3")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
