#!/usr/bin/env python3
"""Single-robot replan latency on the GPU against the reference's 18 ms
budget (0.9 * dt_mpc, MHPCLocomotion.cpp:122).

Measures ONE un-batched HKD-MPC solve at the runtime iteration caps
(0.6 s horizon, 2 AL x 1 DDP: the replan program of runtime/mpc.py) over
n re-solves:
  * wall time per solve, ending in block_until_ready;
  * device busy time per solve from a profiler trace.
Prints one JSON line with p50/p99 and the card.  Usage, from the
repository root:
  python tools/latency_probe.py [--n 100] [--trace-n 10]
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_default_matmul_precision", "highest")

import bench
from cafempc.solver.hsddp import make_solver
from cafempc.utils.platform import (card_info, device_fields,
                                    enable_compile_cache, require_gpu)
from sweep_compare import trace_stages


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--trace-n", type=int, default=10)
    args = ap.parse_args()
    require_gpu()
    enable_compile_cache()
    dtype = jnp.float32
    fns, opts, plan, pen, x0, Xb, Ub = bench.build_hkd(dtype, 0.6, 72)
    solve = jax.jit(make_solver(fns, opts, trim_output=True,
                                max_resets=16))
    sargs = (plan, pen, jnp.asarray(x0, dtype), jnp.asarray(Xb, dtype),
             jnp.asarray(Ub, dtype))
    compiled = solve.lower(*sargs).compile()
    jax.block_until_ready(compiled(*sargs))

    walls = []
    for _ in range(args.n):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*sargs))
        walls.append((time.perf_counter() - t0) * 1e3)
    with tempfile.TemporaryDirectory() as tdir:
        tr = trace_stages(compiled, sargs, tdir, n=args.trace_n)
    busy = max((d["busy_ms"] for d in tr["lines"].values()), default=None)
    name, limit = card_info()
    walls = np.asarray(walls)
    print(json.dumps({
        "metric": "hkd_replan_latency_ms",
        "n": args.n,
        "wall_p50": float(np.percentile(walls, 50)),
        "wall_p99": float(np.percentile(walls, 99)),
        "device_busy_ms_per_solve": busy,
        "budget_ms": 18.0,
        "device": device_fields(),
        "card": {"name": name, "power_limit": limit},
    }))


if __name__ == "__main__":
    main()
