#!/usr/bin/env python3
"""Print solver iteration telemetry for one bench-config batched solve:
how many regularization retries / line-search trials actually run.

Run from the repository root: python tools/probe_iters.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import numpy as np

jax.config.update("jax_default_matmul_precision", "highest")

import bench as B
from cafempc.utils.platform import enable_compile_cache

enable_compile_cache()
solve_b, plan, pen_b, x0_b, Xb_b, Ub_b = B.build_bench_setup()
s = solve_b(plan, pen_b, x0_b, Xb_b, Ub_b)
jax.block_until_ready(s)
it = np.asarray(s.info.iters)
reg = np.asarray(s.info.reg_iters)
ls = np.asarray(s.info.ls_iters)
print("device:", jax.devices()[0].platform, jax.devices()[0].device_kind)
print("iters      min/med/max:", it.min(), int(np.median(it)), it.max())
print("reg_iters  min/med/max:", reg.min(), int(np.median(reg)), reg.max())
print("ls_iters   min/med/max:", ls.min(), int(np.median(ls)), ls.max())
print("success all:", bool(np.all(s.success)))
