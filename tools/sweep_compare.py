#!/usr/bin/env python3
"""Which backward sweep the batched `hkd` solve should run on the GPU.

Times the bench's `hkd` configuration (B=256, float32) end to end with
three sweeps, built in one process and measured in alternating turns after
warm-up:

  kernel     ops/riccati_sweep: one Triton program per scenario (default);
  xla_seq    the same recursion as XLA's vmapped reverse lax.scan;
  xla_assoc  hsddp.backward_sweep_parallel, XLA's associative scan;

plus `kernel_seqroll` (the kernel sweep with the sequential linear rollout
in place of the associative-scan one) for the rollout stage.  For each it
records solves/s per turn and, from a profiler trace of two solves, the
device time of each solver stage (the jax.named_scope names "lq", "sweep",
"linear_rollout", "line_search"), the device busy time and the kernel
launches.  It also times the sweep kernel alone against the vmapped XLA
recursion at xs=24/us=24/N=112 and at the whole-body widths xs=36/us=12,
N=48 and 526, on synthetic data.

Run on the card from the repository root:
  python tools/sweep_compare.py [--out build/sweep_compare]
Writes summary.json (and the traces) under --out; prints one line per
measurement.
"""
import argparse
import glob
import gzip
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_default_matmul_precision", "highest")

import bench
import chip_smoke
from cafempc.ops import riccati_sweep
from cafempc.solver import hsddp
from cafempc.utils.platform import (card_info, enable_compile_cache,
                                    require_gpu)

STAGES = ("lq", "sweep", "linear_rollout", "line_search")


def build_variants(B):
    """(name -> (solve_b, args)).  xla_seq swaps the custom_vmap sweep op
    for its plain recursion while tracing, so vmap batches the scan."""
    out = {}
    specs = {"kernel": {}, "xla_assoc": {"parallel_riccati": True},
             "kernel_seqroll": {"parallel_linear_rollout": False},
             "xla_seq": {}}
    for name, kw in specs.items():
        solve_b, *args = bench.build_bench_setup(B=B, **kw)
        if name == "xla_seq":
            def plain(*a, _solve=solve_b):
                op = hsddp.sweep_op
                hsddp.sweep_op = riccati_sweep._recursion
                try:
                    return _solve.lower(*a).compile()
                finally:
                    hsddp.sweep_op = op
            compiled = plain(*args)
        else:
            compiled = solve_b.lower(*args).compile()
        out[name] = (compiled, args)
    return out


def _kernel_key(name):
    """XLA names a fusion's GPU kernel after the HLO instruction, with
    '.' and '-' turned into '_'."""
    return re.sub(r"[.\-]", "_", name.lstrip("%"))


def hlo_scopes(hlo_text):
    """Kernel name -> solver stage, from the op_name metadata of the
    compiled module (the named scopes are path components)."""
    scope_of = {}
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if not m:
            continue
        parts = m.group(2).split("/")
        for st in STAGES:
            if st in parts:
                scope_of[_kernel_key(m.group(1))] = st
                break
    return scope_of


def trace_stages(compiled, args, out_dir, n=2):
    """Device time per stage over `n` solves from a profiler trace."""
    jax.block_until_ready(compiled(*args))
    os.makedirs(out_dir, exist_ok=True)
    jax.profiler.start_trace(out_dir)
    t0 = time.perf_counter()
    for _ in range(n):
        r = compiled(*args)
    jax.block_until_ready(r)
    wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(out_dir, "plugins", "profile",
                                         "*", "*.xplane.pb")))[-1]
    hlo_text = compiled.as_text()
    with gzip.open(os.path.join(out_dir, "hlo.txt.gz"), "wt") as fh:
        fh.write(hlo_text)
    scope_of = hlo_scopes(hlo_text)
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(path)
    per_line = {}
    for plane in pd.planes:
        if "/device:GPU" not in plane.name:
            continue
        for line in plane.lines:
            acc = dict.fromkeys(STAGES + ("other",), 0)
            unmatched = {}
            ivals = []
            n_ev = 0
            sample = []
            for ev in line.events:
                stats = {k: str(v)[:200] for k, v in ev.stats}
                if len(sample) < 12:
                    sample.append([ev.name, stats])
                # kernels run inside command buffers (CUDA graphs), so the
                # kernel name, not the hlo_op stat, identifies the op
                st = scope_of.get(_kernel_key(ev.name))
                if st is None and "riccati_sweep" in ev.name:
                    st = "sweep"
                if st is None:
                    st = "other"
                    key = re.sub(r"_\d+$", "", ev.name)[:60]
                    unmatched[key] = unmatched.get(key, 0) + ev.duration_ns
                acc[st] += ev.duration_ns
                ivals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                n_ev += 1
            if not n_ev:
                continue
            ivals.sort()
            busy, cur_s, cur_e = 0, *ivals[0]
            for s, e in ivals[1:]:
                if s > cur_e:
                    busy += cur_e - cur_s
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            busy += cur_e - cur_s
            per_line[f"{plane.name}|{line.name}"] = {
                "events": n_ev, "busy_ms": busy / 1e6 / n,
                "span_ms": (ivals[-1][1] - ivals[0][0]) / 1e6 / n,
                "stage_ms": {k: v / 1e6 / n for k, v in acc.items()},
                "other_top_ms": dict(sorted(
                    ((k, v / 1e6 / n) for k, v in unmatched.items()),
                    key=lambda kv: -kv[1])[:12]),
                "sample_events": sample}
    return {"wall_ms_per_solve": wall * 1e3 / n, "lines": per_line,
            "trace": path}


def time_turns(variants, rounds, iters, B):
    rates = {k: [] for k in variants}
    names = list(variants)
    for r in range(rounds):
        order = names if r % 2 == 0 else names[::-1]
        for name in order:
            compiled, args = variants[name]
            t0 = time.perf_counter()
            outs = [compiled(*args) for _ in range(iters)]
            ok = np.asarray(jnp.stack([o.success for o in outs]))
            dt = (time.perf_counter() - t0) / iters
            if not ok.all():
                raise AssertionError(f"{name}: success=False")
            rates[name].append(B / dt)
            print(f"[turn {r}] {name}: {B / dt:.1f} solves/s", flush=True)
    return rates


def kernel_alone(shapes, reps=20):
    rng = np.random.default_rng(0)
    res = {}
    for (B, N, xs, us) in shapes:
        ops, w, reg = chip_smoke.synthetic_sweep(rng, B, N, xs, us)
        kern = jax.jit(riccati_sweep.kernel_sweep)
        xla = jax.jit(jax.vmap(riccati_sweep._recursion,
                               in_axes=(0,) * 10 + (None, 0)))
        row = {}
        for name, f in (("kernel", kern), ("xla_seq", xla)):
            jax.block_until_ready(f(*ops, w, reg))
            t0 = time.perf_counter()
            for _ in range(reps):
                o = f(*ops, w, reg)
            jax.block_until_ready(o)
            row[name + "_ms"] = (time.perf_counter() - t0) * 1e3 / reps
        key = f"B{B}_N{N}_xs{xs}_us{us}"
        res[key] = row
        print(f"[alone] {key}: {row}", flush=True)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/sweep_compare")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    require_gpu()
    enable_compile_cache()
    name, limit = card_info()
    print(f"{name}, {limit}", flush=True)
    summary = {"card": {"name": name, "power_limit": limit}}
    t0 = time.perf_counter()
    variants = build_variants(args.batch)
    summary["build_compile_s"] = time.perf_counter() - t0
    summary["rates"] = time_turns(variants, args.rounds, args.iters,
                                  args.batch)
    summary["stages"] = {}
    for vname, (compiled, vargs) in variants.items():
        st = trace_stages(compiled, vargs, os.path.join(args.out, vname))
        summary["stages"][vname] = st
        for lname, d in st["lines"].items():
            print(f"[trace] {vname} {lname}: {d['events']} events, busy "
                  f"{d['busy_ms']:.3f} of {d['span_ms']:.3f} ms/solve, "
                  f"stages {d['stage_ms']}", flush=True)
        print(f"[trace] {vname}: {st['wall_ms_per_solve']:.2f} ms/solve "
              f"wall", flush=True)
    summary["kernel_alone"] = kernel_alone(
        ((256, 112, 24, 24), (256, 48, 36, 12), (256, 526, 36, 12)))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    med = {k: float(np.median(v)) for k, v in summary["rates"].items() if v}
    print(json.dumps({"median_solves_per_s": med,
                      "card": summary["card"]}), flush=True)


if __name__ == "__main__":
    main()
