"""Hybrid-Systems DDP solver.

Functional re-design of the reference solver stack (MultiPhaseDDP +
SinglePhase + Trajectory, HSDDPSolver/source/*.cpp) over flat knot plans:

  * LQ approximation: `vmap(jacfwd)` over all knots at once — the
    reference's OpenMP-parallel linearization loop (SinglePhase.cpp:265-320)
    becomes one batched device computation.
  * Hybrid rollout: with multiple shooting and every knot a shooting state
    (the reference's standard configuration, SinglePhase.h:163-172), the
    forward sweep has NO sequential dependence — X = Xbar + eps*dX and each
    one-step simulation is independent, so the rollout is a pure `vmap`
    (reference: sequential loop, SinglePhase.cpp:182-233).  A `lax.scan`
    path covers single shooting / partial shooting sets.
  * Backward Riccati sweep with impact-aware value propagation
    (G <- Px^T G, H <- Px^T H Px at phase boundaries,
    MultiPhaseDDP.cpp:499-503) with a unified step rule (dynamics step |
    reset/padding transform): a reverse `lax.scan` per scenario, one GPU
    kernel per scenario batch (ops/riccati_sweep.py).
  * Merit line search and AL/ReB outer loops as `lax.while_loop`s
    (MultiPhaseDDP.cpp:95-133, 216-447).

The entire solve is one jit-compiled function of device arrays; batching
over scenarios is an outer `vmap`, sharding over device meshes an outer
`shard_map`.  The reference's wall-clock checkpoints are replaced by the
iteration caps (see SolverOptions).
"""
import functools
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from cafempc.ops.riccati_sweep import sweep_op
from cafempc.solver import penalty
from cafempc.solver.options import SolverOptions
from cafempc.solver.plan import KnotPlan, PenaltyParams


class ProblemFns(NamedTuple):
    """Model/problem-specific pure functions consumed by the solver.

    Per-step callables receive (x, u[, y], step_data_slice); per-knot
    callables receive (x, knot_data_slice).  All are vmapped by the solver.
    The functional analogue of the reference's dynamics callbacks +
    CostContainer + ConstraintContainer (SinglePhase.h:58-100).
    """
    dyn: Callable                 # (x, u, sd) -> (xnext, y)
    dyn_partials: Callable        # (x, u, sd) -> (A, B, C, D)
    reset: Callable               # (x, sd) -> xnext
    reset_partial: Callable       # (x, sd) -> Px
    run_cost: Callable            # (x, u, y, sd) -> l  (dt-scaled)
    run_cost_partials: Callable   # -> (lx, lu, ly, lxx, luu, lux, lyy)
    term_cost: Callable           # (x, kd) -> phi
    term_cost_partials: Callable  # (x, kd) -> (phix, phixx)
    path_con: Callable            # (x, u, y, sd) -> g  [n_pcon]
    path_con_partials: Callable   # (x, u, y, sd) -> (gx, gu, gy)
    term_con: Callable            # (x, kd) -> h  [n_tcon]
    term_con_partials: Callable   # (x, kd) -> hx [n_tcon, xs]
    # Optional KNOT-BATCHED overrides (leading axis = knots): when set,
    # the solver calls them on the whole (segment) slice instead of
    # vmapping the per-knot callable — the hook for lane-form
    # implementations that control their own batching/layout (e.g.
    # problems/mhpc_lane.make_wb_lane_batch_fns, which folds the
    # scenario batch into a lane-minor axis via custom_vmap).  Each must
    # be semantically identical to vmap(per-knot fn).
    dyn_batch: Any = None                 # (X, U, sd) -> (Xn, Y)
    dyn_partials_batch: Any = None        # (X, U, sd) -> (A, B, C, D)
    reset_batch: Any = None               # (X, sd) -> Xn
    reset_partial_batch: Any = None       # (X, sd) -> P [n, xs, xs]
    run_cost_batch: Any = None            # (X, U, Y, sd) -> l [n]
    run_cost_partials_batch: Any = None
    term_cost_batch: Any = None           # (X, kd) -> phi [n]
    term_cost_partials_batch: Any = None
    term_con_batch: Any = None            # (X, kd) -> h [n, n_tcon]
    term_con_partials_batch: Any = None


class SegmentedFns(NamedTuple):
    """Static per-segment problem functions for cascaded plans.

    Segment i owns steps [sum(counts[:i]), sum(counts[:i+1])) of the flat
    plan (and the matching knots; the last segment also owns the final
    knot).  The solver vmaps each segment's callables over its own slice
    only, so one model's (expensive) dynamics/partials are never evaluated
    on the other's knots — the two-segment analogue of the reference's
    per-phase LQ approximation touching only its own model
    (SinglePhase.cpp:265-320).  Requires the plan to place each model's
    steps at static offsets (mhpc_problem.build_mhpc_plan's carry-pad
    layout).
    """
    counts: tuple   # static ints, sum == n_steps
    fns: tuple      # ProblemFns per segment


class TrajState(NamedTuple):
    """Working trajectory data (reference TrajectoryManagement.h:22-85)."""
    Xbar: Any; Ubar: Any; Defect_bar: Any
    X: Any; U: Any; Y: Any; Xsim: Any; Defect: Any
    dX: Any; dU: Any; K: Any
    A: Any; B: Any; C: Any; D: Any
    lx: Any; lu: Any; ly: Any; lxx: Any; luu: Any; lux: Any; lyy: Any
    phix: Any; phixx: Any
    G: Any; H: Any
    Qu: Any; Quu: Any; Qux: Any


class SolverInfo(NamedTuple):
    """Iteration telemetry (reference solver-info buffers,
    MultiPhaseDDP.h:133-136)."""
    cost_buf: Any
    dyn_feas_buf: Any
    eqn_feas_buf: Any
    ineq_feas_buf: Any
    n_entries: Any
    iters: Any
    ls_iters: Any
    reg_iters: Any


class SolverState(NamedTuple):
    traj: TrajState
    pen: PenaltyParams
    x0: Any
    cost: Any; merit: Any; merit_rho: Any; feas: Any
    dV1: Any; dV2: Any
    reg: Any
    max_pconstr: Any; max_tconstr: Any
    max_pconstr_prev: Any; max_tconstr_prev: Any
    # cached penalty-independent cost terms of the accepted nominal:
    # cost_quad (tracking+terminal cost without ReB/AL), path-constraint
    # values g and terminal-constraint values h.  Lets each AL outer
    # iteration re-fold the updated penalties over the SAME trajectory
    # without re-evaluating costs/constraints (the reference recomputes
    # them each iteration, MultiPhaseDDP.cpp:277-300).
    cost_quad: Any; con_g: Any; con_h: Any
    success: Any          # False only on unrecoverable backward-sweep failure
    done: Any             # outer-loop termination flag
    info: SolverInfo


def riccati_lft_elements(A, B, C, D, lx, lu, ly, lxx, luu, lux, lyy,
                         phix, phixx, defect, w, reg):
    """Per-knot linear-fractional-transform elements of the Riccati
    backward map (cf. PAPERS.md: Parallelization of Riccati Recursion):
    5-tuple (A, b, C, eta, J) per knot, [N+1, ...] with the terminal
    cost as the last element.  Dynamics steps eliminate u around the
    regularized luu; reset/padding steps (w) are plain affine transforms
    (G <- Px^T G, H <- Px^T H Px).  Shared by the in-solver
    associative-scan sweep and the knot-sharded multi-device sweep
    (parallel/knot_riccati.py)."""
    xs = A.shape[-1]
    us = B.shape[-1]
    dtype = A.dtype
    I_u = jnp.eye(us, dtype=dtype)
    I_x = jnp.eye(xs, dtype=dtype)

    lyC = jnp.einsum("kij,ki->kj", C, ly)
    lyD = jnp.einsum("kij,ki->kj", D, ly)
    lxx = lxx + jnp.einsum("kji,kjl,klm->kim", C, lyy, C) + reg * I_x
    luu = luu + jnp.einsum("kji,kjl,klm->kim", D, lyy, D) + reg * I_u
    lux = lux + jnp.einsum("kji,kjl,klm->kim", D, lyy, C)
    lx = lx + lyC
    lu = lu + lyD

    luu_inv = jnp.linalg.inv(luu)
    Kc = jnp.einsum("kij,kjl->kil", luu_inv, lux)
    kc = jnp.einsum("kij,kj->ki", luu_inv, lu)
    A_d = A - jnp.einsum("kij,kjl->kil", B, Kc)
    b_d = defect[1:] - jnp.einsum("kij,kj->ki", B, kc)
    C_d = jnp.einsum("kij,kjl,kml->kim", B, luu_inv, B)
    eta_d = lx - jnp.einsum("kji,kj->ki", Kc, lu)
    J_d = lxx - jnp.einsum("kji,kjl->kil", lux, Kc)
    J_d = 0.5 * (J_d + jnp.swapaxes(J_d, -1, -2))

    zC = jnp.zeros_like(C_d[..., :xs, :xs])
    wA = w[:, None, None]
    A_e = jnp.where(wA, A, A_d)
    b_e = jnp.where(w[:, None], defect[1:], b_d)
    C_e = jnp.where(wA, zC, C_d)
    eta_e = jnp.where(w[:, None], phix[:-1], eta_d)
    J_e = jnp.where(wA, phixx[:-1], J_d)

    A_e = jnp.concatenate([A_e, jnp.zeros((1, xs, xs), dtype)])
    b_e = jnp.concatenate([b_e, jnp.zeros((1, xs), dtype)])
    C_e = jnp.concatenate([C_e, jnp.zeros((1, xs, xs), dtype)])
    eta_e = jnp.concatenate([eta_e, phix[-1:]])
    J_e = jnp.concatenate([J_e, phixx[-1:]])
    return (A_e, b_e, C_e, eta_e, J_e), (lx, lu, lxx, luu, lux)


def lft_combine(later, earlier):
    """Associative composition of Riccati LFT elements; folds as
    fn(suffix, elem) under associative_scan(reverse=True) — first arg
    the later-time composite, second the earlier element."""
    f, l = earlier, later
    Af, bf, Cf, etaf, Jf = f
    Al, bl, Cl, etal, Jl = l
    xs = Af.shape[-1]
    M = jnp.linalg.solve(
        jnp.eye(xs, dtype=Af.dtype) + jnp.einsum(
            "...ij,...jl->...il", Cf, Jl),
        jnp.concatenate([Af, (bf - jnp.einsum(
            "...ij,...j->...i", Cf, etal))[..., None], Cf], -1))
    MA = M[..., :xs]
    Mb = M[..., xs]
    MC = M[..., xs + 1:]
    Nt = jnp.linalg.solve(
        jnp.eye(xs, dtype=Af.dtype) + jnp.einsum(
            "...ij,...jl->...il", Jl, Cf),
        jnp.concatenate([
            jnp.einsum("...ij,...jl->...il", Jl, Af),
            (etal + jnp.einsum("...ij,...j->...i", Jl, bf))[
                ..., None]], -1))
    NJ = Nt[..., :xs]
    Ne = Nt[..., xs]
    A_t = jnp.einsum("...ij,...jl->...il", Al, MA)
    b_t = jnp.einsum("...ij,...j->...i", Al, Mb) + bl
    C_t = jnp.einsum("...ij,...lj->...il", jnp.einsum(
        "...ij,...jl->...il", Al, MC), Al) + Cl
    eta_t = jnp.einsum("...ji,...j->...i", Af, Ne) + etaf
    J_t = jnp.einsum("...ji,...jl->...il", Af, NJ) + Jf
    J_t = 0.5 * (J_t + jnp.swapaxes(J_t, -1, -2))
    return (A_t, b_t, C_t, eta_t, J_t)


def init_traj(plan: KnotPlan, xs, us, ys, Xbar0, Ubar0, dtype):
    N = plan.n_steps
    z = functools.partial(jnp.zeros, dtype=dtype)
    return TrajState(
        Xbar=jnp.asarray(Xbar0, dtype), Ubar=jnp.asarray(Ubar0, dtype),
        Defect_bar=z((N + 1, xs)),
        X=jnp.asarray(Xbar0, dtype), U=jnp.asarray(Ubar0, dtype),
        Y=z((N, ys)), Xsim=jnp.asarray(Xbar0, dtype), Defect=z((N + 1, xs)),
        dX=z((N + 1, xs)), dU=z((N, us)), K=z((N, us, xs)),
        A=z((N, xs, xs)), B=z((N, xs, us)), C=z((N, ys, xs)),
        D=z((N, ys, us)),
        lx=z((N, xs)), lu=z((N, us)), ly=z((N, ys)),
        lxx=z((N, xs, xs)), luu=z((N, us, us)), lux=z((N, us, xs)),
        lyy=z((N, ys, ys)),
        phix=z((N + 1, xs)), phixx=z((N + 1, xs, xs)),
        G=z((N + 1, xs)), H=z((N + 1, xs, xs)),
        Qu=z((N, us)), Quu=z((N, us, us)), Qux=z((N, us, xs)),
    )


class SolveResult(NamedTuple):
    """Trimmed solver output for batched/throughput use: exactly what the
    MPC command tape consumes (MHPCLocomotion.cpp:190-287) + telemetry."""
    Xbar: Any; Ubar: Any; K: Any
    Qu: Any; Quu: Any; Qux: Any
    cost: Any; feas: Any
    max_pconstr: Any; max_tconstr: Any
    success: Any
    info: SolverInfo


def make_solver(fns, opts: SolverOptions, *, all_shooting=True,
                info_len=64, trim_output=False,
                parallel_linear_rollout=True, parallel_riccati=False,
                parallel_line_search=True, max_resets=None,
                iter_callback=None, reg_floor=0.0, lq_knot_chunk=None,
                knot_axis=None, knot_shards=1):
    """Build the jit-ready ``solve(plan, pen, x0, Xbar0, Ubar0)`` function.

    fns: a ProblemFns, or a SegmentedFns for cascaded plans with a static
    per-model step layout.
    all_shooting: static flag — every active knot is a shooting state (the
    reference's update_SS_config(horizon+1) configuration), enabling the
    vmap-parallel rollout.
    trim_output: return a small SolveResult instead of the full SolverState
    (lets XLA drop the large per-knot temporaries from the outputs).
    max_resets: static cap on reset steps per segment.  When set, the reset
    map and its partial are evaluated ONLY at the (gathered) reset steps
    instead of masked-evaluated on every knot — the reference likewise
    evaluates resetmap_partial only at phase boundaries
    (MultiPhaseDDP.cpp:196-200).  Matters when the reset involves the
    impact KKT solve (MHPC).
    iter_callback: optional host callback ``f(Xbar, Ubar, iter)`` invoked
    (via io_callback) after every AL outer iteration — the analogue of the
    reference's intermediate-trajectory debug publishing
    (MultiPhaseDDP.h:95-107, channel "intermediate_ddp_traj").  Costs a
    device->host sync per outer iteration; debug only.
    parallel_riccati: run the backward sweep as an associative scan
    (backward_sweep_parallel) instead of the sequential recursion, which
    is a reverse scan per scenario and one GPU kernel per scenario batch
    (ops/riccati_sweep.py).
    lq_knot_chunk: when set, evaluate the per-knot dynamics/cost
    linearizations in sequential chunks of this many knots (lax.map of a
    chunk-wide vmap) instead of one vmap over the whole horizon.  Caps
    the LQ stage's live AD temporaries at chunk-proportional size — the
    enabler for long-horizon configs (cascade500: the whole-horizon WB
    jacfwd temps are ~1.2 GB/scenario, HBM-capping the batch at 8).
    Identical outputs to the unchunked path (tests/test_mhpc_segmented.py).
    reg_floor: minimum regularization for every backward sweep attempt.
    The reference starts each sweep at reg=0 (MultiPhaseDDP.cpp:136-165)
    and retries at reg_min_init on PSD failure.  Where the float32 PSD
    test rejects the marginal reg=0 pivots, every DDP iteration pays a
    wasted sweep; reg_floor=opts.reg_min_init lands on the reg the retry
    would reach at the cost of one sweep instead of two.  Default
    0.0 = reference-faithful schedule.
    knot_axis / knot_shards: when knot_axis is a mesh axis name bound by
    an ENCLOSING shard_map (parallel/mesh.make_batched_solver's
    knot_shards option builds the ("scenario", "knot") mesh), the
    backward Riccati sweep runs KNOT-SHARDED across that axis: each
    device scans its contiguous block of the horizon and one
    all_gather of per-block composites completes the suffix composition
    (parallel/knot_riccati.py) — the sequence-parallel counterpart of
    the reference's sequential SinglePhase::backward_sweep
    (SinglePhase.cpp:323-391).  knot_shards must equal the static mesh
    axis size.  Outputs are bit-identical in structure to the
    associative-scan sweep (pinned in tests/test_knot_riccati.py).
    """
    if knot_axis is not None and knot_shards < 2:
        raise ValueError("knot_axis requires knot_shards >= 2 (the "
                         "static size of the mesh axis)")
    if knot_axis is not None and parallel_riccati:
        raise ValueError("knot_axis selects the knot-sharded sweep; it "
                         "cannot be combined with parallel_riccati")
    segmented = isinstance(fns, SegmentedFns)
    if segmented:
        seg_counts = tuple(int(c) for c in fns.counts)
        seg_fns = tuple(fns.fns)
        if not (all_shooting and opts.MS):
            raise ValueError("SegmentedFns requires the all-shooting "
                             "multiple-shooting configuration")

    def _chunked_vmap(g, chunk):
        """vmap over the leading (knot) axis in sequential `chunk`-wide
        pieces (lax.map of a chunk-wide vmap): identical outputs, live AD
        temporaries capped at chunk size.  Pads the axis by repeating the
        first element (results for padding discarded)."""
        vg = jax.vmap(g)

        def run(*args):
            leaves = jax.tree.leaves(args)
            if any(getattr(a, "ndim", 0) == 0 for a in leaves):
                raise ValueError(
                    "_chunked_vmap: scalar (0-d) leaves have no leading "
                    "knot axis to chunk over")
            N = leaves[0].shape[0]
            bad = [a.shape for a in leaves if a.shape[0] != N]
            if bad:
                raise ValueError(
                    f"_chunked_vmap: all arguments must share the leading "
                    f"(knot) axis {N}; got leading dims {bad}")
            if N <= chunk:
                return vg(*args)
            n_pad = (-N) % chunk

            def prep(a):
                if n_pad:
                    a = jnp.concatenate(
                        [a, jnp.broadcast_to(a[:1], (n_pad,) + a.shape[1:])],
                        axis=0)
                return a.reshape(((N + n_pad) // chunk, chunk) + a.shape[1:])

            out = jax.lax.map(lambda ch: vg(*ch),
                              jax.tree.map(prep, args))
            return jax.tree.map(
                lambda a: a.reshape((N + n_pad,) + a.shape[2:])[:N], out)
        return run

    def vmap_over(make_fn, n_extra=0, chunk=None, batch_attr=None):
        """vmap a per-knot callable over the leading axis; for segmented
        fns each segment's slice maps with its own callable, outputs
        concatenated.  n_extra=1 for knot arrays (N+1: the last segment
        owns the terminal knot).  chunk: see lq_knot_chunk.  batch_attr:
        name of an optional ProblemFns *_batch override — when the
        segment's fns carry one, it is called on the whole slice instead
        of the vmap (and the chunked vmap: batch overrides own their
        memory strategy)."""
        _vmap = (jax.vmap if chunk is None
                 else lambda g: _chunked_vmap(g, chunk))

        def seg_fn(f):
            bf = getattr(f, batch_attr, None) if batch_attr else None
            return bf if bf is not None else _vmap(make_fn(f))

        if not segmented:
            return seg_fn(fns)

        def apply(*args):
            outs, o = [], 0
            for i, (cnt, f) in enumerate(zip(seg_counts, seg_fns)):
                c = cnt + (n_extra if i == len(seg_counts) - 1 else 0)
                sl = jax.tree.map(lambda a: a[o:o + c], args)
                outs.append(seg_fn(f)(*sl))
                o += c
            return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0),
                                *outs)
        return apply

    def _make_step_sim(f):
        def step_sim(x, u, sd):
            xn_dyn, y = f.dyn(x, u, sd)
            xn_res = f.reset(x, sd)
            xn = jnp.where(sd.is_reset > 0, xn_res, xn_dyn)
            return xn, y
        return step_sim

    v_dyn = vmap_over(lambda f: f.dyn, batch_attr="dyn_batch")
    v_step_sim = vmap_over(_make_step_sim)
    v_dyn_partials = vmap_over(lambda f: f.dyn_partials,
                               chunk=lq_knot_chunk,
                               batch_attr="dyn_partials_batch")
    v_reset_partial = vmap_over(lambda f: f.reset_partial,
                                batch_attr="reset_partial_batch")
    v_run_cost = vmap_over(lambda f: f.run_cost,
                           batch_attr="run_cost_batch")
    v_run_cost_partials = vmap_over(lambda f: f.run_cost_partials,
                                    chunk=lq_knot_chunk,
                                    batch_attr="run_cost_partials_batch")
    v_path_con = vmap_over(lambda f: f.path_con)
    v_path_con_partials = vmap_over(lambda f: f.path_con_partials,
                                    chunk=lq_knot_chunk)
    v_term_cost = vmap_over(lambda f: f.term_cost, n_extra=1,
                            batch_attr="term_cost_batch")
    v_term_cost_partials = vmap_over(lambda f: f.term_cost_partials,
                                     n_extra=1,
                                     batch_attr="term_cost_partials_batch")
    v_term_con = vmap_over(lambda f: f.term_con, n_extra=1,
                           batch_attr="term_con_batch")
    v_term_con_partials = vmap_over(lambda f: f.term_con_partials,
                                    n_extra=1,
                                    batch_attr="term_con_partials_batch")

    def _reset_sites(sd):
        """Per segment: (offset, fns, gathered indices, validity mask)."""
        segs = (list(zip(seg_counts, seg_fns)) if segmented
                else [(sd.active.shape[0], fns)])
        o, sites = 0, []
        for cnt, f in segs:
            is_r = sd.is_reset[o:o + cnt]
            idx = jnp.nonzero(is_r > 0, size=max_resets, fill_value=0)[0]
            valid = jnp.take(is_r, idx) > 0
            sites.append((o, cnt, f, idx, valid))
            o += cnt
        return sites

    # ---------------- rollout ----------------------------------------
    def rollout(plan, tr: TrajState, x0, eps):
        """Hybrid rollout (SinglePhase.cpp:182-233 + MultiPhaseDDP.cpp:49-92
        flattened).  Returns updated (X, U, Y, Xsim, Defect, ok)."""
        sd = plan.step
        kd = plan.knot
        ka = kd.active[:, None]
        if all_shooting and opts.MS:
            X = tr.Xbar + eps * tr.dX
            dx = X[:-1] - tr.Xbar[:-1]
            U = tr.Ubar + eps * tr.dU + jnp.einsum("kij,kj->ki", tr.K, dx)
            if max_resets is None:
                Xsim_next, Y = v_step_sim(X[:-1], U, sd)
            else:
                Xsim_next, Y = v_dyn(X[:-1], U, sd)
                for (o, cnt, f, idx, valid) in _reset_sites(sd):
                    x_g = X[o:o + cnt][idx]
                    sd_g = jax.tree.map(lambda a: a[o:o + cnt][idx], sd)
                    reset_f = (f.reset_batch if f.reset_batch is not None
                               else jax.vmap(f.reset))
                    xr = reset_f(x_g, sd_g)
                    rows = jnp.where(valid[:, None], xr,
                                     Xsim_next[o:o + cnt][idx])
                    Xsim_next = Xsim_next.at[o + idx].set(rows)
            Xsim_next = jnp.where(sd.active[:, None] > 0, Xsim_next, X[1:])
            Xsim = jnp.concatenate([x0[None, :], Xsim_next], axis=0)
        else:
            # Sequential single-shooting rollout (option.MS == false path,
            # SinglePhase.cpp:182-233 with an empty shooting-state set).
            step_sim = _make_step_sim(fns)

            def ss_body(carry, inp):
                x = carry
                sd_k, xbar_k, ubar_k, dU_k, K_k = inp
                u = ubar_k + eps * dU_k + K_k @ (x - xbar_k)
                xn, y = step_sim(x, u, sd_k)
                xn = jnp.where(sd_k.active > 0, xn, x)
                return xn, (x, u, y, xn)
            inp = (sd, tr.Xbar[:-1], tr.Ubar, tr.dU, tr.K)
            _, (Xs, U, Y, Xn) = jax.lax.scan(ss_body, x0, inp)
            X = jnp.concatenate([Xs, Xn[-1:]], axis=0)
            Xsim = X
        Defect = (Xsim - X) * ka
        ok = jnp.all(jnp.isfinite(Xsim)) & (
            jnp.max(jnp.sum((Xsim * ka) ** 2, axis=-1)) < 1e12)
        return tr._replace(X=X, U=U, Y=Y, Xsim=Xsim, Defect=Defect), ok

    # ---------------- cost -------------------------------------------
    def eval_constraints(plan, tr):
        g = v_path_con(tr.X[:-1], tr.U, tr.Y, plan.step)
        h = v_term_con(tr.X, plan.knot)
        return g, h

    def cost_terms(plan, tr: TrajState):
        """Penalty-independent cost pieces: quadratic (tracking+terminal)
        cost and raw constraint values.  These depend only on the
        trajectory, so they are cached on the accepted nominal and reused
        across AL penalty updates."""
        sd, kd = plan.step, plan.knot
        run_mask = sd.active * (1.0 - sd.is_reset)
        l = v_run_cost(tr.X[:-1], tr.U, tr.Y, sd)
        g, h = eval_constraints(plan, tr)
        term_mask = kd.active * kd.is_terminal
        phi = v_term_cost(tr.X, kd)
        cq = jnp.sum(l * run_mask) + jnp.sum(phi * term_mask)
        return cq, g, h

    def cost_from_terms(plan, pen: PenaltyParams, cq, g, h):
        """Fold ReB/AL penalties over cached cost terms
        (SinglePhase.cpp:236-262) + max constraint violations."""
        sd, kd = plan.step, plan.knot
        run_mask = sd.active * (1.0 - sd.is_reset)
        term_mask = kd.active * kd.is_terminal
        total = cq
        if opts.ReB_active:
            reb = jax.vmap(penalty.reb_cost)(g, pen.reb_delta, pen.reb_eps,
                                             pen.reb_active)
            total = total + jnp.sum(sd.dt * reb * run_mask)
        if opts.AL_active:
            al = jax.vmap(penalty.al_cost)(h, pen.al_lambda, pen.al_sigma,
                                           pen.al_active)
            total = total + jnp.sum(al * term_mask)
        # violations: path g>=0 feasible (max_pconstr <= 0);
        # terminal |h| (max_tconstr >= 0)
        g_act = (pen.reb_active > 0) & (run_mask[:, None] > 0)
        max_p = jnp.min(jnp.where(g_act, g, 0.0))
        max_p = jnp.minimum(max_p, 0.0)
        h_act = (pen.al_active > 0) & (term_mask[:, None] > 0)
        max_t = jnp.max(jnp.where(h_act, jnp.abs(h), 0.0))
        return total, max_p, max_t

    def dyn_feas(plan, Defect):
        return jnp.sqrt(jnp.sum(Defect ** 2))

    # ---------------- LQ approximation -------------------------------
    def lq_approx(plan, pen, tr: TrajState):
        """(SinglePhase.cpp:265-320), batched."""
        sd, kd = plan.step, plan.knot
        A_d, B_d, C, D = v_dyn_partials(tr.X[:-1], tr.U, sd)
        is_r = sd.is_reset[:, None, None]
        act = sd.active[:, None, None]
        if max_resets is None:
            P = v_reset_partial(tr.X[:-1], sd)
            A = jnp.where(is_r > 0, P, A_d) * act
            B = jnp.where(is_r > 0, jnp.zeros_like(B_d), B_d) * act
        else:
            A, B = A_d, B_d
            for (o, cnt, f, idx, valid) in _reset_sites(sd):
                x_g = tr.X[o:o + cnt][idx]
                sd_g = jax.tree.map(lambda a: a[o:o + cnt][idx], sd)
                rp_f = (f.reset_partial_batch
                        if f.reset_partial_batch is not None
                        else jax.vmap(f.reset_partial))
                P_g = rp_f(x_g, sd_g)
                vm = valid[:, None, None]
                A = A.at[o + idx].set(jnp.where(vm, P_g, A[o:o + cnt][idx]))
                B = B.at[o + idx].set(
                    jnp.where(vm, 0.0, B[o:o + cnt][idx]))
            A = A * act
            B = B * act
        C = C * (1.0 - sd.is_reset)[:, None, None] * act
        D = D * (1.0 - sd.is_reset)[:, None, None] * act

        lx, lu, ly, lxx, luu, lux, lyy = v_run_cost_partials(
            tr.X[:-1], tr.U, tr.Y, sd)
        if opts.ReB_active:
            g = v_path_con(tr.X[:-1], tr.U, tr.Y, sd)
            gx, gu, gy = v_path_con_partials(
                tr.X[:-1], tr.U, tr.Y, sd)
            rb = jax.vmap(penalty.reb_partials)(
                g, gx, gu, gy, pen.reb_delta, pen.reb_eps, pen.reb_active)
            dt = sd.dt
            lx = lx + dt[:, None] * rb[0]
            lu = lu + dt[:, None] * rb[1]
            ly = ly + dt[:, None] * rb[2]
            lxx = lxx + dt[:, None, None] * rb[3]
            luu = luu + dt[:, None, None] * rb[4]
            lyy = lyy + dt[:, None, None] * rb[5]

        phix, phixx = v_term_cost_partials(tr.X, kd)
        if opts.AL_active:
            h = v_term_con(tr.X, kd)
            hx = v_term_con_partials(tr.X, kd)
            ag, ah = jax.vmap(penalty.al_partials)(
                h, hx, pen.al_lambda, pen.al_sigma, pen.al_active)
            phix = phix + ag
            phixx = phixx + ah
        tmask = (kd.active * kd.is_terminal)[:, None]
        phix = phix * tmask
        phixx = phixx * tmask[..., None]
        rmask = (sd.active * (1.0 - sd.is_reset))[:, None]
        return tr._replace(
            A=A, B=B, C=C, D=D,
            lx=lx * rmask, lu=lu * rmask, ly=ly * rmask,
            lxx=lxx * rmask[..., None], luu=luu * rmask[..., None],
            lux=lux * rmask[..., None], lyy=lyy * rmask[..., None],
            phix=phix, phixx=phixx)

    # ---------------- parallel (associative-scan) backward sweep ------
    def backward_sweep_parallel(plan, tr: TrajState, reg):
        """Parallel-in-time Riccati sweep.

        The value-function backward map of each step is a linear
        fractional transform represented by a 5-tuple (A, b, C, eta, J)
        with an associative composition (cf. PAPERS.md: Parallelization of
        Riccati Recursion / temporal LQT parallelization), extended here
        with control cross terms (lux), multiple-shooting defects, and the
        impact-aware reset transforms (G <- Px^T G, H <- Px^T H Px) which
        are plain affine elements.  Suffix compositions via
        `lax.associative_scan(reverse=True)` give every knot's (G, H) in
        O(log N) depth; gains/Q-expansions are then recovered knot-parallel.
        Produces the same outputs (incl. the PSD success flag) as the
        sequential sweep.
        """
        sd = plan.step
        xs = tr.Xbar.shape[-1]
        us = tr.Ubar.shape[-1]
        I_u = jnp.eye(us, dtype=tr.Xbar.dtype)
        w = ((sd.is_reset > 0) | (sd.active == 0))

        elems, (lx, lu, lxx, luu, lux) = riccati_lft_elements(
            tr.A, tr.B, tr.C, tr.D, tr.lx, tr.lu, tr.ly, tr.lxx, tr.luu,
            tr.lux, tr.lyy, tr.phix, tr.phixx, tr.Defect, w, reg)
        _, _, _, eta_s, J_s = jax.lax.associative_scan(
            lft_combine, elems, reverse=True)
        return _gains_from_GH(tr, eta_s, J_s, lu, luu, lux, w, I_u)

    def _gains_from_GH(tr, G, H, lu, luu, lux, w, I_u):
        """Knot-parallel Q-expansion / gains from (G, H) (the same
        formulas as the sequential sweep, SinglePhase.cpp:334-386);
        shared by the associative-scan and knot-sharded sweeps."""
        Gn = G[1:] + jnp.einsum("kij,kj->ki", H[1:], tr.Defect[1:])
        Qu = lu + jnp.einsum("kji,kj->ki", tr.B, Gn)
        Quu = luu + jnp.einsum("kji,kjl,klm->kim", tr.B, H[1:], tr.B)
        Qux = lux + jnp.einsum("kji,kjl,klm->kim", tr.B, H[1:], tr.A)
        L = jnp.linalg.cholesky(Quu - 1e-9 * I_u)
        ok_chol = jnp.all(jnp.isfinite(L), axis=(-1, -2))
        ok_k = ok_chol | (w > 0)
        L_safe = jnp.where(ok_chol[:, None, None], L,
                           jnp.broadcast_to(I_u, L.shape))
        Quu_inv = jax.vmap(
            lambda Lk: jax.scipy.linalg.cho_solve((Lk, True), I_u))(L_safe)
        dU = -jnp.einsum("kij,kj->ki", Quu_inv, Qu)
        K = -jnp.einsum("kij,kjl->kil", Quu_inv, Qux)
        dV_k = -jnp.einsum("ki,ki->k", Qu, dU) * (1.0 - w)
        dV1 = -jnp.sum(dV_k)
        dV2 = jnp.sum(dV_k)
        zK = jnp.zeros_like(K)
        K = jnp.where(w[:, None, None], zK, K)
        dU = jnp.where(w[:, None], jnp.zeros_like(dU), dU)
        Qu = jnp.where(w[:, None], jnp.zeros_like(Qu), Qu)
        Quu = jnp.where(w[:, None, None], jnp.broadcast_to(I_u, Quu.shape),
                        Quu)
        Qux = jnp.where(w[:, None, None], jnp.zeros_like(Qux), Qux)
        ok = jnp.all(ok_k) & jnp.all(jnp.isfinite(H))
        G = G.at[0].add(H[0] @ tr.Defect[0])
        tr = tr._replace(G=G, H=H, K=K, dU=dU, Qu=Qu, Quu=Quu, Qux=Qux)
        return tr, dV1, dV2, ok

    def backward_sweep_knot(plan, tr: TrajState, reg):
        """Knot-sharded (sequence-parallel) Riccati sweep over the mesh
        axis `knot_axis` — the distributed counterpart of the
        reference's strictly sequential SinglePhase::backward_sweep
        (HSDDPSolver/source/SinglePhase.cpp:323-391; SURVEY section 2.7
        "sequential -> parallel-in-time").

        Same LFT-element math as backward_sweep_parallel, but the
        suffix composition runs as a two-level scan: each device scans
        its contiguous block of knots, one all_gather of per-block
        composites rides the knot axis, every device folds the later
        blocks' composites into a tail transform
        (parallel/knot_riccati.py).  The [N]-replicated inputs/outputs
        of the rest of the solver are preserved by slicing the local
        block via axis_index and re-gathering (tiled) at the end, so
        the sweep composes with the scenario vmap/shard_map unchanged.
        """
        from cafempc.parallel.knot_riccati import (pad_elements,
                                                   suffix_GH_local)
        sd = plan.step
        us = tr.Ubar.shape[-1]
        I_u = jnp.eye(us, dtype=tr.Xbar.dtype)
        w = ((sd.is_reset > 0) | (sd.active == 0))

        elems, (lx, lu, lxx, luu, lux) = riccati_lft_elements(
            tr.A, tr.B, tr.C, tr.D, tr.lx, tr.lu, tr.ly, tr.lxx, tr.luu,
            tr.lux, tr.lyy, tr.phix, tr.phixx, tr.Defect, w, reg)
        elems_p, N1 = pad_elements(elems, knot_shards)
        blk = elems_p[0].shape[0] // knot_shards
        idx = jax.lax.axis_index(knot_axis)
        local = tuple(jax.lax.dynamic_slice_in_dim(e, idx * blk, blk)
                      for e in elems_p)
        Gl, Hl = suffix_GH_local(local, knot_axis, knot_shards)
        G = jax.lax.all_gather(Gl, knot_axis, tiled=True)[:N1]
        H = jax.lax.all_gather(Hl, knot_axis, tiled=True)[:N1]
        return _gains_from_GH(tr, G, H, lu, luu, lux, w, I_u)

    def backward_sweep(plan, tr: TrajState, reg):
        """Sequential backward sweep (SinglePhase.cpp:323-391 +
        MultiPhaseDDP.cpp:174-213 unified: dynamics step | reset/padding
        transform) through ops/riccati_sweep.sweep_op: a reverse scan per
        scenario; under the scenario vmap one kernel for the whole batch
        on a GPU.  reg enters per scenario, so the folded cost terms below
        are invariant across the regularization retry loop."""
        sd = plan.step
        lx = tr.lx + jnp.einsum("kij,ki->kj", tr.C, tr.ly)
        lu = tr.lu + jnp.einsum("kij,ki->kj", tr.D, tr.ly)
        lxx = tr.lxx + jnp.einsum("kji,kjl,klm->kim", tr.C, tr.lyy, tr.C)
        luu = tr.luu + jnp.einsum("kji,kjl,klm->kim", tr.D, tr.lyy, tr.D)
        lux = tr.lux + jnp.einsum("kji,kjl,klm->kim", tr.D, tr.lyy, tr.C)
        wb = (sd.is_reset > 0) | (sd.active == 0)
        # transform steps read phix/phixx, dynamics steps lx/lxx: one
        # merged stream each
        lx_m = jnp.where(wb[:, None], tr.phix[:-1], lx)
        lxx_m = jnp.where(wb[:, None, None], tr.phixx[:-1], lxx)
        G_s, H_s, K, dU, Qu, Quu, Qux, ok_f, dv = sweep_op(
            tr.A, tr.B, lx_m, lu, lxx_m, luu, lux, tr.phix[-1],
            tr.phixx[-1], tr.Defect, wb.astype(jnp.int32),
            jnp.asarray(reg, tr.Xbar.dtype))
        G = jnp.concatenate([G_s, tr.phix[-1:]], axis=0)
        H = jnp.concatenate([H_s, tr.phixx[-1:]], axis=0)
        # value gradient defect correction at the initial knot
        # (SinglePhase.cpp:389)
        G = G.at[0].add(H[0] @ tr.Defect[0])
        ok = (ok_f > 0.5) & jnp.all(jnp.isfinite(H))
        tr = tr._replace(G=G, H=H, K=K, dU=dU, Qu=Qu, Quu=Quu, Qux=Qux)
        return tr, dv[0], dv[1], ok

    sweep_fn = (backward_sweep_knot if knot_axis is not None
                else backward_sweep_parallel if parallel_riccati
                else backward_sweep)

    def backward_sweep_regularized(plan, tr, reg0):
        """(MultiPhaseDDP.cpp:136-165).

        The while loop carries ONLY the sweep outputs (G/H/K/dU/Q*) plus
        scalars — the sweep inputs (A/B/cost partials/defects) are
        loop-invariant closures.  Carrying the whole TrajState made XLA
        copy every per-knot buffer at each loop boundary (~18 ms/solve of
        pure copies in the round-2 trace)."""
        def cond(c):
            outs, reg, ok, dV1, dV2, it = c
            return (~ok) & (reg <= opts.reg_max) & (it < 32)

        def body(c):
            outs, reg, ok, _, _, it = c
            tr2, dV1, dV2, ok2 = sweep_fn(plan, tr, reg)
            outs2 = (tr2.G, tr2.H, tr2.K, tr2.dU, tr2.Qu, tr2.Quu,
                     tr2.Qux)
            reg2 = jnp.where(ok2, reg,
                             jnp.maximum(reg * opts.update_regularization,
                                         opts.reg_min_init))
            return (outs2, reg2, ok2, dV1, dV2, it + 1)

        if reg_floor:
            reg0 = jnp.maximum(reg0, jnp.asarray(reg_floor, reg0.dtype))
        zero = jnp.zeros((), dtype=tr.Xbar.dtype)
        outs0 = (tr.G, tr.H, tr.K, tr.dU, tr.Qu, tr.Quu, tr.Qux)
        c0 = (outs0, reg0, jnp.bool_(False), zero, zero, jnp.int32(0))
        outs, reg, ok, dV1, dV2, n_it = jax.lax.while_loop(cond, body, c0)
        tr = tr._replace(G=outs[0], H=outs[1], K=outs[2], dU=outs[3],
                         Qu=outs[4], Quu=outs[5], Qux=outs[6])
        reg = reg / 20.0
        reg = jnp.where(reg < 1e-6, 0.0, reg)
        return tr, reg, ok, dV1, dV2, n_it

    # ---------------- linear rollout ----------------------------------
    def _lin_dV(plan, tr: TrajState, dX, eps):
        """Expected cost change along the search direction of the
        associative-scan rollout (SinglePhase.cpp:160-175)."""
        sd = plan.step
        w1 = 1.0 - ((sd.is_reset > 0) | (sd.active == 0)).astype(dX.dtype)
        dxk = dX[:-1]
        duk = eps * tr.dU + jnp.einsum("kij,kj->ki", tr.K, dxk)
        dV1_dyn = jnp.sum(w1 * (jnp.einsum("ki,ki->k", tr.lx, dxk)
                                + jnp.einsum("ki,ki->k", tr.lu, duk)))
        dV2_dyn = jnp.sum(w1 * (
            jnp.einsum("ki,kij,kj->k", dxk, tr.lxx, dxk)
            + jnp.einsum("ki,kij,kj->k", duk, tr.luu, duk)
            + jnp.einsum("ki,kij,kj->k", duk, tr.lux, dxk)))
        dV1_tr = jnp.sum(jnp.einsum("ki,ki->k", tr.phix, dX))
        dV2_tr = jnp.sum(jnp.einsum("ki,kij,kj->k", dX, tr.phixx, dX))
        return dV1_dyn + dV1_tr, dV2_dyn + dV2_tr

    def linear_rollout_parallel(plan, tr: TrajState, eps):
        """Associative-scan linear rollout: the affine recursion
        dx_{k+1} = M_k dx_k + c_k (M_k = A_k + B_k K_k on dynamics steps,
        Px on reset/padding steps) is a parallel prefix composition
        (M2,c2)o(M1,c1) = (M2 M1, M2 c1 + c2) — O(log N) sequential depth
        instead of the reference's O(N) loop (SinglePhase.cpp:145-178).
        The dV sums are then plain masked reductions over knots."""
        sd = plan.step
        w = ((sd.is_reset > 0) | (sd.active == 0))[:, None, None]
        BK = jnp.einsum("kij,kjl->kil", tr.B, tr.K)
        M = jnp.where(w, tr.A, tr.A + BK)
        Bdu = jnp.einsum("kij,kj->ki", tr.B, eps * tr.dU)
        c = jnp.where(w[:, :, 0], 0.0, Bdu) + eps * tr.Defect[1:]

        dx0 = eps * tr.Defect[0]
        # prefix-compose: dX[k+1] = (M_k ... M_0) dx0 + accumulated c
        Mc, cc = jax.lax.associative_scan(
            lambda a, b: (jnp.einsum("kij,kjl->kil", b[0], a[0]),
                          jnp.einsum("kij,kj->ki", b[0], a[1]) + b[1]),
            (M, c))
        dX_tail = jnp.einsum("kij,j->ki", Mc, dx0) + cc
        dX = jnp.concatenate([dx0[None], dX_tail], axis=0)

        # dV terms: terminal contributions hit every phase-terminal knot
        # (phix/phixx are masked to those knots) + the final knot
        dV1, dV2 = _lin_dV(plan, tr, dX, eps)
        return tr._replace(dX=dX), dV1, dV2

    def linear_rollout_seq(plan, tr: TrajState, eps):
        """Multiple-shooting search direction + expected cost change
        (SinglePhase.cpp:145-178 + MultiPhaseDDP.cpp:12-42)."""
        sd = plan.step

        def step(carry, inp):
            dx, dV1, dV2 = carry
            (A, B, lx, lu, lxx, luu, lux, phx, phxx, dU, K, defect1,
             is_reset, active) = inp
            w = (is_reset > 0) | (active == 0)
            du = eps * dU + K @ dx
            dx_dyn = A @ dx + B @ du + eps * defect1
            dx_tr = A @ dx + eps * defect1
            dV1_dyn = lx @ dx + lu @ du
            dV2_dyn = dx @ (lxx @ dx) + du @ (luu @ du) + du @ (lux @ dx)
            dV1_tr = phx @ dx
            dV2_tr = dx @ (phxx @ dx)
            dx1 = jnp.where(w, dx_tr, dx_dyn)
            dV1 = dV1 + jnp.where(w, dV1_tr, dV1_dyn)
            dV2 = dV2 + jnp.where(w, dV2_tr, dV2_dyn)
            return (dx1, dV1, dV2), dx1

        dx0 = eps * tr.Defect[0]
        zero = jnp.zeros((), dtype=tr.Xbar.dtype)
        inp = (tr.A, tr.B, tr.lx, tr.lu, tr.lxx, tr.luu, tr.lux,
               tr.phix[:-1], tr.phixx[:-1], tr.dU, tr.K, tr.Defect[1:],
               sd.is_reset, sd.active)
        (dxN, dV1, dV2), dX_seq = jax.lax.scan(step, (dx0, zero, zero), inp)
        dX = jnp.concatenate([dx0[None], dX_seq], axis=0)
        # terminal contribution at the final knot (masked phix handles
        # padding; mirrors the per-phase terminal terms)
        dV1 = dV1 + tr.phix[-1] @ dxN
        dV2 = dV2 + dxN @ (tr.phixx[-1] @ dxN)
        return tr._replace(dX=dX), dV1, dV2

    linear_rollout = (linear_rollout_parallel if parallel_linear_rollout
                      else linear_rollout_seq)

    # ---------------- line search -------------------------------------
    def line_search(plan, pen, tr, x0, cost0, merit0, feas0, rho, dV1, dV2,
                    terms_nom):
        """(MultiPhaseDDP.cpp:95-133).

        Carries only the rollout outputs (X/U/Y/Xsim/Defect) — the rollout
        reads Xbar/dX/Ubar/dU/K, all loop-invariant — so the while loop
        does not copy the rest of the TrajState every trial."""
        def cond(c):
            roll, terms, eps, it, success, cost, feas, merit = c
            return (~success) & (eps > opts.ls_eps_min)

        def body(c):
            roll, terms, eps, it, success, cost, feas, merit = c
            tr2, ok = rollout(plan, tr, x0, eps)
            cq2, g2, h2 = cost_terms(plan, tr2)
            cost2, _, _ = cost_from_terms(plan, pen, cq2, g2, h2)
            feas2 = dyn_feas(plan, tr2.Defect)
            merit2 = cost2 + rho * feas2
            exp_cost = eps * dV1 + 0.5 * eps * eps * dV2
            exp_merit = exp_cost - eps * rho * feas0
            succ = (merit2 <= merit0 + opts.gamma * exp_merit) & ok
            eps2 = jnp.where(succ, eps, eps * opts.alpha)
            roll2 = (tr2.X, tr2.U, tr2.Y, tr2.Xsim, tr2.Defect)
            return (roll2, (cq2, g2, h2), eps2, it + 1, succ, cost2,
                    feas2, merit2)

        roll0 = (tr.X, tr.U, tr.Y, tr.Xsim, tr.Defect)
        terms0 = terms_nom
        c0 = (roll0, terms0, jnp.asarray(1.0, tr.Xbar.dtype), jnp.int32(0),
              jnp.bool_(False), cost0, feas0, merit0)
        roll, terms, eps, n_it, success, cost, feas, merit = \
            jax.lax.while_loop(cond, body, c0)
        tr = tr._replace(X=roll[0], U=roll[1], Y=roll[2], Xsim=roll[3],
                         Defect=roll[4])
        return tr, terms, success, cost, feas, merit, n_it

    # all backtracking candidates the sequential search could visit
    _n_ls = 0
    _e = 1.0
    while _e > opts.ls_eps_min * (1.0 + 1e-12) and _n_ls < 64:
        _n_ls += 1
        _e *= opts.alpha
    _n_ls = max(_n_ls, 1)

    def line_search_parallel(plan, pen, tr, x0, cost0, merit0, feas0, rho,
                             dV1, dV2, terms_nom):
        """Batched-candidate line search: evaluate every eps the
        reference's backtracking loop (MultiPhaseDDP.cpp:95-133) could
        try in ONE vmapped rollout, then select the first accepted
        candidate — identical accepted trajectory, O(1) sequential depth
        instead of up to len(candidates) rollouts."""
        dtype = tr.Xbar.dtype
        eps_c = opts.alpha ** jnp.arange(_n_ls, dtype=dtype)

        def trial(eps):
            tr2, ok = rollout(plan, tr, x0, eps)
            cq2, g2, h2 = cost_terms(plan, tr2)
            cost2, _, _ = cost_from_terms(plan, pen, cq2, g2, h2)
            feas2 = dyn_feas(plan, tr2.Defect)
            merit2 = cost2 + rho * feas2
            exp_cost = eps * dV1 + 0.5 * eps * eps * dV2
            exp_merit = exp_cost - eps * rho * feas0
            succ = (merit2 <= merit0 + opts.gamma * exp_merit) & ok
            return (tr2.X, tr2.U, tr2.Y, tr2.Xsim, tr2.Defect,
                    cq2, g2, h2, succ, cost2, feas2, merit2)

        (X, U, Y, Xsim, Defect, cq, g, h, succ, cost, feas, merit) = \
            jax.vmap(trial)(eps_c)
        any_ok = jnp.any(succ)
        # first accepted candidate, else the last tried (the reference
        # leaves the smallest-eps trial in the working trajectory)
        idx = jnp.where(any_ok, jnp.argmax(succ), _n_ls - 1)
        tr2 = tr._replace(X=X[idx], U=U[idx], Y=Y[idx], Xsim=Xsim[idx],
                          Defect=Defect[idx])
        n_it = jnp.where(any_ok, idx + 1, _n_ls).astype(jnp.int32)
        return (tr2, (cq[idx], g[idx], h[idx]), any_ok, cost[idx],
                feas[idx], merit[idx], n_it)

    ls_fn = line_search_parallel if parallel_line_search \
        else line_search

    # ---------------- solve -------------------------------------------
    def update_nominal(tr: TrajState):
        return tr._replace(Xbar=tr.X, Ubar=tr.U, Defect_bar=tr.Defect)

    def push_info(info: SolverInfo, cost, feas, maxt, maxp):
        i = jnp.minimum(info.n_entries, info_len - 1)
        return info._replace(
            cost_buf=info.cost_buf.at[i].set(cost),
            dyn_feas_buf=info.dyn_feas_buf.at[i].set(feas),
            eqn_feas_buf=info.eqn_feas_buf.at[i].set(maxt),
            ineq_feas_buf=info.ineq_feas_buf.at[i].set(maxp),
            n_entries=info.n_entries + 1)

    def ddp_inner(plan, s: SolverState):
        """One inner DDP iteration (MultiPhaseDDP.cpp:277-387).

        Cost under the CURRENT penalties comes from the cached nominal
        cost terms (cost_quad/con_g/con_h) — no constraint re-evaluation;
        only the penalty folding runs after an AL update."""
        tr = s.traj
        cost, maxp, maxt = cost_from_terms(plan, s.pen, s.cost_quad,
                                           s.con_g, s.con_h)
        feas = dyn_feas(plan, tr.Defect)
        with jax.named_scope("lq"):
            tr = lq_approx(plan, s.pen, tr)
        with jax.named_scope("sweep"):
            tr, reg, ok, dV1, dV2, reg_it = backward_sweep_regularized(
                plan, tr, jnp.zeros((), tr.Xbar.dtype) + s.reg)
        if opts.MS:
            with jax.named_scope("linear_rollout"):
                tr, dV1, dV2 = linear_rollout(plan, tr, 1.0)
        dV_abs = jnp.abs(dV1 + 0.5 * dV2)
        rho = jnp.where(
            feas > opts.dynamics_feas_thresh,
            dV_abs / ((1.0 - opts.merit_scale) * feas) + opts.merit_offset,
            0.0)
        merit = cost + rho * feas
        early = (dV_abs < opts.cost_thresh) & \
                (feas <= opts.dynamics_feas_thresh)

        terms_nom = (s.cost_quad, s.con_g, s.con_h)

        # The reference skips the line search on early termination
        # (MultiPhaseDDP.cpp:330-345).  Under the scenario vmap a
        # batched-predicate lax.cond executes both branches and selects
        # anyway — so run the search and where-select on `early`
        # (identical semantics, identical batched cost).
        with jax.named_scope("line_search"):
            tr2, terms2, ls_ok, cost2, feas2, merit2, ls_it = ls_fn(
                plan, s.pen, tr, s.x0, cost, merit, feas, rho, dV1, dV2,
                terms_nom)
        ls_ok = ls_ok & (~early)
        tr2 = jax.tree.map(
            lambda new, old: jnp.where(ls_ok, new, old),
            update_nominal(tr2), tr2)
        tr2 = jax.tree.map(lambda new, old: jnp.where(early, old, new),
                           tr2, tr)
        cost3 = jnp.where(ls_ok, cost2, cost)
        merit3 = jnp.where(ls_ok, merit2, merit)
        feas3 = jnp.where(ls_ok, feas2, feas)
        # nominal cost-term cache follows the accepted trajectory only
        terms3 = jax.tree.map(
            lambda new, old: jnp.where(ls_ok, new, old),
            terms2, terms_nom)
        # late termination (MultiPhaseDDP.cpp:369-370)
        late = (jnp.abs((cost - cost3) / jnp.where(cost == 0, 1.0, cost))
                < opts.cost_thresh) & (feas3 <= opts.dynamics_feas_thresh)
        tr, terms_f = tr2, terms3
        cost_f, merit_f, feas_f = cost3, merit3, feas3
        inner_done = jnp.where(early, jnp.bool_(True), late)
        info = s.info._replace(
            reg_iters=s.info.reg_iters + reg_it, iters=s.info.iters + 1,
            ls_iters=s.info.ls_iters + jnp.where(early, 0, ls_it))
        info = push_info(info, cost_f, feas_f, maxt, maxp)
        return s._replace(
            traj=tr, cost=cost_f, merit=merit_f, merit_rho=rho, feas=feas_f,
            dV1=dV1, dV2=dV2, reg=reg, max_pconstr=maxp, max_tconstr=maxt,
            cost_quad=terms_f[0], con_g=terms_f[1], con_h=terms_f[2],
            success=s.success & ok, info=info), inner_done | (~ok)

    def outer_body(plan, s: SolverState):
        """One AL outer iteration (MultiPhaseDDP.cpp:264-427)."""
        s = s._replace(max_pconstr_prev=s.max_pconstr,
                       max_tconstr_prev=s.max_tconstr,
                       reg=jnp.zeros((), s.cost.dtype))

        def inner_cond(c):
            s_, it, done = c
            return (it < opts.max_DDP_iter) & (~done)

        def inner_b(c):
            s_, it, done = c
            s2, done2 = ddp_inner(plan, s_)
            return (s2, it + 1, done2)

        s, _, _ = jax.lax.while_loop(inner_cond, inner_b,
                                     (s, jnp.int32(0), jnp.bool_(False)))

        # convergence checks (MultiPhaseDDP.cpp:394-405)
        feas_ok = s.feas <= opts.dynamics_feas_thresh
        conv = (s.max_tconstr < opts.tconstr_thresh) & \
               (jnp.abs(s.max_pconstr) < opts.pconstr_thresh) & feas_ok
        stall = (jnp.abs(s.max_tconstr - s.max_tconstr_prev) < 1e-4) & \
                (jnp.abs(s.max_pconstr - s.max_pconstr_prev) < 1e-4) & feas_ok
        done = conv | stall | (~s.success)

        # AL / ReB parameter updates on the cached nominal constraint
        # values (the reference likewise updates on the accepted nominal)
        g, h = s.con_g, s.con_h
        pen = s.pen
        if opts.AL_active:
            lam, sig = jax.vmap(
                penalty.al_update_params, in_axes=(0, 0, 0, 0, None, None,
                                                  None))(
                h, pen.al_lambda, pen.al_sigma, pen.al_active,
                opts.tconstr_thresh, opts.update_penalty, pen.al_sigma_max)
            pen = pen._replace(al_lambda=lam, al_sigma=sig)
        if opts.ReB_active:
            dl, ew = jax.vmap(
                penalty.reb_update_params,
                in_axes=(0, 0, 0, 0, None, None, None, None))(
                g, pen.reb_delta, pen.reb_eps, pen.reb_active,
                opts.pconstr_thresh, opts.update_relax, opts.update_ReB,
                pen.reb_delta_min)
            pen = pen._replace(reb_delta=dl, reb_eps=ew)
        return s._replace(pen=pen, done=done)

    def solve(plan: KnotPlan, pen0: PenaltyParams, x0, Xbar0, Ubar0):
        dtype = Xbar0.dtype
        xs = Xbar0.shape[-1]
        us = Ubar0.shape[-1]
        ys = plan.step.y_ref.shape[-1]
        tr = init_traj(plan, xs, us, ys, Xbar0, Ubar0, dtype)
        zero = jnp.zeros((), dtype)
        info = SolverInfo(
            cost_buf=jnp.zeros((info_len,), dtype),
            dyn_feas_buf=jnp.zeros((info_len,), dtype),
            eqn_feas_buf=jnp.zeros((info_len,), dtype),
            ineq_feas_buf=jnp.zeros((info_len,), dtype),
            n_entries=jnp.int32(0), iters=jnp.int32(0),
            ls_iters=jnp.int32(0), reg_iters=jnp.int32(0))
        n_g = plan.step.dt.shape[0]
        n_k = n_g + 1
        s = SolverState(
            traj=tr, pen=pen0, x0=jnp.asarray(x0, dtype),
            cost=zero, merit=zero, merit_rho=zero, feas=zero,
            dV1=zero, dV2=zero, reg=zero,
            max_pconstr=zero, max_tconstr=zero,
            max_pconstr_prev=zero, max_tconstr_prev=zero,
            cost_quad=zero,
            con_g=jnp.zeros((n_g, pen0.reb_active.shape[-1]), dtype),
            con_h=jnp.zeros((n_k, pen0.al_active.shape[-1]), dtype),
            success=jnp.bool_(True), done=jnp.bool_(False), info=info)

        # initial rollout + nominal update (MultiPhaseDDP.cpp:238-261)
        tr, _ = rollout(plan, s.traj, s.x0, 0.0)
        tr = update_nominal(tr)
        cq, g, h = cost_terms(plan, tr)
        cost, maxp, maxt = cost_from_terms(plan, s.pen, cq, g, h)
        feas = dyn_feas(plan, tr.Defect)
        s = s._replace(traj=tr, cost=cost, feas=feas, max_pconstr=maxp,
                       max_tconstr=maxt, cost_quad=cq, con_g=g, con_h=h,
                       info=push_info(s.info, cost, feas, maxt, maxp))

        def outer_cond(c):
            s_, it = c
            return (it < opts.max_AL_iter) & (~s_.done)

        def outer_b(c):
            s_, it = c
            s2 = outer_body(plan, s_)
            if iter_callback is not None:
                from jax.experimental import io_callback
                io_callback(iter_callback, None, s2.traj.Xbar,
                            s2.traj.Ubar, it, ordered=True)
            return (s2, it + 1)

        s, _ = jax.lax.while_loop(outer_cond, outer_b, (s, jnp.int32(0)))
        if trim_output:
            return SolveResult(
                Xbar=s.traj.Xbar, Ubar=s.traj.Ubar, K=s.traj.K,
                Qu=s.traj.Qu, Quu=s.traj.Quu, Qux=s.traj.Qux,
                cost=s.cost, feas=s.feas, max_pconstr=s.max_pconstr,
                max_tconstr=s.max_tconstr, success=s.success, info=s.info)
        return s

    return solve
