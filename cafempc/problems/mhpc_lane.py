"""Lane-form WB-segment batch overrides for the MHPC cascade.

The solver's generic LQ path vmaps per-knot callables over the knot axis,
leaving every WB intermediate [N, ..., 18, 18]-ish.  This module supplies
*batched* problem functions (ProblemFns.*_batch) for the WB segment that:

  * move the knot axis to the lane-minor position and evaluate the
    whole-body dynamics/cost/constraint linearizations in lane form
    (models/wb_lane.py),
  * fold the scenario batch INTO the lane axis under `vmap` via
    jax.custom_batching.custom_vmap (the pattern of
    ops/riccati_sweep.sweep_op), so a B x N batch runs as one
    K = B*N-lane computation,
  * chunk the lane axis (lax.map) above CAFEMPC_LANE_CHUNK lanes so live
    temporaries stay HBM-bounded at the 500-step cascade.

Semantics are identical to the per-knot path (tests/test_mhpc_lane.py
pins parity); the reference correspondence is the same as
mhpc_problem.make_mhpc_fns (MHPCCost.cpp / MHPCConstraint.cpp /
WBM.cpp:459-543 cites there).
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax import custom_batching

from cafempc.models import wb_lane as wl
from cafempc.models.wb_lane import (lanedot, lanemv, laneT, jac_lane)

NQ = 18
XS, US, YS = 36, 12, 12
N_TCON = 4


def _lane_chunk_default():
    """Default bounds the q-tangent FK temporaries ([18, 13, 3, 18, K]
    f32 ~ 100 MB at K=2048).  The chunk size is not measured on the GPU
    yet (ROADMAP, Queue 1)."""
    return int(os.environ.get("CAFEMPC_LANE_CHUNK", "2048")) or None


# ------------------------------------------------------------------
# lane-form cost / constraint pieces (mirror mhpc_problem mode="wb")
# ------------------------------------------------------------------

def _foot_quantities(lm, X):
    """Shared FK bundle: (pf [4,3,K], vf [4,3,K], J [4,3,18,K],
    Jv_q [4,3,18,K] = d(vf)/dq).  XLA CSE dedupes the repeated FK."""
    q, v = X[:NQ], X[NQ:]
    J = wl.foot_jacobians_lane(lm, q)
    pf = wl.foot_positions_lane(lm, q)
    vf = lanemv(J, v)
    Jv_q = jac_lane(lambda q_: wl.foot_velocities_lane(lm, q_, v), q)
    Jv_q = jnp.transpose(Jv_q, (1, 2, 0, 3))               # [4,3,18,K]
    return pf, vf, J, Jv_q


def _zero_pos_cols(J):
    """The reference's zeroed-position-column Jacobian quirk
    (MHPCCost.cpp:54-56): d prel/dq kills the base-translation columns."""
    return jnp.concatenate([jnp.zeros_like(J[:, :, 0:3, :]),
                            J[:, :, 3:, :]], axis=2)


def _foot_cost_value_lane(lm, X, rc, pf_ref, com_ref, vf_ref, w):
    """WBFootPlaceReg + SwingFootPos + SwingFootVel values
    (MHPCCost.cpp:4-62, 129-252), lane form.  Returns [K]."""
    q, v = X[:NQ], X[NQ:]
    pf = wl.foot_positions_lane(lm, q)
    vf = wl.foot_velocities_lane(lm, q, v)
    pcom = X[0:3]
    prel = pf - pcom[None, :, :]
    prel_ref = pf_ref.reshape(4, 3, -1) - com_ref[None, :, :]
    d = prel - prel_ref
    c_st = rc[:, None, :]
    c_sw = 1.0 - c_st
    QF_reg, QF_swp, QF_swv = w
    l = 0.5 * (c_st * d * d * QF_reg[None, :, None]).sum((0, 1))
    l = l + 0.5 * (c_sw * d * d * QF_swp[None, :, None]).sum((0, 1))
    dv = vf - vf_ref.reshape(4, 3, -1)
    l = l + 0.5 * (c_sw * dv * dv * QF_swv[None, :, None]).sum((0, 1))
    return l


def _foot_cost_partials_lane(lm, X, rc, pf_ref, com_ref, vf_ref, w,
                             scale):
    """Gauss-Newton foot-cost partials (mhpc_problem._foot_cost_partials),
    lane form, shared g/h scale [K].  Returns (lx [36,K], lxx [36,36,K])."""
    K = X.shape[-1]
    dtype = X.dtype
    pf, vf, J, Jv_q = _foot_quantities(lm, X)
    Jt = _zero_pos_cols(J)
    pcom = X[0:3]
    prel = pf - pcom[None, :, :]
    prel_ref = pf_ref.reshape(4, 3, K) - com_ref[None, :, :]
    d = prel - prel_ref
    QF_reg, QF_swp, QF_swv = w
    w_pos = rc[:, None, :] * QF_reg[None, :, None] \
        + (1.0 - rc)[:, None, :] * QF_swp[None, :, None]   # [4,3,K]
    lq = jnp.zeros((NQ, K), dtype)
    lqq = jnp.zeros((NQ, NQ, K), dtype)
    for f in range(4):
        lq = lq + lanemv(laneT(Jt[f]), w_pos[f] * d[f])
        wJt = Jt[f] * w_pos[f][:, None, :]
        lqq = lqq + (wJt[:, :, None, :] * Jt[f][:, None, :, :]).sum(0)
    lx = jnp.concatenate([lq, jnp.zeros((NQ, K), dtype)])
    lxx = jnp.pad(lqq, ((0, NQ), (0, NQ), (0, 0)))
    # swing foot velocity tracking on [dvf/dq, dvf/dv] = [Jv_q, J]
    Jfull = jnp.concatenate([Jv_q, J], axis=2)             # [4,3,36,K]
    dv = vf - vf_ref.reshape(4, 3, K)
    w_vel = (1.0 - rc)[:, None, :] * QF_swv[None, :, None]
    for f in range(4):
        lx = lx + lanemv(laneT(Jfull[f]), w_vel[f] * dv[f])
        wJf = Jfull[f] * w_vel[f][:, None, :]
        lxx = lxx + (wJf[:, :, None, :] * Jfull[f][:, None, :, :]).sum(0)
    return lx * scale[None, :], lxx * scale[None, None, :]


# ------------------------------------------------------------------
# lane batch plumbing
# ------------------------------------------------------------------

def _lane_call(core, lane_chunk, *args_T):
    """Run `core(*args_T)` (all args [..., K]) with the lane axis chunked
    via lax.map when K > lane_chunk.  Exact: the pad lanes replicate
    lane 0 and are sliced off."""
    K = jax.tree.leaves(args_T)[0].shape[-1]
    if lane_chunk is None or K <= lane_chunk:
        return core(*args_T)
    nc = -(-K // lane_chunk)
    pad = nc * lane_chunk - K

    def prep(a):
        if pad:
            a = jnp.concatenate(
                [a, jnp.repeat(a[..., :1], pad, axis=-1)], axis=-1)
        a = a.reshape(a.shape[:-1] + (nc, lane_chunk))
        return jnp.moveaxis(a, -2, 0)

    outs = jax.lax.map(lambda ch: core(*ch), jax.tree.map(prep, args_T))

    def post(a):
        a = jnp.moveaxis(a, 0, -2)
        a = a.reshape(a.shape[:-2] + (nc * lane_chunk,))
        return a[..., :K]
    return jax.tree.map(post, outs)


def _to_lane(a):
    """[n, ...] -> [..., n] (knots to lanes)."""
    return jnp.moveaxis(a, 0, -1) if a.ndim > 1 else a


def _from_lane(a):
    """[..., K] -> [K, ...]."""
    return jnp.moveaxis(a, -1, 0) if a.ndim > 1 else a


def _lane_batch(impl_flat):
    """Wrap a knot-batched implementation (leading axis = knots) in a
    custom_vmap that folds an outer scenario batch into the knot axis —
    a B x n call runs as ONE (B*n)-lane computation instead of B
    vmap-replicated n-lane ones."""
    op = custom_batching.custom_vmap(impl_flat)

    @op.def_vmap
    def _rule(axis_size, in_batched, *args):
        B = axis_size
        # in_batched arrives as a list of bools (flat positional args)
        n = None
        for a, b in zip(args, in_batched):
            if b:
                n = a.shape[1]
                break
        assert n is not None, "no batched operand"

        def flat(a, b):
            if not b:
                a = jnp.broadcast_to(a[None], (B,) + a.shape)
            return a.reshape((B * n,) + a.shape[2:])

        fargs = tuple(flat(a, b) for a, b in zip(args, in_batched))
        out = impl_flat(*fargs)
        out_b = jax.tree.map(
            lambda a: a.reshape((B, n) + a.shape[1:]), out)
        return out_b, jax.tree.map(lambda _: True, out)
    return op


def make_wb_lane_batch_fns(cfg, urdf_path=None, lane_chunk=None):
    """Batched WB-segment overrides {dyn_batch, dyn_partials_batch,
    reset_batch, reset_partial_batch, run_cost_batch,
    run_cost_partials_batch, term_cost_batch, term_cost_partials_batch,
    term_con_batch, term_con_partials_batch} for ProblemFns.  `cfg` is
    an MHPCConfig with weights resolved.  lane_chunk overrides the
    CAFEMPC_LANE_CHUNK default (2048; the 500-step cascade measures
    best at 1024)."""
    from cafempc.models import wbm as _wbm
    lm = wl.load_lane_model(urdf_path or _wbm.DEFAULT_URDF)
    lane_chunk = lane_chunk or _lane_chunk_default()
    wb_q = np.asarray(cfg.wb_q, float)
    wb_r = np.asarray(cfg.wb_r, float)
    wb_qf = np.asarray(cfg.wb_qf, float)
    QF = (np.asarray(cfg.qfoot_reg, float),
          np.asarray(cfg.qfoot_swing_pos, float),
          np.asarray(cfg.qfoot_swing_vel, float))
    bg_alpha = float(cfg.BG_alpha)

    def _w(dtype):
        return tuple(jnp.asarray(x, dtype) for x in QF)

    # ---------------- dynamics ------------------------------------
    def dyn_impl(X, U, dt, contact):
        def core(XT, UT, dtT, cT):
            return wl.wb_dynamics_lane(lm, XT, UT, dtT, cT, bg_alpha)
        xnT, grfT = _lane_call(core, lane_chunk,
                               _to_lane(X), _to_lane(U),
                               dt, _to_lane(contact))
        return _from_lane(xnT), _from_lane(grfT)

    dyn_op = _lane_batch(dyn_impl)

    def dyn_batch(X, U, sd):
        return dyn_op(X, U, sd.dt, sd.contact)

    def dyn_partials_impl(X, U, dt, contact):
        def core(XT, UT, dtT, cT):
            return wl.wb_dyn_partials_lane(lm, XT, UT, dtT, cT, bg_alpha)
        A, B, C, D = _lane_call(core, lane_chunk,
                                _to_lane(X), _to_lane(U), dt,
                                _to_lane(contact))
        return (_from_lane(A), _from_lane(B), _from_lane(C),
                _from_lane(D))

    dyn_partials_op = _lane_batch(dyn_partials_impl)

    def dyn_partials_batch(X, U, sd):
        return dyn_partials_op(X, U, sd.dt, sd.contact)

    # ---------------- running cost --------------------------------
    def run_cost_impl(X, U, dt, x_ref, u_ref, rc, pf_ref, com_ref,
                      vf_ref):
        dtype = X.dtype
        q_c = jnp.asarray(wb_q, dtype)
        r_c = jnp.asarray(wb_r, dtype)

        def core(XT, UT, dtT, xrT, urT, rcT, pfT, comT, vfT):
            dx = XT - xrT
            du = UT - urT
            l = 0.5 * (q_c[:, None] * dx * dx).sum(0) \
                + 0.5 * (r_c[:, None] * du * du).sum(0)
            l = l + _foot_cost_value_lane(lm, XT, rcT, pfT, comT, vfT,
                                          _w(dtype))
            return l * dtT
        return _lane_call(core, lane_chunk,
                          _to_lane(X), _to_lane(U), dt, _to_lane(x_ref),
                          _to_lane(u_ref), _to_lane(rc), _to_lane(pf_ref),
                          _to_lane(com_ref), _to_lane(vf_ref))

    run_cost_op = _lane_batch(run_cost_impl)

    def run_cost_batch(X, U, Y, sd):
        return run_cost_op(X, U, sd.dt, sd.x_ref, sd.u_ref,
                           sd.ref_contact, sd.pf_ref, sd.com_ref,
                           sd.vf_ref)

    def run_cost_partials_impl(X, U, dt, x_ref, u_ref, rc, pf_ref,
                               com_ref, vf_ref):
        dtype = X.dtype
        q_c = jnp.asarray(wb_q, dtype)
        r_c = jnp.asarray(wb_r, dtype)
        q_d = np.diag(wb_q)
        r_d = np.diag(wb_r)

        def core(XT, UT, dtT, xrT, urT, rcT, pfT, comT, vfT):
            K = XT.shape[-1]
            dx = XT - xrT
            du = UT - urT
            lx = dtT[None, :] * q_c[:, None] * dx
            lu = dtT[None, :] * r_c[:, None] * du
            lxx = jnp.asarray(q_d[:, :, None], dtype) * dtT[None, None, :]
            luu = jnp.asarray(r_d[:, :, None], dtype) * dtT[None, None, :]
            fx, fxx = _foot_cost_partials_lane(
                lm, XT, rcT, pfT, comT, vfT, _w(dtype), dtT)
            lx = lx + fx
            lxx = lxx + fxx
            lux = jnp.zeros((US, XS, K), dtype)
            ly = jnp.zeros((YS, K), dtype)
            lyy = jnp.zeros((YS, YS, K), dtype)
            return lx, lu, ly, lxx, luu, lux, lyy
        outs = _lane_call(core, lane_chunk,
                          _to_lane(X), _to_lane(U), dt, _to_lane(x_ref),
                          _to_lane(u_ref), _to_lane(rc), _to_lane(pf_ref),
                          _to_lane(com_ref), _to_lane(vf_ref))
        return jax.tree.map(_from_lane, outs)

    run_cost_partials_op = _lane_batch(run_cost_partials_impl)

    def run_cost_partials_batch(X, U, Y, sd):
        return run_cost_partials_op(X, U, sd.dt, sd.x_ref, sd.u_ref,
                                    sd.ref_contact, sd.pf_ref,
                                    sd.com_ref, sd.vf_ref)

    # ---------------- terminal cost -------------------------------
    def term_cost_impl(X, x_ref, rc, pf_ref, com_ref, td_mask):
        dtype = X.dtype
        qf_c = jnp.asarray(wb_qf, dtype)

        def core(XT, xrT, rcT, pfT, comT, tdT):
            dx = XT - xrT
            phi = 0.5 * (qf_c[:, None] * dx * dx).sum(0)
            # WBFootPlaceReg terminal (MHPCCost.cpp:65-86), stance only
            q = XT[:NQ]
            pf = wl.foot_positions_lane(lm, q)
            pcom = XT[0:3]
            d = (pf - pcom[None, :, :]) \
                - (pfT.reshape(4, 3, -1) - comT[None, :, :])
            QF_reg = _w(dtype)[0]
            phi = phi + 0.5 * (rcT[:, None, :] * d * d
                               * QF_reg[None, :, None]).sum((0, 1))
            # TDVelocityPenalty (MHPCCost.cpp:255-291)
            vf = wl.foot_velocities_lane(lm, q, XT[NQ:])
            phi = phi + 0.5 * (tdT * vf[:, 2, :] ** 2).sum(0)
            return phi
        return _lane_call(core, lane_chunk,
                          _to_lane(X), _to_lane(x_ref), _to_lane(rc),
                          _to_lane(pf_ref), _to_lane(com_ref),
                          _to_lane(td_mask))

    term_cost_op = _lane_batch(term_cost_impl)

    def term_cost_batch(X, kd):
        return term_cost_op(X, kd.x_ref, kd.ref_contact, kd.pf_ref,
                            kd.com_ref, kd.td_mask)

    def term_cost_partials_impl(X, x_ref, rc, pf_ref, com_ref, td_mask):
        dtype = X.dtype
        qf_c = jnp.asarray(wb_qf, dtype)
        qf_d = np.diag(wb_qf)

        def core(XT, xrT, rcT, pfT, comT, tdT):
            K = XT.shape[-1]
            dx = XT - xrT
            phix = qf_c[:, None] * dx
            phixx = jnp.broadcast_to(
                jnp.asarray(qf_d[:, :, None], dtype), (XS, XS, K))
            # foot place reg terminal partials, factor-2 quirk
            # (MHPCCost.cpp:89-118)
            pf, vf, J, Jv_q = _foot_quantities(lm, XT)
            Jt = _zero_pos_cols(J)
            pcom = XT[0:3]
            d = (pf - pcom[None, :, :]) \
                - (pfT.reshape(4, 3, K) - comT[None, :, :])
            QF_reg = _w(dtype)[0]
            w_pos = rcT[:, None, :] * QF_reg[None, :, None]
            lq = jnp.zeros((NQ, K), dtype)
            lqq = jnp.zeros((NQ, NQ, K), dtype)
            for f in range(4):
                lq = lq + lanemv(laneT(Jt[f]), w_pos[f] * d[f])
                wJt = Jt[f] * w_pos[f][:, None, :]
                lqq = lqq + (wJt[:, :, None, :]
                             * Jt[f][:, None, :, :]).sum(0)
            phix = phix + jnp.concatenate(
                [2.0 * lq, jnp.zeros((NQ, K), dtype)])
            phixx = phixx + jnp.pad(2.0 * lqq,
                                    ((0, NQ), (0, NQ), (0, 0)))
            # TD velocity penalty rows (MHPCCost.cpp:271-291)
            Jrow = jnp.concatenate([Jv_q[:, 2, :, :], J[:, 2, :, :]],
                                   axis=1)                 # [4,36,K]
            gz = tdT * vf[:, 2, :]
            phix = phix + (gz[:, None, :] * Jrow).sum(0)
            for f in range(4):
                wJr = Jrow[f] * tdT[f][None, :]
                phixx = phixx + wJr[:, None, :] * Jrow[f][None, :, :]
            return phix, phixx
        outs = _lane_call(core, lane_chunk,
                          _to_lane(X), _to_lane(x_ref), _to_lane(rc),
                          _to_lane(pf_ref), _to_lane(com_ref),
                          _to_lane(td_mask))
        return jax.tree.map(_from_lane, outs)

    term_cost_partials_op = _lane_batch(term_cost_partials_impl)

    def term_cost_partials_batch(X, kd):
        return term_cost_partials_op(X, kd.x_ref, kd.ref_contact,
                                     kd.pf_ref, kd.com_ref, kd.td_mask)

    # ---------------- reset (impact + model-switch projection) ----
    # the gathered reset sites were the round-4 trace's top cost: the
    # per-site vmap ran batch-first [B, n_sites, 18, 18] Cholesky
    # custom-calls (9.5x tile padding) for every line-search trial
    from cafempc.problems.mhpc_problem import BODY_MASK36

    def _reset_masks(contact, contact_next, model_switch, dtype):
        imp_mask = (1.0 - contact) * contact_next          # [4, K]
        has_imp = (jnp.max(contact_next - contact, axis=0)
                   > 0.5).astype(dtype)                    # [K]
        return imp_mask, has_imp, model_switch

    def reset_impl(X, contact, contact_next, model_switch):
        dtype = X.dtype
        bm = jnp.asarray(BODY_MASK36[:, None], dtype)

        def core(XT, cT, cnT, msT):
            q, v = XT[:NQ], XT[NQ:]
            imp_mask, has_imp, ms = _reset_masks(cT, cnT, msT, dtype)
            v_post, _ = wl.impulse_dynamics_lane(lm, q, v, imp_mask)
            xr = jnp.concatenate(
                [q, jnp.where(has_imp[None, :] > 0, v_post, v)])
            return jnp.where(msT[None, :] > 0, xr * bm, xr)
        return _from_lane(_lane_call(core, lane_chunk, _to_lane(X),
                                     _to_lane(contact),
                                     _to_lane(contact_next),
                                     model_switch))

    reset_op = _lane_batch(reset_impl)

    def reset_batch(X, sd):
        return reset_op(X, sd.contact, sd.contact_next, sd.model_switch)

    def reset_partial_impl(X, contact, contact_next, model_switch):
        dtype = X.dtype
        bm = jnp.asarray(BODY_MASK36[:, None, None], dtype)

        def core(XT, cT, cnT, msT):
            K = XT.shape[-1]
            q, v = XT[:NQ], XT[NQ:]
            imp_mask, has_imp, ms = _reset_masks(cT, cnT, msT, dtype)
            dvq, dvv = wl.impulse_dynamics_partials_lane(lm, q, v,
                                                         imp_mask)
            I = jnp.broadcast_to(jnp.eye(NQ, dtype=dtype)[:, :, None],
                                 (NQ, NQ, K))
            Z = jnp.zeros((NQ, NQ, K), dtype)
            P_imp = jnp.concatenate([
                jnp.concatenate([I, Z], axis=1),
                jnp.concatenate([dvq, dvv], axis=1)], axis=0)
            I36 = jnp.broadcast_to(
                jnp.eye(XS, dtype=dtype)[:, :, None], (XS, XS, K))
            P = jnp.where(has_imp[None, None, :] > 0, P_imp, I36)
            return jnp.where(msT[None, None, :] > 0, bm * P, P)
        return _from_lane(_lane_call(core, lane_chunk, _to_lane(X),
                                     _to_lane(contact),
                                     _to_lane(contact_next),
                                     model_switch))

    reset_partial_op = _lane_batch(reset_partial_impl)

    def reset_partial_batch(X, sd):
        return reset_partial_op(X, sd.contact, sd.contact_next,
                                sd.model_switch)

    # ---------------- terminal constraint (WBTouchDown) -----------
    def term_con_impl(X):
        def core(XT):
            return wl.foot_positions_lane(lm, XT[:NQ])[:, 2, :]
        return _from_lane(_lane_call(core, lane_chunk,
                                     _to_lane(X)))

    term_con_op = _lane_batch(term_con_impl)

    def term_con_batch(X, kd):
        return term_con_op(X)

    def term_con_partials_impl(X):
        def core(XT):
            K = XT.shape[-1]
            J = wl.foot_jacobians_lane(lm, XT[:NQ])
            return jnp.concatenate(
                [J[:, 2, :, :], jnp.zeros((4, NQ, K), XT.dtype)], axis=1)
        return _from_lane(_lane_call(core, lane_chunk,
                                     _to_lane(X)))

    term_con_partials_op = _lane_batch(term_con_partials_impl)

    def term_con_partials_batch(X, kd):
        return term_con_partials_op(X)

    return dict(
        dyn_batch=dyn_batch,
        dyn_partials_batch=dyn_partials_batch,
        reset_batch=reset_batch,
        reset_partial_batch=reset_partial_batch,
        run_cost_batch=run_cost_batch,
        run_cost_partials_batch=run_cost_partials_batch,
        term_cost_batch=term_cost_batch,
        term_cost_partials_batch=term_cost_partials_batch,
        term_con_batch=term_con_batch,
        term_con_partials_batch=term_con_partials_batch)
