"""MHPC cascaded-fidelity problem: whole-body front horizon + SRB tail.

Functional mirror of the reference MHPC application layer
(MHPC/MHPC-Trajopt/MHPCProblem.{h,cpp}, MHPCCost.*, MHPCConstraint.*,
MHPCReset.*, MHPCFootStep.h):

  * phase discovery over [0, plan_dur_wb] at dt_wb + one SRB tail phase
    at dt_srb (MHPCProblem.cpp:89-146),
  * cascade realized on ONE static state lane: the 12-dim SRB state is
    embedded in the 36-dim WB layout (pos,eul -> dims 0:6; vel,eulrate ->
    dims 18:24; qJ/qJd dims masked dead).  The reference's 12x36
    StateProjection (MHPCReset.h:20-26) becomes a diagonal body-mask
    applied at the model-switch reset step — no heterogeneous phase types,
  * WB costs: tracking, foot-place reg, swing pos/vel tracking, TD velocity
    penalty (MHPCCost.cpp); SRB tracking cost,
  * WB path constraints: torque limit (+-17), joint limit, min height
    (0.20), GRF friction pyramid (mu 0.6) on the GRF output y; SRB: min
    height (0.18) (MHPCConstraint.cpp),
  * reset: impact at touchdown, projection at model switch
    (MHPCReset.cpp:4-53); SRB foot positions come from the reference
    placements (MHPCFootStep.h:59-65).
"""
import dataclasses
import json
import os
import re

import numpy as np
import jax
import jax.numpy as jnp

from cafempc.models import rbda, srb, wbm
from cafempc.reference.quad_reference import (
    QuadReference, srb_state_ref_at, wb_state_ref_at)
from cafempc.solver.hsddp import ProblemFns, SegmentedFns
from cafempc.solver.plan import (KnotData, KnotPlan, PenaltyParams,
                                 StepData)

XS, US, YS = 36, 12, 12
# path-constraint layout:
# [torque(24) | joint(24) | minheight(1) | grf(20) | jointspeed(24)]
N_PCON = 93
N_TCON = 4
TORQUE_LIMIT = 17.0                  # MHPCConstraint.cpp:77
JOINT_SPEED_LIMIT = 20.0             # MHPCConstraint.h:72-73 (+-20 rad/s)
JOINT_LB = np.array([-1.3, -5.0, -np.pi])   # MHPCConstraint.cpp:172
JOINT_UB = np.array([1.3, 5.0, np.pi])
MIN_HEIGHT_WB = 0.20                 # MHPCConstraint.h (WBMinimumHeight)
MIN_HEIGHT_SRB = 0.18                # MHPCConstraint.h (SRBMMinimumHeight)
MU_WB = 0.6                          # MHPCConstraint.cpp:11

# embedding masks: SRB dims within the 36-dim WB layout
BODY_DIMS = np.r_[0:6, 18:24]
BODY_MASK36 = np.zeros(36)
BODY_MASK36[BODY_DIMS] = 1.0


@dataclasses.dataclass
class MHPCConfig:
    """(MHPC/settings/mhpc_config.info, MHPCProblem.h:24-83)."""
    plan_dur_wb: float = 0.25
    plan_dur_srb: float = 0.50
    dt_mpc: float = 0.02
    dt_wb: float = 0.01
    dt_srb: float = 0.05
    BG_alpha: float = 10.0
    n_steps_max: int = 48
    # static step index where the SRB tail segment begins (carry-pad
    # layout, see build_mhpc_plan); must exceed the max WB content length
    # (25 dyn steps + intra-WB resets + 1 model-switch reset)
    wb_block: int = 32
    # cost weights (cost_weights_*.JSON); None -> constructor defaults
    wb_q: np.ndarray = None
    wb_r: np.ndarray = None
    wb_qf: np.ndarray = None
    srb_q: np.ndarray = None
    srb_r: np.ndarray = None
    srb_qf: np.ndarray = None
    qfoot_reg: np.ndarray = None
    qfoot_swing_pos: np.ndarray = None
    qfoot_swing_vel: np.ndarray = None
    # constraint params (constraint_params_*.info)
    reb: dict = None
    td_al_sigma: float = 10.0
    td_al_sigma_max: float = 1e4
    td_al_lambda: float = 0.0
    # JointSpeedLimit (MHPCConstraint.cpp:118-160): compiled but disabled
    # by default in the reference -> flag-gated off here too
    joint_speed_limit: bool = False
    # which path constraints are armed: "regular" = torque + joint box +
    # min height + GRF (MHPCProblem.cpp:428-481); "loco" = torque + GRF
    # only (LocoProblem.cpp:66-89)
    pcon_set: str = "regular"
    # file names from the config .info (referenceFile/costFile/...)
    reference_file: str = ""
    cost_file: str = ""
    constraint_file: str = ""


def _default_weights(cfg: MHPCConfig):
    """Constructor defaults (MHPCCost.h:12-38, 226-249)."""
    if cfg.wb_q is None:
        cfg.wb_q = np.concatenate([
            [0.0, 0.0, 50.0], [2.0, 10.0, 5.0], np.ones(12),
            [2.0, 4.0, 4.0], [1.0, 2.0, 2.0], 0.01 * np.ones(12)])
    if cfg.wb_r is None:
        cfg.wb_r = 0.1 * np.ones(12)
    if cfg.wb_qf is None:
        qf = cfg.wb_q.copy()
        qf[6:18] = 0.5
        qf[24:36] = 0.01
        cfg.wb_qf = qf
    if cfg.srb_q is None:
        cfg.srb_q = np.concatenate([
            [0.0, 0.0, 50.0], [0.0, 10.0, 5.0], [2.0, 3.0, 3.0],
            [0.5, 0.5, 0.5]])
    if cfg.srb_r is None:
        cfg.srb_r = 0.01 * np.ones(12)
    if cfg.srb_qf is None:
        cfg.srb_qf = 0.5 * cfg.srb_q
    if cfg.qfoot_reg is None:
        cfg.qfoot_reg = np.array([10.0, 10.0, 1.0])
    if cfg.qfoot_swing_pos is None:
        cfg.qfoot_swing_pos = np.array([10.0, 10.0, 40.0])
    if cfg.qfoot_swing_vel is None:
        cfg.qfoot_swing_vel = np.array([2.0, 2.0, 4.0])
    if cfg.reb is None:
        cfg.reb = {
            "GRF": dict(delta=0.1, delta_min=0.1, eps=0.3),
            "Torque": dict(delta=0.1, delta_min=0.1, eps=0.1),
            "Joint": dict(delta=0.1, delta_min=0.1, eps=0.1),
            "MinHeight": dict(delta=0.01, delta_min=0.01, eps=0.1),
        }
    return cfg


def load_mhpc_config(fname) -> MHPCConfig:
    txt = open(fname).read()
    body = re.search(r"config\s*\{(.*?)\}", txt, re.S).group(1)
    kv = dict(ln.split()[:2] for ln in body.splitlines() if ln.split())
    cfg = MHPCConfig(
        plan_dur_wb=float(kv.get("plan_dur_wb", 0.25)),
        plan_dur_srb=float(kv.get("plan_dur_srb", 0.50)),
        dt_mpc=float(kv.get("dt_mpc", 0.02)),
        dt_wb=float(kv.get("dt_wb", 0.01)),
        dt_srb=float(kv.get("dt_srb", 0.05)),
        BG_alpha=float(kv.get("BG_alpha", 10.0)),
        reference_file=kv.get("referenceFile", ""),
        cost_file=kv.get("costFile", ""),
        constraint_file=kv.get("constraintParamFile", ""))
    return _default_weights(cfg)


def load_cost_weights(fname, cfg: MHPCConfig) -> MHPCConfig:
    """JSON loader (MHPCCostUtil.h:9-143 layout)."""
    d = json.load(open(fname))
    wb = d["WB_Tracking_Cost"]
    cfg.wb_q = np.concatenate([
        wb["qw_qB"], np.tile(wb["qw_qJ"], 4), wb["qw_vB"],
        np.tile(wb["qw_vJ"], 4)])
    cfg.wb_r = np.full(12, float(wb["rw"]))
    cfg.wb_qf = np.concatenate([
        wb["qfw_qB"], np.tile(wb["qfw_qJ"], 4), wb["qfw_vB"],
        np.tile(wb["qfw_vJ"], 4)])
    sb = d["SRB_Tracking_Cost"]
    cfg.srb_q = np.concatenate([sb["qw_qB"], sb["qw_vB"]])
    cfg.srb_r = np.full(12, float(sb["rw"]))
    cfg.srb_qf = np.concatenate([sb["qfw_qB"], sb["qfw_vB"]])
    cfg.qfoot_reg = np.asarray(d["WB_FootPlace_Reg"]["qw_per_foot"],
                               dtype=float)
    cfg.qfoot_swing_pos = np.asarray(
        d["Swing_Pos_Tracking"]["qw_per_foot"], dtype=float)
    cfg.qfoot_swing_vel = np.asarray(
        d["Swing_Vel_Tracking"]["qw_per_foot"], dtype=float)
    return cfg


def load_constraint_params(fname, cfg: MHPCConfig) -> MHPCConfig:
    txt = open(fname).read()

    def block(name):
        m = re.search(name + r"_ReB\s*\{(.*?)\}", txt, re.S)
        out = {}
        if m:
            for ln in m.group(1).splitlines():
                p = ln.split()
                if len(p) == 2:
                    out[p[0]] = float(p[1])
        return out

    cfg.reb = {k: block(k) or cfg.reb[k]
               for k in ("GRF", "Torque", "Joint", "MinHeight")}
    m = re.search(r"TD_AL\s*\{(.*?)\}", txt, re.S)
    if m:
        kv = dict((ln.split()[0], float(ln.split()[1]))
                  for ln in m.group(1).splitlines() if len(ln.split()) == 2)
        cfg.td_al_sigma = kv.get("sigma", cfg.td_al_sigma)
        cfg.td_al_sigma_max = kv.get("sigma_max", cfg.td_al_sigma_max)
        cfg.td_al_lambda = kv.get("lambda", cfg.td_al_lambda)
    return cfg


# ------------------------------------------------------------------
# Plan construction
# ------------------------------------------------------------------

def embed_srb(x12):
    x = np.zeros(36)
    x[BODY_DIMS] = x12
    return x


def discover_wb_phases(quad_ref: QuadReference, plan_dur_wb, dt):
    """(MHPCProblem.cpp:106-137)."""
    phases = []
    t = 0.0
    c_prev = np.array(quad_ref.contact_at_t(0.0))
    start = 0.0
    eps = 1e-6
    while t <= plan_dur_wb + eps:
        c = np.array(quad_ref.contact_at_t(t))
        if (c != c_prev).any() or abs(t - plan_dur_wb) < eps:
            horizon = int(round((t - start) / dt))
            if horizon > 0:
                phases.append((start, t, horizon, c_prev.copy()))
            c_prev = c
            start = t
        t += dt
    return phases


def build_mhpc_plan(quad_ref: QuadReference, cfg: MHPCConfig):
    """Flat cascaded plan.  Returns (plan, pen, Xbar0, Ubar0, meta)."""
    cfg = _default_weights(cfg)
    N = cfg.n_steps_max
    wb_phases = discover_wb_phases(quad_ref, cfg.plan_dur_wb, cfg.dt_wb)
    n_wb = len(wb_phases)
    srb_horizon = int(round(cfg.plan_dur_srb / cfg.dt_srb))
    contact_after_wb = np.array(
        quad_ref.contact_at_t(cfg.plan_dur_wb + cfg.dt_mpc))

    step = dict(
        active=np.zeros(N), is_reset=np.zeros(N), dt=np.full(N, cfg.dt_wb),
        t=np.zeros(N), contact=np.zeros((N, 4)),
        contact_next=np.zeros((N, 4)), x_ref=np.zeros((N, XS)),
        u_ref=np.zeros((N, US)), y_ref=np.zeros((N, YS)),
        pf_ref=np.zeros((N, 12)), com_ref=np.zeros((N, 3)),
        vf_ref=np.zeros((N, 12)), ref_contact=np.zeros((N, 4)),
        model_id=np.zeros(N), model_switch=np.zeros(N),
        q_diag=np.zeros((N, 0)), r_diag=np.zeros((N, 0)))
    knot = dict(
        active=np.zeros(N + 1), is_terminal=np.zeros(N + 1),
        td_mask=np.zeros((N + 1, 4)), contact=np.zeros((N + 1, 4)),
        ref_contact=np.zeros((N + 1, 4)), model_id=np.zeros(N + 1),
        qf_diag=np.zeros((N + 1, 0)),
        x_ref=np.zeros((N + 1, XS)), pf_ref=np.zeros((N + 1, 12)),
        com_ref=np.zeros((N + 1, 3)), t=np.zeros(N + 1))
    Xbar0 = np.zeros((N + 1, XS))
    Ubar0 = np.zeros((N, US))

    j = 0

    def fill_step(j, t, dt, contact, model_id):
        rec = quad_ref.record_at_t(t)
        step["t"][j] = t
        step["dt"][j] = dt
        step["contact"][j] = contact
        step["ref_contact"][j] = rec["contact"]
        step["model_id"][j] = model_id
        step["pf_ref"][j] = rec["foot_placements"]
        step["com_ref"][j] = rec["body_state"][0:3]
        step["vf_ref"][j] = rec["foot_velocities"]
        if model_id == 0:
            step["x_ref"][j] = wb_state_ref_at(quad_ref, t)
            step["u_ref"][j] = rec["torque"]
            step["y_ref"][j] = rec["grf"]
        else:
            step["x_ref"][j] = embed_srb(srb_state_ref_at(quad_ref, t))
            step["u_ref"][j] = rec["grf"]

    def fill_knot(j, t, contact, model_id):
        rec = quad_ref.record_at_t(t)
        knot["active"][j] = 1.0
        knot["t"][j] = t
        knot["contact"][j] = contact
        knot["ref_contact"][j] = rec["contact"]
        knot["model_id"][j] = model_id
        knot["pf_ref"][j] = rec["foot_placements"]
        knot["com_ref"][j] = rec["body_state"][0:3]
        if model_id == 0:
            knot["x_ref"][j] = wb_state_ref_at(quad_ref, t)
        else:
            knot["x_ref"][j] = embed_srb(srb_state_ref_at(quad_ref, t))

    for ip, (ts, te, hor, contact) in enumerate(wb_phases):
        for k in range(hor):
            t = ts + k * cfg.dt_wb
            step["active"][j] = 1.0
            fill_step(j, t, cfg.dt_wb, contact, 0)
            fill_knot(j, t, contact, 0)
            Xbar0[j] = wb_state_ref_at(quad_ref, t)
            j += 1
        # phase-terminal knot
        fill_knot(j, te, contact, 0)
        knot["is_terminal"][j] = 1.0
        Xbar0[j] = wb_state_ref_at(quad_ref, te)
        contact_next = (wb_phases[ip + 1][3] if ip + 1 < n_wb
                        else contact_after_wb)
        knot["td_mask"][j] = ((contact == 0) & (contact_next == 1)) \
            .astype(float)
        # reset step (to next WB phase, or into the SRB tail); the last WB
        # phase gets no reset when there is no SRB tail (plan_dur_srb = 0,
        # the reference's testSRBPlanning / WB-only configuration)
        is_last_wb = ip + 1 >= n_wb
        if is_last_wb and srb_horizon == 0:
            break
        if is_last_wb:
            # Static-layout padding: identity carry-pad reset steps up to
            # the segment boundary so the SRB tail always starts at step
            # wb_block (contact_next == contact -> identity reset; the
            # backward sweep's transform branch carries (G, H) through
            # unchanged).  Then the WB->SRB model-switch reset at
            # wb_block-1.
            assert j <= cfg.wb_block - 1, \
                (f"WB content ({j} steps) exceeds wb_block-1 "
                 f"({cfg.wb_block - 1}); raise MHPCConfig.wb_block")
            while j < cfg.wb_block - 1:
                step["active"][j] = 1.0
                step["is_reset"][j] = 1.0
                fill_step(j, te, cfg.dt_wb, contact, 0)
                step["contact_next"][j] = contact
                j += 1
                fill_knot(j, te, contact, 0)
                Xbar0[j] = wb_state_ref_at(quad_ref, te)
            step["active"][j] = 1.0
            step["is_reset"][j] = 1.0
            fill_step(j, te, cfg.dt_wb, contact, 0)
            step["contact_next"][j] = contact_next
            step["model_switch"][j] = 1.0
            j += 1
        else:
            step["active"][j] = 1.0
            step["is_reset"][j] = 1.0
            fill_step(j, te, cfg.dt_wb, contact, 0)
            step["contact"][j] = contact
            step["contact_next"][j] = contact_next
            j += 1

    # SRB tail phase
    if srb_horizon > 0:
        assert j == cfg.wb_block, (j, cfg.wb_block)
        srb_t0 = cfg.plan_dur_wb
        for k in range(srb_horizon):
            t = srb_t0 + k * cfg.dt_srb
            step["active"][j] = 1.0
            fill_step(j, t, cfg.dt_srb, np.zeros(4), 1)
            fill_knot(j, t, np.zeros(4), 1)
            Xbar0[j] = embed_srb(srb_state_ref_at(quad_ref, t))
            j += 1
        t_end = srb_t0 + srb_horizon * cfg.dt_srb
        fill_knot(j, t_end, np.zeros(4), 1)
        knot["is_terminal"][j] = 1.0
        Xbar0[j] = embed_srb(srb_state_ref_at(quad_ref, t_end))

    n_knots = j + 1
    assert n_knots <= N + 1, (n_knots, N)
    Xbar0[n_knots:] = Xbar0[n_knots - 1]
    plan = KnotPlan(StepData(**step), KnotData(**knot))

    # ---- penalty params -------------------------------------------
    reb_delta = np.ones((N, N_PCON))
    reb_eps = np.zeros((N, N_PCON))
    reb_active = np.zeros((N, N_PCON))
    reb_delta_min = np.ones(N_PCON)
    blocks = [("Torque", slice(0, 24)), ("Joint", slice(24, 48)),
              ("MinHeight", slice(48, 49)), ("GRF", slice(49, 69)),
              ("JointSpeed", slice(69, 93))]
    for name, sl in blocks:
        p = cfg.reb.get(name, dict(delta=0.1, delta_min=0.1, eps=0.1))
        reb_delta[:, sl] = p["delta"]
        reb_delta_min[sl] = p["delta_min"]
        reb_eps[:, sl] = p["eps"]
    for k in range(N):
        if not step["active"][k] or step["is_reset"][k]:
            continue
        if step["model_id"][k] == 0:
            if cfg.pcon_set == "loco":
                # LocoProblem arms only torque + GRF (LocoProblem.cpp:66-89)
                reb_active[k, 0:24] = 1.0
            else:
                reb_active[k, 0:49] = 1.0
            if cfg.joint_speed_limit:
                reb_active[k, 69:93] = 1.0
            for leg in range(4):
                reb_active[k, 49 + 5 * leg:54 + 5 * leg] = \
                    step["contact"][k][leg]
        else:
            reb_active[k, 48] = 1.0   # SRB min height only

    al_active = knot["td_mask"] * knot["is_terminal"][:, None]
    pen = PenaltyParams(
        reb_delta=reb_delta, reb_eps=reb_eps, reb_active=reb_active,
        reb_delta_min=reb_delta_min,
        al_lambda=np.full((N + 1, N_TCON), cfg.td_al_lambda),
        al_sigma=np.full((N + 1, N_TCON), cfg.td_al_sigma),
        al_active=al_active,
        al_sigma_max=np.asarray(cfg.td_al_sigma_max))

    meta = dict(wb_phases=wb_phases, srb_horizon=srb_horizon,
                n_knots=n_knots, contact_after_wb=contact_after_wb,
                wb_block=cfg.wb_block)
    return plan, pen, Xbar0, Ubar0, meta


# ------------------------------------------------------------------
# Problem functions
# ------------------------------------------------------------------

def _srb_embedded_step(x, u, dt, pf_ref, ref_contact):
    x12 = x[BODY_DIMS]
    xdot12 = srb.dynamics_continuous(x12, u, pf_ref, ref_contact)
    xn12 = x12 + dt * xdot12
    xn = jnp.zeros(36, x.dtype)
    xn = xn.at[jnp.asarray(BODY_DIMS)].set(xn12)
    return xn


def apply_transition_foot_handoff(plan_np, cfg: MHPCConfig, x_transition,
                                  model=None, ground_height=0.0):
    """Transition-frozen foot handoff for the SRB tail
    (MHPCFootStep.h:26-57, updateFootPosAtTransition/updateFootPositions):
    feet in contact at the WB->SRB handoff keep the ACTUAL (solved) WB foot
    XY — frozen while the foot remains continuously in contact — instead
    of the reference placement; z is the ground height.  Mutates
    plan_np.step.pf_ref in place on the SRB steps.

    NOTE: the reference computes this but its getFootPositions currently
    returns reference placements anyway (MHPCFootStep.h:59-65) — so this
    is opt-in (MHPCRuntime(foot_handoff=True)) to keep default behavior
    reference-exact.
    """
    if model is None:
        model = wbm.load_model()
    pf = np.asarray(wbm.foot_positions(model, jnp.asarray(x_transition)))
    step = plan_np.step
    N = step.active.shape[0]
    frozen = None
    for k in range(cfg.wb_block, N):
        if step.active[k] < 1 or step.model_id[k] != 1:
            continue
        rc = np.asarray(step.ref_contact[k])
        if frozen is None:
            frozen = rc > 0        # feet in contact at the handoff
        for leg in range(4):
            if frozen[leg] and rc[leg] > 0:
                step.pf_ref[k][3 * leg:3 * leg + 2] = pf[leg][:2]
                step.pf_ref[k][3 * leg + 2] = ground_height
            else:
                frozen[leg] = False   # contact broke: reference placements
    return plan_np


def make_mhpc_fns(cfg: MHPCConfig, model=None, mode="joint",
                  urdf=wbm.DEFAULT_URDF, lane_chunk=None) -> ProblemFns:
    """Problem functions for the cascade.

    mode="joint": every callable handles both models via a model_id
    where-select (evaluates BOTH branches on every knot — correct but
    wasteful).  mode="wb"/"srb": single-model callables for the segmented
    solver (SegmentedFns), which restricts each model's evaluation to its
    own static step range — the reference's per-phase LQ touches only its
    own model (SinglePhase.cpp:265-320).

    In mode="wb" the returned fns also carry lane-form batch overrides
    (problems/mhpc_lane.py) that evaluate the WB linearizations with the
    scenario x knot axis lane-minor — disable with CAFEMPC_WB_LANE=0.
    `urdf` selects the robot (must match `model` when both are given).
    """
    model_given = model is not None
    if model is None and mode != "srb":
        model = wbm.load_model(urdf)
    cfg = _default_weights(cfg)
    wb_q = jnp.asarray(cfg.wb_q)
    wb_r = jnp.asarray(cfg.wb_r)
    wb_qf = jnp.asarray(cfg.wb_qf)
    srb_q36 = jnp.zeros(36).at[jnp.asarray(BODY_DIMS)].set(
        jnp.asarray(cfg.srb_q))
    srb_qf36 = jnp.zeros(36).at[jnp.asarray(BODY_DIMS)].set(
        jnp.asarray(cfg.srb_qf))
    srb_r = jnp.asarray(cfg.srb_r)
    QF_reg = jnp.asarray(cfg.qfoot_reg)
    QF_swp = jnp.asarray(cfg.qfoot_swing_pos)
    QF_swv = jnp.asarray(cfg.qfoot_swing_vel)
    body_mask = jnp.asarray(BODY_MASK36)

    # ---------------- dynamics / reset ----------------------------
    def dyn_wb(x, u, sd):
        return wbm.dynamics(model, x, u, sd.dt, sd.contact, cfg.BG_alpha)

    def dyn_srb(x, u, sd):
        xn = _srb_embedded_step(x, u, sd.dt, sd.pf_ref, sd.ref_contact)
        return xn, jnp.zeros(YS, x.dtype)

    if mode == "wb":
        dyn = dyn_wb
    elif mode == "srb":
        dyn = dyn_srb
    else:
        def dyn(x, u, sd):
            xn_wb, grf = dyn_wb(x, u, sd)
            xn_srb, _ = dyn_srb(x, u, sd)
            wb = sd.model_id == 0
            xn = jnp.where(wb, xn_wb, xn_srb)
            y = jnp.where(wb, grf, jnp.zeros_like(grf))
            return xn, y

    if mode == "srb":
        bd = jnp.asarray(BODY_DIMS)

        def dyn_partials(x, u, sd):
            """SRB Jacobians on the 12-dim core, embedded at the body dims
            of the 36-lane (reference SRBM.h:66-75 + StateProjection)."""
            x12 = x[bd]
            A12, B12 = srb.dynamics_partials(x12, u, sd.pf_ref,
                                             sd.ref_contact, sd.dt)
            A = jnp.zeros((XS, XS), x.dtype) \
                .at[bd[:, None], bd[None, :]].set(A12)
            B = jnp.zeros((XS, US), x.dtype).at[bd, :].set(B12)
            C = jnp.zeros((YS, XS), x.dtype)
            D = jnp.zeros((YS, US), x.dtype)
            return A, B, C, D

        def reset(x, sd):
            return x

        def reset_partial(x, sd):
            return jnp.eye(XS, dtype=x.dtype)
    else:
        use_ad = os.environ.get("CAFEMPC_WB_AD_PARTIALS", "0") == "1"

        if mode == "wb" and not use_ad:
            def dyn_partials(x, u, sd):
                """Factored-KKT analytic assembly (the reference's
                WBM.cpp:459-505 structure): 18 q-tangents instead of
                jacfwd's 48, no tangents through the contact solve."""
                return wbm.dynamics_partials_analytic(
                    model, x, u, sd.dt, sd.contact, cfg.BG_alpha)
        else:
            def dyn_partials(x, u, sd):
                (A, B), (C, D) = jax.jacfwd(
                    lambda x_, u_: dyn(x_, u_, sd), argnums=(0, 1))(x, u)
                return A, B, C, D

        def reset(x, sd):
            """(MHPCReset.cpp:4-28): impact on new contacts, then the
            WB->SRB body-mask projection at the model switch."""
            ximp, _ = wbm.impact(model, x, sd.contact, sd.contact_next)
            has_impact = jnp.any(
                (sd.contact_next - sd.contact) > 0.5)
            xr = jnp.where(has_impact, ximp, x)
            return jnp.where(sd.model_switch > 0, xr * body_mask, xr)

        if use_ad:
            def reset_partial(x, sd):
                return jax.jacfwd(lambda x_: reset(x_, sd))(x)
        else:
            def reset_partial(x, sd):
                """Impact Jacobian from the factored impulse KKT
                (WBM.cpp:508-543) + the diagonal model-switch projection."""
                P_imp = wbm.impact_partial_analytic(
                    model, x, sd.contact, sd.contact_next)
                has_impact = jnp.any((sd.contact_next - sd.contact) > 0.5)
                P = jnp.where(has_impact, P_imp,
                              jnp.eye(XS, dtype=x.dtype))
                return jnp.where(sd.model_switch > 0,
                                 body_mask[:, None].astype(x.dtype) * P, P)

    # ---------------- costs ---------------------------------------
    def _foot_cost_terms(x, sd_or_kd, dt_scale):
        """WBFootPlaceReg (stance) + SwingFootPos + SwingFootVel
        (MHPCCost.cpp:4-62, 129-252).  Returns scalar cost."""
        pcom = x[0:3]
        pf = wbm.foot_positions(model, x)
        vf = wbm.foot_velocities(model, x)
        rc = sd_or_kd.ref_contact
        prel = pf - pcom[None, :]
        prel_ref = sd_or_kd.pf_ref.reshape(4, 3) \
            - sd_or_kd.com_ref[None, :]
        d = prel - prel_ref
        c_st = rc
        c_sw = 1.0 - rc
        l = 0.5 * jnp.sum(c_st[:, None] * d * d * QF_reg[None, :])
        l = l + 0.5 * jnp.sum(c_sw[:, None] * d * d * QF_swp[None, :])
        dv = vf - sd_or_kd.vf_ref.reshape(4, 3)
        l = l + 0.5 * jnp.sum(c_sw[:, None] * dv * dv * QF_swv[None, :])
        return l * dt_scale

    def _run_cost_wb(x, u, sd):
        dx = x - sd.x_ref
        du = u - sd.u_ref
        l = 0.5 * jnp.sum(wb_q * dx * dx) + 0.5 * jnp.sum(wb_r * du * du)
        return l + _foot_cost_terms(x, sd, 1.0)

    def _run_cost_srb(x, u, sd):
        dx = x - sd.x_ref
        du = u - sd.u_ref
        return 0.5 * jnp.sum(srb_q36 * dx * dx) \
            + 0.5 * jnp.sum(srb_r * du * du)

    if mode == "wb":
        def run_cost(x, u, y, sd):
            return _run_cost_wb(x, u, sd) * sd.dt
    elif mode == "srb":
        def run_cost(x, u, y, sd):
            return _run_cost_srb(x, u, sd) * sd.dt
    else:
        def run_cost(x, u, y, sd):
            wb = sd.model_id == 0
            return jnp.where(wb, _run_cost_wb(x, u, sd),
                             _run_cost_srb(x, u, sd)) * sd.dt

    def _foot_cost_partials(x, sd_or_kd, scale_g, scale_h):
        """Gauss-Newton partials of the foot terms with the reference's
        zeroed-position-column Jacobian quirk (MHPCCost.cpp:54-56)."""
        pcom = x[0:3]
        pf = wbm.foot_positions(model, x)
        vf = wbm.foot_velocities(model, x)
        J = wbm.foot_jacobians(model, x)          # [4,3,18] d pf/dq
        Jt = J.at[:, :, 0:3].set(0.0)             # d prel/dq
        rc = sd_or_kd.ref_contact
        prel = pf - pcom[None, :]
        prel_ref = sd_or_kd.pf_ref.reshape(4, 3) \
            - sd_or_kd.com_ref[None, :]
        d = prel - prel_ref
        w_pos = rc[:, None] * QF_reg[None, :] \
            + (1.0 - rc)[:, None] * QF_swp[None, :]
        lq = jnp.einsum("fij,fi->j", Jt, w_pos * d)
        lqq = jnp.einsum("fij,fi,fik->jk", Jt, w_pos, Jt)
        lx = jnp.zeros(36, x.dtype).at[0:18].set(scale_g * lq)
        lxx = jnp.zeros((36, 36), x.dtype).at[0:18, 0:18].set(
            scale_h * lqq)
        # swing foot velocity tracking: J_full = [dvf/dq, dvf/dv]
        Jv_q = wbm.foot_vel_dq(model, x)          # [4,3,18]
        dv = vf - sd_or_kd.vf_ref.reshape(4, 3)
        w_vel = (1.0 - rc)[:, None] * QF_swv[None, :]
        Jfull = jnp.concatenate([Jv_q, J], axis=2)    # [4,3,36]
        lx = lx + scale_g * jnp.einsum("fij,fi->j", Jfull, w_vel * dv)
        lxx = lxx + scale_h * jnp.einsum("fij,fi,fik->jk", Jfull, w_vel,
                                         Jfull)
        return lx, lxx

    def run_cost_partials(x, u, y, sd):
        wb = sd.model_id == 0
        dx = x - sd.x_ref
        du = u - sd.u_ref
        if mode == "wb":
            q, r = wb_q, wb_r
        elif mode == "srb":
            q, r = srb_q36, srb_r
        else:
            q = jnp.where(wb, wb_q, srb_q36)
            r = jnp.where(wb, wb_r, srb_r)
        lx = sd.dt * q * dx
        lu = sd.dt * r * du
        lxx = sd.dt * jnp.diag(q)
        luu = sd.dt * jnp.diag(r)
        lux = jnp.zeros((US, XS), x.dtype)
        if mode != "srb":
            fx, fxx = _foot_cost_partials(x, sd, sd.dt, sd.dt)
            if mode == "wb":
                lx = lx + fx
                lxx = lxx + fxx
            else:
                lx = lx + jnp.where(wb, fx, 0.0)
                lxx = lxx + jnp.where(wb, fxx, 0.0)
        ly = jnp.zeros(YS, x.dtype)
        lyy = jnp.zeros((YS, YS), x.dtype)
        return lx, lu, ly, lxx, luu, lux, lyy

    def _td_vel_penalty(x, kd):
        """TDVelocityPenalty (MHPCCost.cpp:255-291): 0.5 * vz^2 per
        touchdown leg."""
        vf = wbm.foot_velocities(model, x)
        return 0.5 * jnp.sum(kd.td_mask * vf[:, 2] ** 2)

    def _term_cost_wb(x, kd):
        dx = x - kd.x_ref
        phi = 0.5 * jnp.sum(wb_qf * dx * dx)
        # WBFootPlaceReg terminal (MHPCCost.cpp:65-86): 0.5*d'Qd, stance
        pcom = x[0:3]
        pf = wbm.foot_positions(model, x)
        rc = kd.ref_contact
        d = (pf - pcom[None, :]) - (kd.pf_ref.reshape(4, 3)
                                    - kd.com_ref[None, :])
        phi = phi + 0.5 * jnp.sum(rc[:, None] * d * d * QF_reg[None, :])
        return phi + _td_vel_penalty(x, kd)

    def _term_cost_srb(x, kd):
        dx = x - kd.x_ref
        return 0.5 * jnp.sum(srb_qf36 * dx * dx)

    if mode == "wb":
        term_cost = _term_cost_wb
    elif mode == "srb":
        term_cost = _term_cost_srb
    else:
        def term_cost(x, kd):
            return jnp.where(kd.model_id == 0, _term_cost_wb(x, kd),
                             _term_cost_srb(x, kd))

    def _term_cost_partials_wb(x, kd):
        dx = x - kd.x_ref
        phix = wb_qf * dx
        phixx = jnp.diag(wb_qf)
        # foot place reg terminal partials, factor 2 quirk
        # (MHPCCost.cpp:89-118: Phix += 2*lq, Phixx += 2*lqq)
        pcom = x[0:3]
        pf = wbm.foot_positions(model, x)
        J = wbm.foot_jacobians(model, x)
        Jt = J.at[:, :, 0:3].set(0.0)
        rc = kd.ref_contact
        d = (pf - pcom[None, :]) - (kd.pf_ref.reshape(4, 3)
                                    - kd.com_ref[None, :])
        w = rc[:, None] * QF_reg[None, :]
        lq = jnp.einsum("fij,fi->j", Jt, w * d)
        lqq = jnp.einsum("fij,fi,fik->jk", Jt, w, Jt)
        fx = jnp.zeros(36, x.dtype).at[0:18].set(2.0 * lq)
        fxx = jnp.zeros((36, 36), x.dtype).at[0:18, 0:18].set(2.0 * lqq)
        # TD velocity penalty partials (MHPCCost.cpp:271-291)
        vf = wbm.foot_velocities(model, x)
        Jv_q = wbm.foot_vel_dq(model, x)
        Jrow = jnp.concatenate([Jv_q[:, 2, :], J[:, 2, :]], axis=1)  # [4,36]
        tdw = kd.td_mask
        fx = fx + jnp.einsum("f,fj->j", tdw * vf[:, 2], Jrow)
        fxx = fxx + jnp.einsum("fj,f,fk->jk", Jrow, tdw, Jrow)
        return phix + fx, phixx + fxx

    def _term_cost_partials_srb(x, kd):
        dx = x - kd.x_ref
        return srb_qf36 * dx, jnp.diag(srb_qf36)

    if mode == "wb":
        term_cost_partials = _term_cost_partials_wb
    elif mode == "srb":
        term_cost_partials = _term_cost_partials_srb
    else:
        def term_cost_partials(x, kd):
            wb = kd.model_id == 0
            px_w, pxx_w = _term_cost_partials_wb(x, kd)
            px_s, pxx_s = _term_cost_partials_srb(x, kd)
            return (jnp.where(wb, px_w, px_s),
                    jnp.where(wb, pxx_w, pxx_s))

    # ---------------- constraints ---------------------------------
    FACETS = jnp.array([[0.0, 0.0, 1.0],
                        [-1.0, 0.0, MU_WB],
                        [1.0, 0.0, MU_WB],
                        [0.0, -1.0, MU_WB],
                        [0.0, 1.0, MU_WB]])

    def path_con(x, u, y, sd):
        g_tq = jnp.concatenate([u + TORQUE_LIMIT, TORQUE_LIMIT - u])
        qJ = x[6:18]
        lb = jnp.tile(jnp.asarray(JOINT_LB), 4)
        ub = jnp.tile(jnp.asarray(JOINT_UB), 4)
        g_j = jnp.concatenate([qJ - lb, ub - qJ])
        if mode == "wb":
            h_min = MIN_HEIGHT_WB
            f = y.reshape(4, 3)
        elif mode == "srb":
            h_min = MIN_HEIGHT_SRB
            f = u.reshape(4, 3)
        else:
            h_min = jnp.where(sd.model_id == 0, MIN_HEIGHT_WB,
                              MIN_HEIGHT_SRB)
            # GRF pyramid: on y for WB (ys output), on u for SRB (u = GRF)
            f = jnp.where(sd.model_id == 0, y, u).reshape(4, 3)
        g_h = (x[2] - h_min)[None]
        g_grf = jnp.einsum("fi,li->lf", FACETS.astype(x.dtype), f) \
            .reshape(20)
        qJd = x[24:36]
        g_jv = jnp.concatenate([qJd + JOINT_SPEED_LIMIT,
                                JOINT_SPEED_LIMIT - qJd])
        return jnp.concatenate([g_tq, g_j, g_h, g_grf, g_jv])

    def path_con_partials(x, u, y, sd):
        dtype = x.dtype
        gx = jnp.zeros((N_PCON, XS), dtype)
        gu = jnp.zeros((N_PCON, US), dtype)
        gy = jnp.zeros((N_PCON, YS), dtype)
        I12 = jnp.eye(12, dtype=dtype)
        gu = gu.at[0:12].set(I12).at[12:24].set(-I12)
        gx = gx.at[24:36, 6:18].set(I12).at[36:48, 6:18].set(-I12)
        gx = gx.at[48, 2].set(1.0)
        gx = gx.at[69:81, 24:36].set(I12).at[81:93, 24:36].set(-I12)
        Fblk = jnp.zeros((20, 12), dtype)
        for leg in range(4):
            Fblk = Fblk.at[5 * leg:5 * leg + 5, 3 * leg:3 * leg + 3].set(
                FACETS.astype(dtype))
        if mode == "wb":
            gy = gy.at[49:69].set(Fblk)
        elif mode == "srb":
            gu = gu.at[49:69].set(Fblk)
        else:
            wb = sd.model_id == 0
            gy = gy.at[49:69].set(jnp.where(wb, Fblk, 0.0))
            gu = gu.at[49:69].set(jnp.where(wb, jnp.zeros_like(Fblk), Fblk))
        return gx, gu, gy

    if mode == "srb":
        # no AL terminal constraints on the SRB tail (pen.al_active is 0
        # on its knots); keep the callable trivial
        def term_con(x, kd):
            return jnp.zeros(N_TCON, x.dtype)

        def term_con_partials(x, kd):
            return jnp.zeros((N_TCON, XS), x.dtype)
    else:
        def term_con(x, kd):
            """WBTouchDown (MHPCConstraint.cpp:253-288): foot height at
            TD."""
            return wbm.foot_heights(model, x)

        def term_con_partials(x, kd):
            J = wbm.foot_jacobians(model, x)     # [4,3,18]
            hx = jnp.zeros((N_TCON, XS), x.dtype)
            return hx.at[:, 0:18].set(J[:, 2, :])

    batch_overrides = {}
    if mode == "wb" and not use_ad \
            and os.environ.get("CAFEMPC_WB_LANE", "1") == "1":
        # The lane overrides are rebuilt from `urdf`; if the caller
        # passed a `model` that does not match it, the LQ/reset path
        # would silently use different dynamics than the rollout
        # (ADVICE r4, medium).  Verify numeric identity and refuse
        # otherwise (pass the matching urdf= to use another robot).
        if model_given and model is not wbm.load_model(urdf):
            ref_model = wbm.load_model(urdf)
            try:
                same = all(
                    np.allclose(np.asarray(a), np.asarray(b))
                    for a, b in zip(jax.tree.leaves(model),
                                    jax.tree.leaves(ref_model),
                                    strict=True))
            except ValueError:
                same = False
            if not same:
                raise ValueError(
                    "make_mhpc_fns: `model` does not match `urdf` "
                    f"({urdf!r}); the lane-form batch overrides are "
                    "built from the URDF and would diverge from the "
                    "rollout dynamics.  Pass the matching urdf= (or "
                    "set CAFEMPC_WB_LANE=0 to disable the lane path).")
        from cafempc.problems import mhpc_lane
        batch_overrides = mhpc_lane.make_wb_lane_batch_fns(
            cfg, urdf, lane_chunk=lane_chunk)

    return ProblemFns(
        dyn=dyn, dyn_partials=dyn_partials, reset=reset,
        reset_partial=reset_partial, run_cost=run_cost,
        run_cost_partials=run_cost_partials, term_cost=term_cost,
        term_cost_partials=term_cost_partials, path_con=path_con,
        path_con_partials=path_con_partials, term_con=term_con,
        term_con_partials=term_con_partials, **batch_overrides)


def make_mhpc_fns_segmented(cfg: MHPCConfig, model=None,
                            urdf=wbm.DEFAULT_URDF,
                            lane_chunk=None) -> SegmentedFns:
    """Two-segment problem functions for the cascade: WB steps
    [0, wb_block), SRB tail [wb_block, n_steps_max).  Requires the plan
    from build_mhpc_plan (carry-pad layout).  Eliminates the WB KKT
    dynamics/partials from SRB knots and vice versa — the dominant waste
    of the joint where-select fns."""
    cfg = _default_weights(cfg)
    wb = make_mhpc_fns(cfg, model=model, mode="wb", urdf=urdf,
                       lane_chunk=lane_chunk)
    tail = make_mhpc_fns(cfg, model=model, mode="srb", urdf=urdf)
    return SegmentedFns(
        counts=(cfg.wb_block, cfg.n_steps_max - cfg.wb_block),
        fns=(wb, tail))
