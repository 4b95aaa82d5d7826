"""Barrel-roll trajectory optimization (acrobatic whole-body TO).

Functional mirror of the reference's hand-scripted 6-phase barrel-roll
problem (MHPC/MHPC-Trajopt/BarrelRoll/BarrelRollTO.cpp):

  phases: full stance -> right-legs stance -> flight (the roll) ->
          stance -> flight -> stance, switching times
          {0, 0.12, 0.33, 0.75, 0.90, 1.10, 1.25} (BarrelRollTO.cpp:70-80)
  * per-phase keyframe tracking (constant reference = hand-authored final
    state, load_desired_final_states, BarrelRollTO.cpp:278-339),
  * per-phase cost weights (br_cost_weights.JSON),
  * linear-interpolation state initialization (BarrelRollTO.cpp:137-150),
  * constraints: torque (+-17), joint speed (+-20), joint box, min height
    (0.13), GRF pyramid; AL touchdown on the landing phases (i = 2, 4)
    (BarrelRollConstraints.*, BarrelRollTO.cpp:196-261),
  * impact reset maps between phases (MHPCReset, WB->WB only).

This is "config 4" of BASELINE.json: full SO(3) whole-body trajopt.
"""
import dataclasses
import json
import re

import numpy as np
import jax
import jax.numpy as jnp

from cafempc.models import wbm
from cafempc.solver.hsddp import ProblemFns
from cafempc.solver.plan import (KnotData, KnotPlan, PenaltyParams,
                                 StepData)

XS, US, YS = 36, 12, 12
# [torque(24) | jointspeed(24) | joint(24) | minheight(1) | grf(20)]
N_PCON = 93
N_TCON = 4
TORQUE_LIMIT = 17.0
JOINT_SPEED_LIMIT = 20.0                      # BarrelRollConstraints.h:71-72
JOINT_LB = np.array([-1.3, -5.0, -np.pi])
JOINT_UB = np.array([1.3, 5.0, np.pi])
MIN_HEIGHT = 0.13                             # BarrelRollConstraints.h:147
MU = 0.6

SWITCHING_TIMES = [0.0, 0.12, 0.33, 0.75, 0.90, 1.10, 1.25]
CONTACTS = np.array([
    [1, 1, 1, 1],
    [0, 1, 0, 1],     # right-side stance (FL, FR, HL, HR order)
    [0, 0, 0, 0],
    [1, 1, 1, 1],
    [0, 0, 0, 0],
    [1, 1, 1, 1]], dtype=float)
TD_PHASES = (2, 4)   # landing phases carrying the touchdown constraint
DT = 0.01


def initial_state():
    """(BarrelRollTO.cpp:100-112)"""
    x = np.zeros(36)
    x[2] = 0.2183
    x[6:18] = np.tile([0.0, -1.0, 2.0], 4)
    return x


def keyframes():
    """Hand-authored per-phase final states
    (load_desired_final_states, BarrelRollTO.cpp:278-339)."""
    xf = np.zeros((6, 36))
    qJ_tuck = np.tile([0.0, -1.2, 2.4], 4)

    # phase 1 end (stance): launch into the roll
    xf[0, 0:3] = [0, -0.15, 0.26]
    xf[0, 3:6] = [0, 0, np.pi / 6]
    xf[0, 6:18] = qJ_tuck
    xf[0, 18:21] = [0, -1.0, 2.0]
    xf[0, 23] = 3.0 * np.pi          # roll rate

    # phase 2 end (right stance)
    xf[1, 0:3] = [0, -0.25, 0.33]
    xf[1, 3:6] = [0, 0, 0.5 * np.pi]
    xf[1, 6:18] = [np.pi / 6, -1.0, 2.0, -np.pi / 5, -0.5, 1.0,
                   np.pi / 6, -1.0, 2.0, -np.pi / 5, -0.5, 1.0]
    xf[1, 18:21] = [0, -1.2, 2.0]
    xf[1, 21:24] = [0, 0, 3.0 * np.pi]

    # phase 3 end (air, full roll completed)
    xf[2, 0:3] = [0.0, -0.55, 0.22]
    xf[2, 3:6] = [0, 0, 2.0 * np.pi]
    xf[2, 6:18] = [0.3, -1.1, 2.2, -0.3, -1.1, 2.2,
                   0.3, -1.1, 2.2, -0.3, -1.1, 2.2]
    xf[2, 18:21] = [0.0, -1.5, -2.5]
    xf[2, 21:24] = [0, 0, 3.0 * np.pi]

    # phase 4 end (landing stance)
    xf[3] = xf[2]
    xf[3, 2] = 0.25
    xf[3, 5] = 2 * np.pi
    xf[3, 18:24] = 0.0

    # phase 5 end (flight)
    xf[4] = xf[3]
    xf[4, 6:18] = np.tile([0.0, -1.0, 2.0], 4)

    # phase 6 end (stance)
    xf[5] = xf[4]
    return xf


def load_br_cost_weights(fname):
    """(load_cost_weights, BarrelRollTO.cpp:342+): per-phase q/r/qf."""
    d = json.load(open(fname))
    q, r, qf = [], [], []
    for i in range(6):
        b = d[f"cost_phase_{i + 1}"]
        q.append(np.concatenate([b["qw_qB"], np.tile(b["qw_qJ"], 4),
                                 b["qw_vB"], np.tile(b["qw_vJ"], 4)]))
        r.append(np.full(12, float(b["rw"])))
        qf.append(np.concatenate([b["qfw_qB"], np.tile(b["qfw_qJ"], 4),
                                  b["qfw_vB"], np.tile(b["qfw_vJ"], 4)]))
    return np.stack(q), np.stack(r), np.stack(qf)


def load_br_constraint_params(fname):
    txt = open(fname).read()

    def block(name):
        m = re.search(name + r"\s*\{(.*?)\}", txt, re.S)
        out = {}
        if m:
            for ln in m.group(1).splitlines():
                p = ln.split()
                if len(p) == 2:
                    out[p[0]] = float(p[1])
        return out

    return dict(GRF=block("GRF_ReB"), Torque=block("Torque_ReB"),
                JointVel=block("JointVel_ReB"), Joint=block("Joint_ReB"),
                MinHeight=block("MinHeight_ReB"), TD=block("TD_AL"))


def build_barrel_roll_plan(setting_dir=
                           "/root/reference/MHPC/MHPC-Trajopt/BarrelRoll/"
                           "setting"):
    """Flat 6-phase plan.  Returns (plan, pen, Xbar0, Ubar0, meta)."""
    qw, rw, qfw = load_br_cost_weights(f"{setting_dir}/br_cost_weights.JSON")
    cps = load_br_constraint_params(
        f"{setting_dir}/br_constraint_params.info")
    horizons = [int(round((SWITCHING_TIMES[i + 1] - SWITCHING_TIMES[i])
                          / DT)) for i in range(6)]
    N = sum(horizons) + 5          # + reset steps between the 6 phases
    x0 = initial_state()
    xf = keyframes()

    step = dict(
        active=np.zeros(N), is_reset=np.zeros(N), dt=np.full(N, DT),
        t=np.zeros(N), contact=np.zeros((N, 4)),
        contact_next=np.zeros((N, 4)), x_ref=np.zeros((N, XS)),
        u_ref=np.zeros((N, US)), y_ref=np.zeros((N, YS)),
        pf_ref=np.zeros((N, 12)), com_ref=np.zeros((N, 3)),
        vf_ref=np.zeros((N, 12)), ref_contact=np.zeros((N, 4)),
        model_id=np.zeros(N), model_switch=np.zeros(N),
        q_diag=np.zeros((N, XS)), r_diag=np.zeros((N, US)))
    knot = dict(
        active=np.zeros(N + 1), is_terminal=np.zeros(N + 1),
        td_mask=np.zeros((N + 1, 4)), contact=np.zeros((N + 1, 4)),
        ref_contact=np.zeros((N + 1, 4)), model_id=np.zeros(N + 1),
        qf_diag=np.zeros((N + 1, XS)),
        x_ref=np.zeros((N + 1, XS)), pf_ref=np.zeros((N + 1, 12)),
        com_ref=np.zeros((N + 1, 3)), t=np.zeros(N + 1))
    Xbar0 = np.zeros((N + 1, XS))
    Ubar0 = np.zeros((N, US))

    j = 0
    for i in range(6):
        hor = horizons[i]
        t_dur = SWITCHING_TIMES[i + 1] - SWITCHING_TIMES[i]
        x_start = x0 if i == 0 else xf[i - 1]
        for k in range(hor):
            t = SWITCHING_TIMES[i] + k * DT
            step["active"][j] = 1.0
            step["t"][j] = t
            step["contact"][j] = CONTACTS[i]
            step["ref_contact"][j] = CONTACTS[i]
            step["x_ref"][j] = xf[i]
            step["q_diag"][j] = qw[i]
            step["r_diag"][j] = rw[i]
            knot["active"][j] = 1.0
            knot["t"][j] = t
            knot["contact"][j] = CONTACTS[i]
            Xbar0[j] = x_start + (xf[i] - x_start) * (k * DT / t_dur)
            j += 1
        # phase terminal
        knot["active"][j] = 1.0
        knot["is_terminal"][j] = 1.0
        knot["t"][j] = SWITCHING_TIMES[i + 1]
        knot["contact"][j] = CONTACTS[i]
        knot["x_ref"][j] = xf[i]
        knot["qf_diag"][j] = qfw[i]
        if i in TD_PHASES:
            knot["td_mask"][j] = 1.0   # all feet (BarrelRollTO.cpp:252-261)
        Xbar0[j] = xf[i]
        if i < 5:
            step["active"][j] = 1.0
            step["is_reset"][j] = 1.0
            step["contact"][j] = CONTACTS[i]
            step["contact_next"][j] = CONTACTS[i + 1]
            step["t"][j] = SWITCHING_TIMES[i + 1]
            j += 1
    n_knots = j + 1
    assert n_knots == N + 1

    plan = KnotPlan(StepData(**step), KnotData(**knot))

    # penalty params per block
    reb_delta = np.ones((N, N_PCON))
    reb_eps = np.zeros((N, N_PCON))
    reb_active = np.zeros((N, N_PCON))
    reb_delta_min = np.ones(N_PCON)
    blocks = [("Torque", slice(0, 24)), ("JointVel", slice(24, 48)),
              ("Joint", slice(48, 72)), ("MinHeight", slice(72, 73)),
              ("GRF", slice(73, 93))]
    for name, sl in blocks:
        p = cps[name]
        reb_delta[:, sl] = p.get("delta", 0.1)
        reb_delta_min[sl] = p.get("delta_min", 0.1)
        reb_eps[:, sl] = p.get("eps", 0.1)
    for k in range(N):
        if not step["active"][k] or step["is_reset"][k]:
            continue
        reb_active[k, 0:73] = 1.0
        for leg in range(4):
            reb_active[k, 73 + 5 * leg:78 + 5 * leg] = \
                step["contact"][k][leg]
    al_active = knot["td_mask"] * knot["is_terminal"][:, None]
    pen = PenaltyParams(
        reb_delta=reb_delta, reb_eps=reb_eps, reb_active=reb_active,
        reb_delta_min=reb_delta_min,
        al_lambda=np.full((N + 1, N_TCON), cps["TD"].get("lambda", 0.0)),
        al_sigma=np.full((N + 1, N_TCON), cps["TD"].get("sigma", 20.0)),
        al_active=al_active,
        al_sigma_max=np.asarray(cps["TD"].get("sigma_max", 1e4)))

    meta = dict(horizons=horizons, switching_times=SWITCHING_TIMES,
                contacts=CONTACTS, n_knots=n_knots)
    return plan, pen, Xbar0, Ubar0, meta


def make_barrel_roll_fns(model=None, bg_alpha=10.0) -> ProblemFns:
    if model is None:
        model = wbm.load_model()

    def dyn(x, u, sd):
        return wbm.dynamics(model, x, u, sd.dt, sd.contact, bg_alpha)

    def dyn_partials(x, u, sd):
        (A, B), (C, D) = jax.jacfwd(
            lambda x_, u_: dyn(x_, u_, sd), argnums=(0, 1))(x, u)
        return A, B, C, D

    def reset(x, sd):
        ximp, _ = wbm.impact(model, x, sd.contact, sd.contact_next)
        has_impact = jnp.any((sd.contact_next - sd.contact) > 0.5)
        return jnp.where(has_impact, ximp, x)

    def reset_partial(x, sd):
        return jax.jacfwd(lambda x_: reset(x_, sd))(x)

    def run_cost(x, u, y, sd):
        dx = x - sd.x_ref
        return sd.dt * (0.5 * jnp.sum(sd.q_diag * dx * dx)
                        + 0.5 * jnp.sum(sd.r_diag * u * u))

    def run_cost_partials(x, u, y, sd):
        dx = x - sd.x_ref
        lx = sd.dt * sd.q_diag * dx
        lu = sd.dt * sd.r_diag * u
        lxx = sd.dt * jnp.diag(sd.q_diag)
        luu = sd.dt * jnp.diag(sd.r_diag)
        lux = jnp.zeros((US, XS), x.dtype)
        ly = jnp.zeros(YS, x.dtype)
        lyy = jnp.zeros((YS, YS), x.dtype)
        return lx, lu, ly, lxx, luu, lux, lyy

    def term_cost(x, kd):
        dx = x - kd.x_ref
        return 0.5 * jnp.sum(kd.qf_diag * dx * dx)

    def term_cost_partials(x, kd):
        dx = x - kd.x_ref
        return kd.qf_diag * dx, jnp.diag(kd.qf_diag)

    FACETS = jnp.array([[0.0, 0.0, 1.0],
                        [-1.0, 0.0, MU],
                        [1.0, 0.0, MU],
                        [0.0, -1.0, MU],
                        [0.0, 1.0, MU]])

    def path_con(x, u, y, sd):
        g_tq = jnp.concatenate([u + TORQUE_LIMIT, TORQUE_LIMIT - u])
        qJd = x[24:36]
        g_jv = jnp.concatenate([qJd + JOINT_SPEED_LIMIT,
                                JOINT_SPEED_LIMIT - qJd])
        qJ = x[6:18]
        lb = jnp.tile(jnp.asarray(JOINT_LB), 4)
        ub = jnp.tile(jnp.asarray(JOINT_UB), 4)
        g_j = jnp.concatenate([qJ - lb, ub - qJ])
        g_h = (x[2] - MIN_HEIGHT)[None]
        g_grf = jnp.einsum("fi,li->lf", FACETS.astype(x.dtype),
                           y.reshape(4, 3)).reshape(20)
        return jnp.concatenate([g_tq, g_jv, g_j, g_h, g_grf])

    def path_con_partials(x, u, y, sd):
        dtype = x.dtype
        gx = jnp.zeros((N_PCON, XS), dtype)
        gu = jnp.zeros((N_PCON, US), dtype)
        gy = jnp.zeros((N_PCON, YS), dtype)
        I12 = jnp.eye(12, dtype=dtype)
        gu = gu.at[0:12].set(I12).at[12:24].set(-I12)
        gx = gx.at[24:36, 24:36].set(I12).at[36:48, 24:36].set(-I12)
        gx = gx.at[48:60, 6:18].set(I12).at[60:72, 6:18].set(-I12)
        gx = gx.at[72, 2].set(1.0)
        Fblk = jnp.zeros((20, 12), dtype)
        for leg in range(4):
            Fblk = Fblk.at[5 * leg:5 * leg + 5, 3 * leg:3 * leg + 3].set(
                FACETS.astype(dtype))
        gy = gy.at[73:93].set(Fblk)
        return gx, gu, gy

    def term_con(x, kd):
        return wbm.foot_heights(model, x)

    def term_con_partials(x, kd):
        J = wbm.foot_jacobians(model, x)
        hx = jnp.zeros((N_TCON, XS), x.dtype)
        return hx.at[:, 0:18].set(J[:, 2, :])

    return ProblemFns(
        dyn=dyn, dyn_partials=dyn_partials, reset=reset,
        reset_partial=reset_partial, run_cost=run_cost,
        run_cost_partials=run_cost_partials, term_cost=term_cost,
        term_cost_partials=term_cost_partials, path_con=path_con,
        path_con_partials=path_con_partials, term_con=term_con,
        term_con_partials=term_con_partials)
