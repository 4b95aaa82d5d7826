"""HKD-MPC problem: flat knot-plan construction + problem functions.

Functional mirror of the reference HKD application layer:
  * phase discovery by contact scanning      (HKDProblem.cpp:26-68)
  * per-phase tracking + foot-reg costs      (HKDCost.h:8-100)
  * GRF friction-pyramid ReB constraint      (HKDConstraints.cpp:6-66)
  * touchdown AL constraint + HKD reset      (HKDConstraints.cpp:68-171,
                                              HKDReset.h:41-136)
  * receding-horizon update                  (HKDProblem.cpp:117-222) —
    realized as a cheap host-side plan rebuild into identical shapes.

The builder runs on the host in numpy and emits statically-shaped arrays;
`make_hkd_fns()` returns the pure JAX callables the HS-DDP solver vmaps.
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp

from cafempc.models import hkd
from cafempc.reference.quad_reference import (
    QuadReference, hkd_state_ref_at, hkd_control_ref_at)
from cafempc.solver.hsddp import ProblemFns
from cafempc.solver.plan import (KnotPlan, StepData, KnotData,
                                 PenaltyParams)

N_PCON = 20   # 5 friction facets x 4 legs
N_TCON = 4    # touchdown height per leg
MU_FRIC = 0.7  # HKDConstraints.h:17
GROUND_HEIGHT = 0.0


@dataclasses.dataclass
class HKDConfig:
    """(HKDMPC.cpp:26-29).  The defaults are this repository's own
    settings for the HKD path (cafempc/data), not read from the reference
    controller's settings files."""
    plan_duration: float = 0.6
    dt_sim: float = 0.01
    nsteps_between_mpc: int = 2
    n_steps_max: int = 72          # padded flat-plan length
    # constraint params: GRF friction-cone ReB and touchdown AL
    grf_reb_delta: float = 0.1
    grf_reb_delta_min: float = 0.1
    grf_reb_eps: float = 0.5
    td_al_sigma: float = 20.0
    td_al_sigma_max: float = 1e4
    td_al_lambda: float = 0.0


# ------------------------------------------------------------------
# Phase discovery + flat plan build (host-side numpy)
# ------------------------------------------------------------------

def discover_phases(quad_ref: QuadReference, plan_duration, dt):
    """Contact scan -> list of (start_t, end_t, horizon, contact[4])
    (HKDProblem.cpp:40-68)."""
    phases = []
    t = 0.0
    c_prev = np.array(quad_ref.contact_at_t(0.0))
    start = 0.0
    eps = 1e-6
    while t <= plan_duration + eps:
        c = np.array(quad_ref.contact_at_t(t))
        if (c != c_prev).any() or abs(t - plan_duration) < eps:
            horizon = int(round((t - start) / dt))
            if horizon > 0:
                phases.append((start, t, horizon, c_prev.copy()))
            c_prev = c
            start = t
        t += dt
    return phases


def build_hkd_plan(quad_ref: QuadReference, cfg: HKDConfig,
                   dt_mpc_ahead=None):
    """Build the flat plan (numpy KnotPlan), initial trajectory, and
    penalty parameter init for the current reference window.

    Returns (plan, pen, Xbar0, Ubar0, meta) where meta carries phase info
    for the runtime (contacts, horizons, durations).
    """
    dt = cfg.dt_sim
    N = cfg.n_steps_max
    phases = discover_phases(quad_ref, cfg.plan_duration, dt)
    n_ph = len(phases)

    # contact after the plan end — used for the last phase's touchdown
    # detection (HKDProblem.cpp:286)
    dt_ahead = dt_mpc_ahead if dt_mpc_ahead is not None \
        else cfg.nsteps_between_mpc * dt
    contact_after = np.array(quad_ref.contact_at_t(
        min(cfg.plan_duration + dt_ahead, quad_ref.dur)))

    xs, us, ys = hkd.XS, hkd.US, 0
    step = dict(
        active=np.zeros(N), is_reset=np.zeros(N), dt=np.full(N, dt),
        t=np.zeros(N), contact=np.zeros((N, 4)),
        contact_next=np.zeros((N, 4)), x_ref=np.zeros((N, xs)),
        u_ref=np.zeros((N, us)), y_ref=np.zeros((N, ys)),
        pf_ref=np.zeros((N, 12)), com_ref=np.zeros((N, 3)),
        vf_ref=np.zeros((N, 12)), ref_contact=np.zeros((N, 4)),
        model_id=np.zeros(N), model_switch=np.zeros(N),
        q_diag=np.zeros((N, 0)), r_diag=np.zeros((N, 0)))
    knot = dict(
        active=np.zeros(N + 1), is_terminal=np.zeros(N + 1),
        td_mask=np.zeros((N + 1, 4)), contact=np.zeros((N + 1, 4)),
        ref_contact=np.zeros((N + 1, 4)), model_id=np.zeros(N + 1),
        qf_diag=np.zeros((N + 1, 0)),
        x_ref=np.zeros((N + 1, xs)), pf_ref=np.zeros((N + 1, 12)),
        com_ref=np.zeros((N + 1, 3)), t=np.zeros(N + 1))
    Xbar0 = np.zeros((N + 1, xs))
    Ubar0 = np.zeros((N, us))

    t0 = phases[0][0]
    j = 0  # flat step index

    def fill_common(j, t):
        rec = quad_ref.record_at_t(t)
        step["t"][j] = t - t0
        step["x_ref"][j] = hkd_state_ref_at(quad_ref, t)
        step["u_ref"][j] = hkd_control_ref_at(quad_ref, t)
        step["pf_ref"][j] = rec["foot_placements"]
        step["com_ref"][j] = rec["body_state"][0:3]
        step["vf_ref"][j] = rec["foot_velocities"]
        step["ref_contact"][j] = rec["contact"]

    for ip, (ts, te, hor, contact) in enumerate(phases):
        # knot at phase start
        for k in range(hor):
            t = ts + k * dt
            step["active"][j] = 1.0
            step["contact"][j] = contact
            fill_common(j, t)
            knot["active"][j] = 1.0
            knot["t"][j] = t - t0
            knot["contact"][j] = contact
            knot["x_ref"][j] = step["x_ref"][j]
            knot["pf_ref"][j] = step["pf_ref"][j]
            knot["com_ref"][j] = step["com_ref"][j]
            Xbar0[j] = hkd_state_ref_at(quad_ref, t)
            Ubar0[j] = 0.0
            j += 1
        # phase-terminal knot
        knot["active"][j] = 1.0
        knot["is_terminal"][j] = 1.0
        knot["t"][j] = te - t0
        knot["contact"][j] = contact
        rec = quad_ref.record_at_t(te)
        knot["x_ref"][j] = hkd_state_ref_at(quad_ref, te)
        knot["pf_ref"][j] = rec["foot_placements"]
        knot["com_ref"][j] = rec["body_state"][0:3]
        Xbar0[j] = hkd_state_ref_at(quad_ref, te)
        contact_next = (phases[ip + 1][3] if ip + 1 < n_ph
                        else contact_after)
        knot["td_mask"][j] = ((contact == 0) & (contact_next == 1)) \
            .astype(float)
        if ip + 1 < n_ph:
            # reset step to the next phase-start knot
            step["active"][j] = 1.0
            step["is_reset"][j] = 1.0
            step["contact"][j] = contact
            step["contact_next"][j] = contact_next
            fill_common(j, te)
            Ubar0[j] = 0.0
            j += 1

    n_knots = j + 1
    # pad Xbar with last active state (keeps padded dynamics sane)
    Xbar0[n_knots:] = Xbar0[n_knots - 1]

    plan = KnotPlan(StepData(**step), KnotData(**knot))

    # ---- penalty params ------------------------------------------------
    reb_active = np.zeros((N, N_PCON))
    for k in range(N):
        if step["active"][k] and not step["is_reset"][k]:
            for leg in range(4):
                reb_active[k, 5 * leg:5 * leg + 5] = step["contact"][k][leg]
    al_active = knot["td_mask"] * knot["is_terminal"][:, None]
    pen = PenaltyParams(
        reb_delta=np.full((N, N_PCON), cfg.grf_reb_delta),
        reb_eps=np.full((N, N_PCON), cfg.grf_reb_eps),
        reb_active=reb_active,
        reb_delta_min=np.asarray(cfg.grf_reb_delta_min),
        al_lambda=np.full((N + 1, N_TCON), cfg.td_al_lambda),
        al_sigma=np.full((N + 1, N_TCON), cfg.td_al_sigma),
        al_active=al_active,
        al_sigma_max=np.asarray(cfg.td_al_sigma_max))

    meta = dict(phases=phases, n_knots=n_knots,
                contact_after=contact_after)
    return plan, pen, Xbar0, Ubar0, meta


def pen_to_device(pen: PenaltyParams, dtype=jnp.float32):
    return PenaltyParams(*[jnp.asarray(np.asarray(a), dtype=dtype)
                           for a in pen])


# ------------------------------------------------------------------
# Problem functions (pure JAX, consumed by the solver)
# ------------------------------------------------------------------

# friction pyramid facets per leg (HKDConstraints.cpp:17-22)
def _facets(dtype=jnp.float64):
    return jnp.array([[0.0, 0.0, 1.0],
                      [-1.0, 0.0, MU_FRIC],
                      [1.0, 0.0, MU_FRIC],
                      [0.0, -1.0, MU_FRIC],
                      [0.0, 1.0, MU_FRIC]])


def _np_facets():
    return np.array([[0.0, 0.0, 1.0],
                     [-1.0, 0.0, MU_FRIC],
                     [1.0, 0.0, MU_FRIC],
                     [0.0, -1.0, MU_FRIC],
                     [0.0, 1.0, MU_FRIC]])


# constant constraint Jacobian d g / d u (block-diag facets per leg) —
# precomputed in numpy so the vmapped partials never rebuild it with
# slice-set chains (which lower to per-knot dynamic-update-slice copies)
_GU_CONST = np.zeros((20, 24))
for _leg in range(4):
    _GU_CONST[5 * _leg:5 * _leg + 5, 3 * _leg:3 * _leg + 3] = _np_facets()

# foot-place reg placement constants: d prel/dx = c3 * (E_BLK - E_TILE)
# (HKDCost.h:61-68): identity blocks on the leg's own qdummy columns minus
# the CoM-position tile
_E_BLK = np.zeros((12, 24))
_E_TILE = np.zeros((12, 24))
for _leg in range(4):
    _E_BLK[3 * _leg:3 * _leg + 3, 12 + 3 * _leg:15 + 3 * _leg] = np.eye(3)
_E_TILE[:, 3:6] = np.tile(np.eye(3), (4, 1))


def _tracking_weights(contact):
    """Contact-modulated diagonal weights (HKDCost.h:13-36)."""
    q_eul = jnp.array([1.0, 4.0, 4.0])
    q_pos = jnp.array([1.0, 1.0, 30.0])
    q_omega = jnp.array([1.0, 0.5, 0.2])
    q_v = jnp.array([1.0, 1.0, 1.0])
    q_qJ = 0.1 * (1.0 - jnp.repeat(contact, 3))
    q = jnp.concatenate([q_eul, q_pos, q_omega, q_v, q_qJ])
    scale = jnp.concatenate([
        jnp.array([1.0, 1.0, 2.0, 1.0, 1.0, 20.0,
                   1.0, 0.2, 0.1, 1.0, 1.0, 1.0]),
        0.01 * jnp.ones(12)])
    qf = 20.0 * scale * q
    r = 0.1 * jnp.ones(24)
    return q, r, qf


def _footreg_weights(contact):
    """Qfoot diag (HKDCost.h:52-70): 100 * contact on x,y per leg."""
    w = jnp.stack([contact, contact, jnp.zeros_like(contact)], axis=-1)
    return 100.0 * w.reshape(12)


def _d_prel(x, pf_ref, com_ref):
    """prel - prel_ref for the foot-place regularization."""
    pcom = x[3:6]
    prel = x[12:24] - jnp.tile(pcom, 4)
    prel_r = pf_ref - jnp.tile(com_ref, 4)
    return prel - prel_r


def _dprel_dx(contact):
    """(HKDCost.h:61-68): d prel / dx, [12, 24] — contact mask times
    constant placement matrices (no per-knot slice-set chains)."""
    c3 = jnp.repeat(contact, 3)
    E = jnp.asarray(_E_BLK - _E_TILE, contact.dtype)
    return c3[:, None] * E


def make_hkd_fns() -> ProblemFns:
    def dyn(x, u, sd):
        xn = hkd.dynamics(x, u, sd.dt, sd.contact)
        return xn, jnp.zeros((0,), x.dtype)

    use_ad = os.environ.get("CAFEMPC_HKD_AD_PARTIALS", "0") == "1"

    def dyn_partials(x, u, sd):
        # closed-form hkinodyn_par analogue (models/hkd.py:dynamics_partials)
        # instead of a 48-tangent jacfwd: the reference itself evaluates
        # generated analytic partials here (HKDModel.h:46-61).
        if use_ad:   # A/B escape hatch for benchmarking
            A, B = hkd.dynamics_partials_ad(x, u, sd.dt, sd.contact)
        else:
            A, B = hkd.dynamics_partials(x, u, sd.dt, sd.contact)
        C = jnp.zeros((0, 24), x.dtype)
        D = jnp.zeros((0, 24), x.dtype)
        return A, B, C, D

    def reset(x, sd):
        return hkd.reset_map(x, sd.contact, sd.contact_next)

    def reset_partial(x, sd):
        return hkd.reset_map_partial(x, sd.contact, sd.contact_next)

    def run_cost(x, u, y, sd):
        q, r, _ = _tracking_weights(sd.contact)
        dx = x - sd.x_ref
        du = u - sd.u_ref
        l = 0.5 * jnp.sum(q * dx * dx) + 0.5 * jnp.sum(r * du * du)
        d = _d_prel(x, sd.pf_ref, sd.com_ref)
        qf = _footreg_weights(sd.contact)
        l = l + 0.5 * jnp.sum(qf * d * d)
        return l * sd.dt

    def run_cost_partials(x, u, y, sd):
        q, r, _ = _tracking_weights(sd.contact)
        dx = x - sd.x_ref
        du = u - sd.u_ref
        lx = sd.dt * q * dx
        lu = sd.dt * r * du
        lxx = sd.dt * jnp.diag(q)
        luu = sd.dt * jnp.diag(r)
        lux = jnp.zeros((24, 24), x.dtype)
        # foot-place reg (HKDCost.cpp:22-36)
        d = _d_prel(x, sd.pf_ref, sd.com_ref)
        qf = _footreg_weights(sd.contact)
        D = _dprel_dx(sd.contact)
        lx = lx + sd.dt * (D.T @ (qf * d))
        lxx = lxx + sd.dt * (D.T @ (qf[:, None] * D))
        ly = jnp.zeros((0,), x.dtype)
        lyy = jnp.zeros((0, 0), x.dtype)
        return lx, lu, ly, lxx, luu, lux, lyy

    def term_cost(x, kd):
        _, _, qf = _tracking_weights(kd.contact)
        dx = x - kd.x_ref
        phi = 0.5 * jnp.sum(qf * dx * dx)
        # foot reg terminal (HKDCost.cpp:39-50): 10 * d'Qd (not 0.5)
        d = _d_prel(x, kd.pf_ref, kd.com_ref)
        qfoot = _footreg_weights(kd.contact)
        return phi + 10.0 * jnp.sum(qfoot * d * d)

    def term_cost_partials(x, kd):
        _, _, qf = _tracking_weights(kd.contact)
        dx = x - kd.x_ref
        phix = qf * dx
        phixx = jnp.diag(qf)
        d = _d_prel(x, kd.pf_ref, kd.com_ref)
        qfoot = _footreg_weights(kd.contact)
        D = _dprel_dx(kd.contact)
        phix = phix + 20.0 * (D.T @ (qfoot * d))
        phixx = phixx + 20.0 * (D.T @ (qfoot[:, None] * D))
        return phix, phixx

    def path_con(x, u, y, sd):
        """g = A_leg @ grf_leg per stance leg (HKDConstraints.cpp:36-53).
        Masking by contact happens via PenaltyParams.reb_active."""
        F = _facets().astype(x.dtype)
        grf = u[0:12].reshape(4, 3)
        g = jnp.einsum("fi,li->lf", F, grf).reshape(20)
        return g

    def path_con_partials(x, u, y, sd):
        gu = jnp.asarray(_GU_CONST, x.dtype)
        gx = jnp.zeros((20, 24), x.dtype)
        gy = jnp.zeros((20, 0), x.dtype)
        return gx, gu, gy

    def term_con(x, kd):
        """h_l = foot_z - ground for touchdown legs
        (HKDConstraints.cpp:79-120), leg-vectorized."""
        return hkd.foot_heights(x) - GROUND_HEIGHT

    def term_con_partials(x, kd):
        return hkd.touchdown_height_partials(x)

    return ProblemFns(
        dyn=dyn, dyn_partials=dyn_partials, reset=reset,
        reset_partial=reset_partial, run_cost=run_cost,
        run_cost_partials=run_cost_partials, term_cost=term_cost,
        term_cost_partials=term_cost_partials, path_con=path_con,
        path_con_partials=path_con_partials, term_con=term_con,
        term_con_partials=term_con_partials)
