"""Offline reference-trajectory generator.

Re-implementation of the reference's Python tooling
(scripts/Reference_python/{gen_regular,reference_management,
body_trajectory_plan,foothold_plan,swing_trajectory_plan}.py) without
PyBullet: joint references come from the closed-form mini-cheetah leg IK
(models/hkd.leg_ik_local), or, for a whole-body robot model passed in,
from an analytic-Jacobian Newton IK over that model's kinematics.

Pipeline (gen_regular.py:32-86): gait schedule -> CoM plan (velocity ramp)
-> Raibert footholds -> swing trajectories -> per-knot IK -> csv in the
exact quad_reference.csv keyed-line format (urdf leg order FL,FR,HL,HR).
"""
import numpy as np
import jax
import jax.numpy as jnp

from cafempc.models import hkd, rbda
from cafempc.reference import gait as gait_mod
from cafempc.reference.quad_reference import QuadReferenceData

# Default foothold offsets w.r.t. CoM (foothold_plan.py:6-10)
DEFAULT_FOOTHOLDS = np.array([
    [0.22, 0.10, 0.0], [0.22, -0.10, 0.0],
    [-0.18, 0.10, 0.0], [-0.18, -0.10, 0.0]])

TOTAL_MASS = 8.252
G = 9.81


class CoMPlan:
    """Velocity ramp 0 -> v_des over transition_time, constant height
    (body_trajectory_plan.py behavior)."""

    def __init__(self, p0, v_des, z_des, transition_time):
        self.p0 = np.asarray(p0, dtype=float)
        self.v_des = np.asarray(v_des, dtype=float)
        self.T = transition_time
        self.z = z_des

    def vel(self, t):
        a = min(t / self.T, 1.0) if self.T > 0 else 1.0
        v = a * self.v_des
        return np.array([v[0], v[1], 0.0])

    def pos(self, t):
        if self.T > 0 and t < self.T:
            p_xy = self.p0[:2] + 0.5 * t * t / self.T * self.v_des
        else:
            p_xy = self.p0[:2] + self.v_des * (t - 0.5 * self.T)
        return np.array([p_xy[0], p_xy[1], self.z])


def _swing_interp(p0, p1, h, s):
    """Swing foot trajectory: smooth xy blend + sine height bump; returns
    (pos, d pos/d s)."""
    blend = 0.5 * (1.0 - np.cos(np.pi * s))
    dblend = 0.5 * np.pi * np.sin(np.pi * s)
    xy = p0[:2] + blend * (p1[:2] - p0[:2])
    dxy = dblend * (p1[:2] - p0[:2])
    z = p0[2] + blend * (p1[2] - p0[2]) + h * np.sin(np.pi * s)
    dz = dblend * (p1[2] - p0[2]) + h * np.pi * np.cos(np.pi * s)
    return (np.array([xy[0], xy[1], z]), np.array([dxy[0], dxy[1], dz]))


# urdf leg order (FL, FR, HL, HR) -> Cheetah-Software leg index
_HKD_LEG = (1, 0, 3, 2)


def make_leg_ik(model=None):
    """IK for all four legs at once: qJ s.t. world foot positions match
    targets, given a level body at `pos`.  Replaces
    mini_cheetah_pybullet.ik.  Without a model it is the closed-form
    mini-cheetah leg IK; with a whole-body model, a Newton IK over the
    model's foot kinematics warm-started from qJ0."""
    if model is None:
        def ik_closed_form(pos, pf_target, qJ0):
            del qJ0
            p = np.asarray(pf_target) - np.tile(np.asarray(pos), 4)
            return np.concatenate([
                hkd.leg_ik_local(p[3 * l:3 * l + 3], _HKD_LEG[l])
                for l in range(4)])
        return ik_closed_form

    @jax.jit
    def ik(pos, pf_target, qJ0):
        def step(qJ, _):
            q = jnp.concatenate([pos, jnp.zeros(3), qJ])
            pf = rbda.foot_kinematics(model, q).reshape(12)
            J = rbda.foot_jacobians(model, q)   # [4,3,18]
            err = pf_target - pf
            dq = []
            for leg in range(4):
                Jl = J[leg][:, 6 + 3 * leg:9 + 3 * leg]
                dq.append(jnp.linalg.solve(
                    Jl + 1e-9 * jnp.eye(3), err[3 * leg:3 * leg + 3]))
            return qJ + jnp.concatenate(dq), None
        qJ, _ = jax.lax.scan(step, qJ0, None, length=8)
        return qJ

    return ik


def generate_reference(gait_name="trot", duration=10.0, vx=0.5, vy=0.0,
                       z_des=0.24, swing_height=0.06, dt=0.01,
                       transition_time=2.5, initial_stance=0.05,
                       end_stance=0.15, model=None, schedule=None):
    """Build a QuadReferenceData for a regular gait (gen_regular.py).

    schedule: optional explicit (contacts, switching_times) mode schedule
    (gait.build_schedule_from_gaits) overriding the periodic gait — the
    composed-schedule path of gen_run_jump.py.
    """
    if schedule is not None:
        contacts, times = schedule
        duration = float(times[-1])
        end_stance = 0.0
    else:
        g = gait_mod.GAITS[gait_name]
        contacts, times = gait_mod.build_mode_schedule(
            g, duration, initial_stance, end_stance)
    com = CoMPlan([0.0, 0.0, z_des], [vx, vy], z_des, transition_time)

    # footholds per leg-mode interval (foothold_plan.py:20-60)
    leg_iv = [gait_mod.leg_intervals(contacts, times, l) for l in range(4)]
    footholds = []
    for l in range(4):
        iv = leg_iv[l]
        fhs = [com.pos(0) + DEFAULT_FOOTHOLDS[l]]
        for i in range(1, len(iv)):
            status, ts, te = iv[i]
            if status == 0:
                td = te
                stance_T = (iv[i + 1][2] - td) if i + 1 < len(iv) else 0.2
                cp, cv = com.pos(td), com.vel(td)
                off = np.minimum(cv[:2] * stance_T / 2.0, 0.2) \
                    + DEFAULT_FOOTHOLDS[l][:2]
                fhs.append(np.array([cp[0] + off[0], cp[1] + off[1], 0.0]))
            else:
                fhs.append(fhs[i - 1])
        for i in range(len(fhs)):
            fhs[i] = np.array([fhs[i][0], fhs[i][1], 0.0])
        footholds.append(fhs)

    def leg_mode_idx(l, t):
        iv = leg_iv[l]
        for i, (s, ts, te) in enumerate(iv):
            if ts - 1e-9 <= t < te - 1e-9:
                return i
        return len(iv) - 1

    # total mass for the nominal stance GRF: from the robot model when
    # one is passed (arcdog vs mini-cheetah), else the mini-cheetah value
    total_mass = (float(np.asarray(model.mass).sum())
                  if model is not None else TOTAL_MASS)
    ik = make_leg_ik(model)
    N = int(round((times[-1]) / dt)) + 1
    T = min(N, int(round(duration / dt)) + 1 + int(round(end_stance / dt)))

    recs = dict(body_state=[], qJ=[], qJd=[], foot_placements=[],
                foot_velocities=[], foot_heights=[], grf=[], torque=[],
                contact=[], status_dur=[])
    qJ_prev = jnp.asarray([0.0, -0.8, 1.6] * 4)
    for k in range(T):
        t = k * dt
        c = gait_mod.contact_at(contacts, times, t)
        pos = com.pos(t)
        vel = com.vel(t)
        pf = np.zeros(12)
        vf = np.zeros(12)
        sdur = np.zeros(4)
        for l in range(4):
            i = leg_mode_idx(l, t)
            status, ts, te = leg_iv[l][i]
            sdur[l] = te - ts
            if status == 1:
                pf[3 * l:3 * l + 3] = footholds[l][i]
            else:
                p0 = footholds[l][i - 1] if i > 0 else footholds[l][0]
                p1 = footholds[l][min(i + 1, len(footholds[l]) - 1)]
                s = (t - ts) / max(te - ts, 1e-9)
                p, dp_ds = _swing_interp(p0, p1, swing_height, s)
                pf[3 * l:3 * l + 3] = p
                vf[3 * l:3 * l + 3] = dp_ds / max(te - ts, 1e-9)
        n_st = max(int(c.sum()), 1)
        grf = np.zeros(12)
        for l in range(4):
            if c[l]:
                grf[3 * l + 2] = total_mass * G / n_st
        qJ = ik(pos, pf, qJ_prev)
        qJ_prev = qJ
        recs["body_state"].append(np.concatenate([pos, np.zeros(3), vel,
                                                  np.zeros(3)]))
        recs["qJ"].append(np.asarray(qJ))
        recs["qJd"].append(np.zeros(12))
        recs["foot_placements"].append(pf)
        recs["foot_velocities"].append(vf)
        recs["foot_heights"].append(pf[2::3].copy())
        recs["grf"].append(grf)
        recs["torque"].append(np.zeros(12))
        recs["contact"].append(c.astype(np.int32))
        recs["status_dur"].append(sdur)

    return QuadReferenceData(
        dt=dt, **{k: np.asarray(v) for k, v in recs.items()})


def write_quad_reference_csv(data: QuadReferenceData, path):
    """Emit the exact keyed-line quad_reference.csv format the C++ loader
    parses (QuadReference.cpp:134-356).  body_state on file is
    [eul, pos, eulrate, vel]."""
    def fmt(v):
        return " ".join(f"{x:8.4f}" for x in v)

    with open(path, "w") as fh:
        fh.write("dt\n%.3f\n" % data.dt)
        for k in range(len(data)):
            bs = data.body_state[k]
            on_file = np.concatenate([bs[3:6], bs[0:3], bs[9:12], bs[6:9]])
            fh.write("body_state \n" + fmt(on_file) + " \n")
            fh.write("jnt_angle\n" + fmt(data.qJ[k]) + " \n")
            fh.write("jnt_vel\n" + fmt(data.qJd[k]) + " \n")
            fh.write("foot_placements\n" + fmt(data.foot_placements[k])
                     + " \n")
            fh.write("foot_velocities\n" + fmt(data.foot_velocities[k])
                     + " \n")
            fh.write("grf\n" + fmt(data.grf[k]) + " \n")
            fh.write("torque\n" + fmt(data.torque[k]) + " \n")
            fh.write("contact\n"
                     + " ".join(str(int(x)) for x in data.contact[k])
                     + " \n")
            fh.write("status_dur\n" + fmt(data.status_dur[k]) + " \n")
