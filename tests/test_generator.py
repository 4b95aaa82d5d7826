"""Offline reference generator tests: gait schedules, IK consistency,
CSV round-trip, and an end-to-end HKD solve on a generated trot (the data
library lacks a plain trot — config 1 of BASELINE.json)."""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from cafempc.models import hkd
from cafempc.problems import hkd_problem as hp
from cafempc.reference import gait as gait_mod
from cafempc.reference.generator import (generate_reference,
                                         write_quad_reference_csv)
from cafempc.reference.quad_reference import (QuadReference,
                                              load_quad_reference)
from cafempc.solver.hsddp import make_solver
from cafempc.solver.options import SolverOptions
from cafempc.solver.plan import host_plan_to_device


def test_gait_schedule_periodicity():
    contacts, times = gait_mod.build_mode_schedule(
        gait_mod.GAITS["trot"], 2.0, initial_stance=0.05)
    assert times[0] == 0.0 and times[-1] >= 2.0
    # after the initial stance, alternating diagonals
    assert np.array_equal(contacts[1], [1, 0, 0, 1])   # FL-HR
    assert np.array_equal(contacts[2], [0, 1, 1, 0])   # FR-HL


def _hkd_feet(d, k):
    """World foot positions of record k through the HKD leg FK (urdf leg
    order FL,FR,HL,HR -> Cheetah-Software legs 1,0,3,2)."""
    pos, eul = d.body_state[k][:3], d.body_state[k][3:6]
    return np.concatenate([
        np.asarray(hkd.foot_position(jnp.asarray(pos), jnp.asarray(eul),
                                     jnp.asarray(d.qJ[k][3 * l:3 * l + 3]),
                                     (1, 0, 3, 2)[l])) for l in range(4)])


def test_generated_reference_ik_consistency():
    d = generate_reference("trot", duration=1.0, vx=0.3)
    for k in (0, 40, 80):
        assert np.abs(_hkd_feet(d, k) - d.foot_placements[k]).max() < 1e-8


def test_csv_roundtrip():
    d = generate_reference("pace", duration=1.0, vx=0.2)
    p = tempfile.mktemp(suffix=".csv")
    try:
        write_quad_reference_csv(d, p)
        d2 = load_quad_reference(p)
        assert len(d2) == len(d)
        assert np.abs(d2.body_state - d.body_state).max() < 1e-4
        assert np.array_equal(d2.contact, d.contact)
    finally:
        os.remove(p)


def test_hkd_solve_on_generated_trot():
    d = generate_reference("trot", duration=2.5, vx=0.5,
                           transition_time=1.0)
    # flip to the Cheetah-Software convention HKD uses
    p = tempfile.mktemp(suffix=".csv")
    try:
        write_quad_reference_csv(d, p)
        ref = load_quad_reference(p, reorder=True)
    finally:
        os.remove(p)
    qr = QuadReference(ref)
    qr.initialize(0.6)
    cfg = hp.HKDConfig()
    plan_np, pen_np, Xbar0, Ubar0, meta = hp.build_hkd_plan(qr, cfg)
    plan = host_plan_to_device(plan_np, dtype=jnp.float64)
    pen = hp.pen_to_device(pen_np, dtype=jnp.float64)
    opts = SolverOptions(max_AL_iter=4, max_DDP_iter=8, merit_offset=100.0,
                         gamma=0.01, update_penalty=5.0)
    solve = jax.jit(make_solver(hp.make_hkd_fns(), opts))

    body = np.zeros(12)
    body[5] = 0.24
    qJ = np.asarray(ref.qJ[0])
    c0 = np.asarray(qr.contact_at_t(0.0), dtype=float)
    qd = hkd.compute_hkd_state(jnp.asarray(body[0:3]),
                               jnp.asarray(body[3:6]),
                               jnp.asarray(qJ), jnp.asarray(c0))
    x0 = jnp.asarray(np.concatenate([body, np.asarray(qd)]))
    s = solve(plan, pen, x0, jnp.asarray(Xbar0), jnp.asarray(Ubar0))
    assert bool(s.success)
    assert float(s.feas) < 5e-2
    n = int(s.info.n_entries)
    costs = np.asarray(s.info.cost_buf[:n])
    assert costs[-1] < costs[1]


def test_barrel_roll_reference_generation():
    """Acrobatic generator (barrel_roll.py analogue): ballistic flight,
    full roll, csv round-trip."""
    from cafempc.reference.acrobatic import (
        generate_barrel_roll_reference, projectile_z, projectile_vz)
    d = generate_barrel_roll_reference(pre_stance=0.3, flight=0.4,
                                       post_stance=0.3)
    # apex height matches the ballistic profile
    assert abs(projectile_z(0.4, 0.2) - 9.81 * 0.16 / 8) < 1e-12
    # roll completes 2*pi
    eul = d.body_state[:, 3:6]
    assert abs(eul[-1, 2] - 2 * np.pi) < 1e-9
    # contact schedule: stance / fly / stance
    assert d.contact[0].sum() == 4
    mid = int(0.5 / d.dt)
    assert d.contact[mid].sum() == 0
    assert d.contact[-1].sum() == 4
    # flight dynamics consistent: vz is the derivative of z
    t0 = int(round(0.3 / d.dt))
    tf = np.arange(0, 0.4, d.dt)
    z = np.array([projectile_z(0.4, x) for x in tf])
    vz_fd = np.gradient(z, d.dt)
    vz = np.array([projectile_vz(0.4, x) for x in tf])
    assert np.abs(vz[1:-1] - vz_fd[1:-1]).max() < 0.2
    # csv round trip
    p = tempfile.mktemp(suffix=".csv")
    try:
        write_quad_reference_csv(d, p)
        d2 = load_quad_reference(p)
        assert np.array_equal(d2.contact, d.contact)
    finally:
        os.remove(p)


def test_run_jump_reference_generation():
    """Acrobatic generator (gen_run_jump.py analogue): composed bound +
    stretched-flight jump schedule, CoM z constant, contacts consistent."""
    from cafempc.reference.acrobatic import generate_run_jump_reference
    d = generate_run_jump_reference(n_bounds_before=2, n_bounds_after=2,
                                    vx=1.0)
    # constant reference height, forward progress
    assert np.allclose(d.body_state[:, 2], 0.24)
    assert d.body_state[-1, 0] > 0.5
    # flight durations: regular bound flights are 0.1 s; exactly one
    # stretched 0.35 s jump flight
    c = d.contact.sum(axis=1)
    flights = []
    k = 0
    while k < len(c):
        if c[k] == 0:
            j = k
            while j < len(c) and c[j] == 0:
                j += 1
            flights.append((j - k) * d.dt)
            k = j
        else:
            k += 1
    assert max(flights) > 0.3
    assert sum(1 for f in flights if f > 0.3) == 1
    # IK consistency at a mid-trajectory stance knot
    ks = np.where(c == 4)[0]
    k = int(ks[len(ks) // 2])
    assert np.abs(_hkd_feet(d, k) - d.foot_placements[k]).max() < 1e-6
