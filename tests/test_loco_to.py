"""Loco_TO standalone locomotion trajectory optimization
(Locomotion/LocoProblem.cpp + Loco_TO.cpp analogue)."""
import numpy as np
import pytest

from cafempc.problems import loco_problem as lp
from cafempc.problems import mhpc_problem as mp


def test_loco_config_loads_reference_settings():
    cfg = lp.load_loco_config()
    assert cfg.plan_dur_wb == 1.0
    assert cfg.plan_dur_srb == 0.0
    assert cfg.reference_file == "flypace"
    assert cfg.pcon_set == "loco"
    # loco constraint params (loco_constraint_params.info)
    assert cfg.reb["GRF"]["delta"] == 0.2
    assert cfg.reb["Torque"]["eps"] == 0.01
    assert cfg.td_al_sigma == 20.0
    # loco cost weights (loco_cost_weights.JSON)
    assert cfg.wb_q[2] == 20.0


def test_loco_plan_constraint_set():
    cfg = lp.load_loco_config(n_steps_max=128)
    (fns, opts, plan, pen, x0, Xb, Ub, meta, qr) = lp.build_loco_problem(
        cfg=cfg)
    # full reference settings: 30 AL x 10 DDP caps
    assert opts.max_AL_iter == 30 and opts.max_DDP_iter == 10
    reb = np.asarray(pen.reb_active)
    act = np.asarray(plan.step.active) > 0
    rst = np.asarray(plan.step.is_reset) > 0
    dyn = act & ~rst
    # torque armed, joint box + min height NOT armed (LocoProblem.cpp)
    assert np.all(reb[dyn][:, 0:24] == 1.0)
    assert np.all(reb[:, 24:49] == 0.0)
    # GRF armed on stance legs only
    contact = np.asarray(plan.step.contact)
    for leg in range(4):
        np.testing.assert_array_equal(
            reb[dyn][:, 49 + 5 * leg], contact[dyn][:, leg])
    # WB-only: no SRB steps, 100 dyn steps at dt 0.01
    assert np.all(np.asarray(plan.step.model_id)[dyn] == 0)
    assert dyn.sum() == 100


@pytest.mark.slow
def test_loco_to_solves():
    """Short-horizon Loco TO from the standing pose converges (full
    horizon at 1.0 s is exercised by examples/loco_to_demo.py).

    The initial rollout is wildly dynamics-infeasible (MS defects ~5),
    which makes its recorded cost artificially LOW — so "final cost <
    initial cost" is not a convergence criterion here.  Assert the real
    convergence signals instead: feasibility driven to ~0, constraints
    satisfied, and cost monotonically decreasing once feasible."""
    s, plan, meta, qr = lp.solve_loco_to(plan_dur=0.2, max_AL_iter=4,
                                         max_DDP_iter=4)
    assert bool(s.success)
    assert float(s.feas) < 1e-3
    assert float(s.max_tconstr) < 1e-3
    assert float(s.max_pconstr) > -1e-3
    n = int(s.info.n_entries)
    costs = np.asarray(s.info.cost_buf[:n])
    feass = np.asarray(s.info.dyn_feas_buf[:n])
    # cost decreases across the feasible tail of the iteration history
    tail = costs[feass < 0.5]
    assert len(tail) >= 2 and np.all(np.diff(tail) < 1e-9)


def test_joint_speed_limit_flag():
    """JointSpeedLimit (MHPCConstraint.cpp:118-160): flag-gated, off by
    default, +-20 rad/s on qJd when armed."""
    import jax
    import jax.numpy as jnp
    from cafempc.reference.quad_reference import (QuadReference,
                                                  load_quad_reference)
    ref = load_quad_reference(
        "/root/reference/Reference/Data/bound/quad_reference.csv")
    qr = QuadReference(ref)
    qr.initialize(0.4)
    cfg = mp.MHPCConfig(plan_dur_wb=0.1, plan_dur_srb=0.2,
                        n_steps_max=24, wb_block=16)
    _, pen_off, _, _, _ = mp.build_mhpc_plan(qr, cfg)
    assert np.all(np.asarray(pen_off.reb_active)[:, 69:93] == 0)
    cfg_on = mp.MHPCConfig(plan_dur_wb=0.1, plan_dur_srb=0.2,
                           n_steps_max=24, wb_block=16,
                           joint_speed_limit=True)
    plan, pen_on, _, _, _ = mp.build_mhpc_plan(qr, cfg_on)
    act = (np.asarray(plan.step.active) > 0) & \
        (np.asarray(plan.step.is_reset) == 0) & \
        (np.asarray(plan.step.model_id) == 0)
    assert np.all(np.asarray(pen_on.reb_active)[act][:, 69:93] == 1)
    # constraint value: g = [qJd + 20, 20 - qJd]
    fns = mp.make_mhpc_fns(cfg_on, mode="wb")
    x = jnp.zeros(36).at[24].set(5.0)
    g = fns.path_con(x, jnp.zeros(12), jnp.zeros(12),
                     jax.tree.map(lambda a: a[0], plan.step))
    assert abs(float(g[69]) - 25.0) < 1e-12
    assert abs(float(g[81]) - 15.0) < 1e-12
