"""Closed-loop HKD-MPC test: repeated update()+solve() cycles re-feeding
the solver its own predicted state — the analogue of the reference's
testTrajOptInLoop.cpp harness."""
import jax.numpy as jnp
import numpy as np
import pytest

from cafempc.data import hkd_reference
from cafempc.models import hkd
from cafempc.problems import hkd_problem as hp
from cafempc.reference.quad_reference import QuadReference
from cafempc.runtime.mpc import HKDMPCRuntime
from cafempc.solver.options import SolverOptions


@pytest.mark.parametrize("gait", ["pace"])
def test_closed_loop_mpc(gait):
    qr = QuadReference(hkd_reference(gait))
    qr.initialize(0.6)
    cfg = hp.HKDConfig()
    opts = SolverOptions(max_DDP_iter=6, max_AL_iter=3,
                         max_DDP_iter_runtime=1, max_AL_iter_runtime=2)
    rt = HKDMPCRuntime(qr, cfg, opts)

    body = np.zeros(12)
    body[5] = 0.2486
    qJ = np.array([0, -0.8, 1.6] * 4, dtype=float)
    c0 = np.array(qr.contact_at_t(0.0), dtype=float)
    qd = hkd.compute_hkd_state(jnp.asarray(body[0:3]),
                               jnp.asarray(body[3:6]),
                               jnp.asarray(qJ), jnp.asarray(c0))
    x = np.concatenate([body, np.asarray(qd)])

    tape = rt.initialize(x)
    assert bool(rt.state.success)
    heights = []
    for it in range(8):
        # simulate the plant with the commanded controls
        for k in range(cfg.nsteps_between_mpc):
            u = tape.controls[k]
            c = tape.contacts[k]
            x = np.asarray(hkd.dynamics(
                jnp.asarray(x), jnp.asarray(u), cfg.dt_sim,
                jnp.asarray(c, dtype=float)))
        # contact change between tape steps -> apply reset map
        c_next = np.array(qr.contact_at_t(rt.dt_mpc), dtype=float)
        c_cur = tape.contacts[cfg.nsteps_between_mpc - 1]
        if (c_next != c_cur).any():
            x = np.asarray(hkd.reset_map(jnp.asarray(x),
                                         jnp.asarray(c_cur, dtype=float),
                                         jnp.asarray(c_next)))
        tape = rt.update(x)
        assert bool(rt.state.success)
        heights.append(x[5])
        # body stays upright and near reference height
        assert 0.15 < x[5] < 0.4, f"height diverged at iter {it}: {x[5]}"
        assert abs(x[0]) < 0.5 and abs(x[2]) < 0.6  # yaw, roll bounded
    # command tape well-formed
    assert tape.controls.shape[0] == cfg.nsteps_between_mpc + 7
    assert tape.feedback.shape[1:] == (12, 12)
    assert np.isfinite(tape.controls).all()


def test_intermediate_trajectory_channel():
    """solver_intermtraj_lcmt published per AL outer iteration on the
    reference's intermediate_ddp_traj channel (MultiPhaseDDP.h:95-107)."""
    import numpy as np
    import jax.numpy as jnp
    import pytest
    from cafempc.comms import lcm_wire as w
    from cafempc.models import hkd
    from cafempc.problems import hkd_problem as hp
    from cafempc.reference.quad_reference import QuadReference
    from cafempc.solver.options import SolverOptions
    try:
        from cafempc.comms.udpm import LCMEndpoint
        server_ep = LCMEndpoint()
        client_ep = LCMEndpoint()
    except OSError:
        pytest.skip("multicast sockets unavailable")
    qr = QuadReference(hkd_reference("bound"))
    qr.initialize(0.2)
    cfg = hp.HKDConfig(plan_duration=0.2, n_steps_max=24)
    opts = SolverOptions(max_AL_iter=2, max_DDP_iter=1)
    rt = HKDMPCRuntime(qr, cfg, opts, dtype=jnp.float64,
                       endpoint=server_ep, debug_intermtraj=True)
    got = []
    client_ep.subscribe("intermediate_ddp_traj", w.solver_intermtraj_lcmt,
                        lambda ch, m: got.append(m))
    body = np.zeros(12)
    body[5] = 0.2486
    qJ = np.array([0.0, -0.8, 1.6] * 4)
    qd = np.asarray(hkd.compute_hkd_state(
        jnp.asarray(body[0:3]), jnp.asarray(body[3:6]), jnp.asarray(qJ),
        jnp.ones(4)))
    rt.initialize(np.concatenate([body, qd]))
    for _ in range(50):
        client_ep.handle(timeout=0.1)
        if len(got) >= 2:
            break
    # one message per AL outer iteration that ran
    assert len(got) >= 1
    m = got[0]
    assert m.x_sz == 24 and m.u_sz == 24
    assert np.all(np.isfinite(m.x_tau))
    server_ep.close()
    client_ep.close()
