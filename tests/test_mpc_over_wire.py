"""End-to-end MPC over the LCM wire: hkd_data in -> serve() -> solve ->
hkd_command out, over real UDP-multicast loopback (the single-process
version of examples/two_process_hkd_mpc.py; reference topology
HKDMPC.cpp:169-205)."""
import numpy as np
import jax.numpy as jnp
import pytest

from cafempc.comms import lcm_wire as w
from cafempc.comms.udpm import LCMEndpoint, UDPMulticast
from cafempc.data import hkd_reference
from cafempc.models import hkd
from cafempc.problems import hkd_problem as hp
from cafempc.reference.quad_reference import QuadReference
from cafempc.runtime.mpc import HKDMPCRuntime
from cafempc.solver.options import SolverOptions


def _make_runtime():
    qr = QuadReference(hkd_reference("bound"))
    qr.initialize(0.2)
    cfg = hp.HKDConfig(plan_duration=0.2, n_steps_max=24)
    opts = SolverOptions(max_AL_iter=2, max_DDP_iter=2,
                         max_AL_iter_runtime=1, max_DDP_iter_runtime=1)
    return HKDMPCRuntime(qr, cfg, opts, dtype=jnp.float64)


def _state_msg(reset, mpctime, x, qJ, contact):
    msg = w.hkd_data_lcmt(reset_mpc=reset, MS=True, mpctime=mpctime)
    msg.contact = np.asarray(contact, dtype=np.int32)
    msg.rpy = x[0:3][::-1]
    msg.p = x[3:6]
    msg.omegaBody = x[6:9]
    msg.vWorld = x[9:12]
    msg.qJ = qJ
    msg.foot_placements = x[12:24]
    return msg


def test_mpc_serve_over_udpm():
    try:
        server_ep = LCMEndpoint()
        client_ep = LCMEndpoint()
    except OSError:
        pytest.skip("multicast sockets unavailable")

    rt = _make_runtime()
    got = []
    client_ep.subscribe("mpc_command", w.hkd_command_lcmt,
                        lambda ch, m: got.append(m))

    body = np.zeros(12)
    body[5] = 0.2486
    qJ = np.array([0.0, -0.8, 1.6] * 4)
    contact = np.ones(4)
    qd = np.asarray(hkd.compute_hkd_state(
        jnp.asarray(body[0:3]), jnp.asarray(body[3:6]), jnp.asarray(qJ),
        jnp.asarray(contact)))
    x = np.concatenate([body, qd])

    # initialize solve over the wire
    client_ep.publish("mpc_data", _state_msg(True, 0.0, x, qJ, contact))
    assert rt.serve(server_ep, max_msgs=1) == 1
    for _ in range(50):
        client_ep.handle(timeout=0.1)
        if got:
            break
    assert len(got) == 1
    cmd = got[0]
    assert cmd.N_mpcsteps > 0
    assert np.all(np.isfinite(cmd.hkd_controls))
    assert np.all(np.isfinite(cmd.feedback))
    # desired body state near the measured start
    assert abs(cmd.des_body_state[0][5] - 0.2486) < 0.05

    # runtime update solve over the wire (reset_mpc = False)
    x2 = x.copy()
    x2[5] += 0.005
    client_ep.publish("mpc_data", _state_msg(False, 0.02, x2, qJ, contact))
    assert rt.serve(server_ep, max_msgs=1) == 1
    for _ in range(50):
        client_ep.handle(timeout=0.1)
        if len(got) >= 2:
            break
    assert len(got) == 2
    assert got[1].N_mpcsteps > 0

    server_ep.close()
    client_ep.close()
