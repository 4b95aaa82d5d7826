#!/usr/bin/env python3
"""Two-process HKD-MPC demo over the LCM wire.

Mirrors the reference's process topology (SURVEY §1: sim ⇄ MPC over LCM
UDP multicast, channels "mpc_data"/"mpc_command", HKDMPC.h:42): one
process runs the MPC service (HKDMPCRuntime.serve), the other a
stand-in robot that integrates the HKD dynamics under the commanded
controls + feedback and streams its state back — the over-the-wire
version of testTrajOptInLoop.

Run: python examples/two_process_hkd_mpc.py [--steps 20]
(forks the MPC server as a child process; requires multicast loopback).
The MPC server takes JAX's default backend (the GPU where there is one);
the stand-in robot stays on the CPU, so only one process opens the card.
"""
import argparse
import os as _os
import subprocess
import sys as _sys
import time

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import numpy as np

PLAN_DUR = 0.4
N_MAX = 48
DT_SIM = 0.01
NSTEPS_MPC = 2


def _jax(cpu):
    import jax
    if cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from cafempc.utils.platform import enable_compile_cache
    enable_compile_cache()
    return jax


def run_mpc(max_msgs=None):
    """MPC process: hkd_data in -> solve -> hkd_command out."""
    _jax(cpu=False)
    import jax.numpy as jnp
    from cafempc.comms.udpm import LCMEndpoint
    from cafempc.data import hkd_reference
    from cafempc.problems import hkd_problem as hp
    from cafempc.reference.quad_reference import QuadReference
    from cafempc.runtime.mpc import HKDMPCRuntime
    from cafempc.solver.options import SolverOptions

    qr = QuadReference(hkd_reference("bound"))
    qr.initialize(PLAN_DUR)
    cfg = hp.HKDConfig(plan_duration=PLAN_DUR, n_steps_max=N_MAX,
                       dt_sim=DT_SIM, nsteps_between_mpc=NSTEPS_MPC)
    opts = SolverOptions(max_AL_iter=3, max_DDP_iter=3,
                         max_AL_iter_runtime=2, max_DDP_iter_runtime=1)
    rt = HKDMPCRuntime(qr, cfg, opts, dtype=jnp.float64)
    ep = LCMEndpoint()
    print("[mpc] serving", flush=True)
    rt.serve(ep, max_msgs=max_msgs)
    ep.close()


def run_sim(n_mpc_steps):
    """Robot stand-in: publish state, apply received command tape by
    integrating the HKD dynamics (controls + state feedback)."""
    _jax(cpu=True)
    import jax
    import jax.numpy as jnp
    from cafempc.comms import lcm_wire as w
    from cafempc.comms.udpm import LCMEndpoint
    from cafempc.models import hkd

    step = jax.jit(hkd.dynamics)

    ep = LCMEndpoint()
    latest = {}
    ep.subscribe("mpc_command", w.hkd_command_lcmt,
                 lambda ch, m: latest.update(cmd=m))

    body = np.zeros(12)
    body[5] = 0.2486
    qJ = np.array([0.0, -0.8, 1.6] * 4)
    contact = np.ones(4)
    qd = np.asarray(hkd.compute_hkd_state(
        jnp.asarray(body[0:3]), jnp.asarray(body[3:6]), jnp.asarray(qJ),
        jnp.asarray(contact)))
    x = np.concatenate([body, qd])
    mpctime = 0.0

    def publish_state(reset):
        msg = w.hkd_data_lcmt(reset_mpc=reset, MS=True, mpctime=mpctime)
        msg.contact = contact.astype(np.int32)
        msg.rpy = x[0:3][::-1]
        msg.p = x[3:6]
        msg.omegaBody = x[6:9]
        msg.vWorld = x[9:12]
        msg.qJ = qJ
        msg.foot_placements = x[12:24]
        ep.publish("mpc_data", msg)

    publish_state(True)
    for it in range(n_mpc_steps):
        t_wait = time.time()
        while "cmd" not in latest:
            ep.handle(timeout=0.5)
            # UDP is lossy and the MPC process may still be compiling on
            # the first iteration — keep re-publishing the reset state
            if it == 0 and "cmd" not in latest:
                time.sleep(1.0)
                publish_state(True)
            if time.time() - t_wait > 900:
                raise TimeoutError("no mpc_command received")
        cmd = latest.pop("cmd")
        # integrate dt_mpc under the tape: u = u_ff + K (x_body - x_des)
        for k in range(NSTEPS_MPC):
            u = np.asarray(cmd.hkd_controls[k], dtype=float)
            dx = x[:12] - np.asarray(cmd.des_body_state[k], dtype=float)
            u[:12] += np.asarray(cmd.feedback[k], dtype=float) @ dx
            contact = np.asarray(cmd.contacts[k], dtype=float)
            x = np.asarray(step(jnp.asarray(x), jnp.asarray(u), DT_SIM,
                                jnp.asarray(contact)))
            mpctime += DT_SIM
        print(f"[sim] t={mpctime:.2f} z={x[5]:.3f} "
              f"solve_time={cmd.solve_time*1e3:.0f}ms", flush=True)
        assert 0.05 < x[5] < 0.6, "body height diverged"
        publish_state(False)
    ep.close()
    print("[sim] done — closed-loop stable over the wire", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", choices=["mpc", "sim", "both"],
                    default="both")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if args.role == "mpc":
        run_mpc(max_msgs=None if args.steps == 0 else 10 * args.steps)
    elif args.role == "sim":
        run_sim(args.steps)
    else:
        child = subprocess.Popen(
            [_sys.executable, _os.path.abspath(__file__), "--role", "mpc",
             "--steps", "0"])
        try:
            run_sim(args.steps)
        finally:
            child.terminate()
            child.wait(timeout=30)


if __name__ == "__main__":
    main()
