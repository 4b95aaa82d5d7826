#!/usr/bin/env python3
"""Two-process MHPC demo over the LCM wire.

Mirrors the reference's flagship process topology (SURVEY §1: sim/VWBC ⇄
mhpc_run over LCM UDP multicast, channels "MHPC_DATA"/"MHPC_COMMAND",
MHPCLocomotion.cpp:36,282): one process runs the cascaded MPC service
(MHPCRuntime.serve), the other a stand-in robot that integrates the
whole-body dynamics under the commanded torque tape + feedback gains and
streams its state back.

Run: python examples/two_process_mhpc.py [--steps 5]
(forks the MPC server as a child process; requires multicast loopback).
"""
import argparse
import os as _os
import subprocess
import sys as _sys
import time

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import numpy as np

GAIT = "/root/reference/Reference/Data/bound/quad_reference.csv"
PLAN_DUR_WB = 0.1
PLAN_DUR_SRB = 0.2
WB_BLOCK = 16
N_MAX = 24
DT_WB = 0.01
DT_MPC = 0.02


def _jax_cpu():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from cafempc.utils.platform import enable_compile_cache
    enable_compile_cache()
    return jax


def _make_cfg():
    from cafempc.problems import mhpc_problem as mp
    return mp.MHPCConfig(plan_dur_wb=PLAN_DUR_WB, plan_dur_srb=PLAN_DUR_SRB,
                         n_steps_max=N_MAX, wb_block=WB_BLOCK,
                         dt_mpc=DT_MPC, dt_wb=DT_WB)


def run_mpc(max_msgs=None):
    """MPC process: MHPC_Data in -> cascaded solve -> MHPC_COMMAND out."""
    _jax_cpu()
    import jax.numpy as jnp
    from cafempc.comms.udpm import LCMEndpoint
    from cafempc.reference.quad_reference import (QuadReference,
                                                  load_quad_reference)
    from cafempc.runtime.mhpc_runtime import MHPCRuntime
    from cafempc.solver.options import SolverOptions

    qr = QuadReference(load_quad_reference(GAIT))
    qr.initialize(0.4)
    opts = SolverOptions(max_AL_iter=2, max_DDP_iter=2,
                         max_AL_iter_runtime=1, max_DDP_iter_runtime=1)
    rt = MHPCRuntime(qr, _make_cfg(), opts, dtype=jnp.float64)
    ep = LCMEndpoint()
    print("[mpc] serving MHPC_DATA -> MHPC_COMMAND", flush=True)
    rt.serve(ep, max_msgs=max_msgs)
    ep.close()


def run_sim(n_mpc_steps):
    """Robot stand-in: publish WB state, integrate the whole-body contact
    dynamics under the received torque tape u = u_ff + K (x - x_des)."""
    _jax_cpu()
    import jax
    import jax.numpy as jnp
    from cafempc.comms import lcm_wire as w
    from cafempc.comms.udpm import LCMEndpoint
    from cafempc.models import wbm
    from cafempc.reference.quad_reference import (QuadReference,
                                                  load_quad_reference,
                                                  wb_state_ref_at)

    model = wbm.load_model()
    step = jax.jit(lambda x, u, c: wbm.dynamics(model, x, u, DT_WB, c)[0])

    qr = QuadReference(load_quad_reference(GAIT))
    qr.initialize(0.4)
    x = np.asarray(wb_state_ref_at(qr, 0.0), dtype=float)

    ep = LCMEndpoint()
    latest = {}
    ep.subscribe("MHPC_COMMAND", w.MHPC_Command_lcmt,
                 lambda ch, m: latest.update(cmd=m))
    mpctime = 0.0

    def publish_state(reset):
        msg = w.MHPC_Data_lcmt(reset_mpc=reset, MS=True, mpctime=mpctime)
        msg.pos = x[0:3]
        msg.eul = x[3:6]
        msg.qJ = x[6:18]
        msg.vWorld = x[18:21]
        msg.eulrate = x[21:24]
        msg.qJd = x[24:36]
        ep.publish("MHPC_DATA", msg)

    publish_state(True)
    for it in range(n_mpc_steps):
        t_wait = time.time()
        while "cmd" not in latest:
            ep.handle(timeout=0.5)
            if it == 0 and "cmd" not in latest:
                time.sleep(1.0)
                publish_state(True)
            if time.time() - t_wait > 900:
                raise TimeoutError("no MHPC_COMMAND received")
        cmd = latest.pop("cmd")
        n_sub = int(round(DT_MPC / DT_WB))
        for k in range(n_sub):
            u = np.asarray(cmd.torque[k], dtype=float)
            # feedback is flattened column-major (Eigen .data() layout)
            K = np.asarray(cmd.feedback[k], dtype=float).reshape(36, 12).T
            dx = x - np.concatenate([
                np.asarray(cmd.pos[k]), np.asarray(cmd.eul[k]),
                np.asarray(cmd.qJ[k]), np.asarray(cmd.vWorld[k]),
                np.asarray(cmd.eulrate[k]), np.asarray(cmd.qJd[k])])
            u = u + K @ dx
            contact = np.asarray(cmd.contacts[k], dtype=float)
            x = np.asarray(step(jnp.asarray(x), jnp.asarray(u),
                                jnp.asarray(contact)))
            mpctime += DT_WB
        print(f"[sim] t={mpctime:.2f} z={x[2]:.3f} "
              f"statusTimes[0]={np.asarray(cmd.statusTimes[0])}",
              flush=True)
        assert 0.05 < x[2] < 0.6, "body height diverged"
        publish_state(False)
    ep.close()
    print("[sim] done — closed-loop MHPC over the wire", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", choices=["mpc", "sim", "both"],
                    default="both")
    ap.add_argument("--steps", type=int, default=5)
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
