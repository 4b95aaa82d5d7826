"""Receding-horizon MPC runtime for the cascaded MHPC problem.

Functional equivalent of the reference MHPCLocomotion (MHPC/
MHPCLocomotion.cpp): initialize() does the full-cap solve; update() steps
the reference window by dt_mpc, rebuilds the flat cascaded plan (the
reference's update_WB_plan/update_SRB_plan deque surgery,
MHPCProblem.cpp:252-397), warm-starts from the previous solution, and
re-solves with the runtime caps.  publish_mpc_cmd's 8-step command tape —
x, tau, GRF, Qu, Quu, Qux, feedback K per step (MHPCLocomotion.cpp:190-287)
— is produced as an MHPC_Command_lcmt message; serve() runs the full
LCM wire loop (mpcdata_lcm_handler, MHPCLocomotion.cpp:153-187).
"""
import time as _time

import numpy as np
import jax
import jax.numpy as jnp

from cafempc.comms import lcm_wire as w
from cafempc.problems import mhpc_problem as mp
from cafempc.reference.quad_reference import (QuadReference,
                                              wb_state_ref_at)
from cafempc.solver.hsddp import make_solver
from cafempc.solver.options import SolverOptions
from cafempc.solver.plan import host_plan_to_device
from cafempc.runtime.warm_start import time_aligned_warm_start


class MHPCRuntime:
    def __init__(self, quad_ref: QuadReference, cfg: mp.MHPCConfig,
                 opts: SolverOptions, dtype=jnp.float64,
                 n_cmd_steps=8, segmented=None, max_resets=8,
                 foot_handoff=False, endpoint=None,
                 debug_intermtraj=False):
        """segmented: use the two-segment LQ fan-out (default: on whenever
        the plan has an SRB tail); max_resets: static cap for gather-based
        reset evaluation (None disables); foot_handoff: freeze solved WB
        foot XY into the SRB tail for feet in stance at the handoff
        (MHPCFootStep.h:26-57 — opt-in, see apply_transition_foot_handoff);
        debug_intermtraj: publish solver_intermtraj_lcmt on the reference's
        "intermediate_ddp_traj" channel after every AL outer iteration
        (MultiPhaseDDP.h:95-107); requires `endpoint`.
        """
        self.endpoint = endpoint
        self.qr = quad_ref
        self.cfg = cfg
        self.dtype = dtype
        self.n_cmd_steps = n_cmd_steps
        self.foot_handoff = foot_handoff
        if segmented is None:
            segmented = cfg.plan_dur_srb > 0
        model = self.model = mp.wbm.load_model()
        fns = (mp.make_mhpc_fns_segmented(cfg, model) if segmented
               else mp.make_mhpc_fns(cfg, model))
        cb = self._intermtraj_callback if debug_intermtraj else None
        self.solve_init = jax.jit(make_solver(fns, opts,
                                              max_resets=max_resets,
                                              iter_callback=cb))
        self.solve_rt = jax.jit(make_solver(fns, opts.runtime(),
                                            max_resets=max_resets,
                                            iter_callback=cb))
        self.mpc_time = 0.0
        self.state = None
        self.plan_np = None
        self.meta = None
        # solve-time telemetry (MHPCLocomotion.cpp:134-142), milliseconds
        self.last_solve_ms = 0.0
        self.avg_solve_ms = 0.0
        self.max_solve_ms = 0.0
        self._n_solves = 0

    def _build(self):
        return mp.build_mhpc_plan(self.qr, self.cfg)

    def _record_solve_time(self, t0):
        self.last_solve_ms = (_time.perf_counter() - t0) * 1e3
        self._n_solves += 1
        self.avg_solve_ms += (self.last_solve_ms - self.avg_solve_ms) \
            / self._n_solves
        self.max_solve_ms = max(self.max_solve_ms, self.last_solve_ms)

    def _warm_start(self, plan_np, Xbar0, Ubar0):
        """Time-aligned carry-over of the previous solution (the reference
        keeps shifted deques; here old knot times map onto new knots) —
        shared vectorized matcher, runtime/warm_start.py."""
        if self.state is None:
            return Xbar0, Ubar0
        return time_aligned_warm_start(
            self.plan_np.knot, self.mpc_time - self.cfg.dt_mpc,
            np.asarray(self.state.traj.Xbar),
            np.asarray(self.state.traj.Ubar),
            plan_np.knot, self.mpc_time, Xbar0, Ubar0)

    def initialize(self, x0):
        plan_np, pen_np, Xbar0, Ubar0, meta = self._build()
        plan = host_plan_to_device(plan_np, self.dtype)
        pen = jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a), self.dtype), pen_np)
        t0 = _time.perf_counter()
        s = self.solve_init(plan, pen, jnp.asarray(x0, self.dtype),
                            jnp.asarray(Xbar0, self.dtype),
                            jnp.asarray(Ubar0, self.dtype))
        self.state = jax.block_until_ready(s)
        self._record_solve_time(t0)
        self.plan_np, self.meta = plan_np, meta
        self._publish_solver_info()
        return self.command_message()

    def update(self, x_meas, dt=None):
        """dt: actual elapsed MPC time since the last solve (serve() passes
        the delta from the message's mpctime, MHPCLocomotion.cpp:171-172);
        defaults to the nominal dt_mpc."""
        dt = self.cfg.dt_mpc if dt is None else dt
        self.qr.step(dt)
        self.mpc_time += dt
        plan_np, pen_np, Xbar0, Ubar0, meta = self._build()
        Xb, Ub = self._warm_start(plan_np, Xbar0, Ubar0)
        if self.foot_handoff and meta["srb_horizon"] > 0:
            # state entering the WB->SRB model-switch reset (warm-started)
            mp.apply_transition_foot_handoff(
                plan_np, self.cfg, Xb[self.cfg.wb_block - 1], self.model)
        plan = host_plan_to_device(plan_np, self.dtype)
        pen = jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a), self.dtype), pen_np)
        t0 = _time.perf_counter()
        s = self.solve_rt(plan, pen, jnp.asarray(x_meas, self.dtype),
                          jnp.asarray(Xb, self.dtype),
                          jnp.asarray(Ub, self.dtype))
        self.state = jax.block_until_ready(s)
        self._record_solve_time(t0)
        self.plan_np, self.meta = plan_np, meta
        self._publish_solver_info()
        return self.command_message()

    def _intermtraj_callback(self, Xbar, Ubar, it):
        """io_callback target: encode the current nominal trajectory as
        solver_intermtraj_lcmt on "intermediate_ddp_traj"
        (publish_trajectory, MultiPhaseDDP.h:95-107)."""
        if self.endpoint is None:
            return
        X = np.asarray(Xbar, dtype=float)
        U = np.asarray(Ubar, dtype=float)
        msg = w.solver_intermtraj_lcmt(
            tau_sz=X.shape[0], x_sz=X.shape[1], u_sz=U.shape[1])
        msg.x_tau = X
        msg.u_tau = np.concatenate([U, U[-1:]], axis=0)
        self.endpoint.publish("intermediate_ddp_traj", msg)

    def _publish_solver_info(self):
        """solver_info_lcmt telemetry (MHPCLocomotion.cpp:74-79)."""
        if self.endpoint is None:
            return
        st = self.state
        msg = w.solver_info_lcmt(
            n_iter=int(st.info.iters), n_ls_iter=int(st.info.ls_iters),
            n_reg_iter=int(st.info.reg_iters),
            solve_time=self.last_solve_ms,
            cost=float(st.cost), dyn_feas=float(st.feas),
            ineq_violation=float(st.max_pconstr),
            eq_violation=float(st.max_tconstr))
        self.endpoint.publish("DDP_Solver_Info", msg)

    def command_message(self):
        """Build MHPC_Command_lcmt (MHPCLocomotion.cpp:190-287).  Matrix
        fields (Quu/Qux/feedback) are flattened COLUMN-major to match the
        reference's Eigen .data() copies (Eigen defaults to ColMajor)."""
        n = self.n_cmd_steps
        plan = self.plan_np
        tr = self.state.traj
        Xbar = np.asarray(tr.Xbar)
        Ubar = np.asarray(tr.Ubar)
        Y = np.asarray(tr.Y)
        K = np.asarray(tr.K)
        Qu = np.asarray(tr.Qu)
        Quu = np.asarray(tr.Quu)
        Qux = np.asarray(tr.Qux)
        active = np.asarray(plan.step.active) > 0
        is_reset = np.asarray(plan.step.is_reset) > 0
        wb = np.asarray(plan.step.model_id) == 0
        idx = np.where(active & ~is_reset & wb)[0][:n]
        msg = w.MHPC_Command_lcmt(N_mpcsteps=len(idx))
        msg.mpc_times = self.mpc_time + np.asarray(plan.step.t)[idx]
        msg.torque = Ubar[idx]
        msg.pos = Xbar[idx][:, 0:3]
        msg.eul = Xbar[idx][:, 3:6]
        msg.qJ = Xbar[idx][:, 6:18]
        msg.vWorld = Xbar[idx][:, 18:21]
        msg.eulrate = Xbar[idx][:, 21:24]
        msg.qJd = Xbar[idx][:, 24:36]
        msg.GRF = Y[idx]
        msg.feedback = K[idx].transpose(0, 2, 1).reshape(len(idx), -1)
        msg.Qu = Qu[idx]
        msg.Quu = Quu[idx].transpose(0, 2, 1).reshape(len(idx), -1)
        msg.Qux = Qux[idx].transpose(0, 2, 1).reshape(len(idx), -1)
        msg.contacts = np.asarray(plan.step.contact)[idx].astype(np.int32)
        # statusTimes[k] = contact durations of the phase owning step k
        # (MHPCLocomotion.cpp:264, wb_contact_durations)
        status = np.zeros((len(idx), 4))
        for ii, k in enumerate(idx):
            t_k = float(np.asarray(plan.step.t)[k])
            for (ts, te, hor, c) in self.meta["wb_phases"]:
                if ts - 1e-9 <= t_k < te - 1e-9:
                    status[ii] = np.asarray(
                        self.qr.contact_duration_at_t(ts))
                    break
        msg.statusTimes = status
        return msg

    # ---------------- LCM server loop --------------------------------
    def serve(self, endpoint, data_channel="MHPC_DATA",
              cmd_channel="MHPC_COMMAND", max_msgs=None):
        """Blocking MPC service over the wire (MHPCLocomotion::run +
        mpcdata_lcm_handler, MHPCLocomotion.cpp:90-187): consume
        MHPC_Data_lcmt, re-solve, publish MHPC_Command_lcmt.  States that
        arrive while a solve is in flight are superseded — only the newest
        pending state is solved (the reference's detached-thread + mutex
        achieves the same latest-state-wins behavior)."""
        if not hasattr(self, "_n_served"):
            self._n_served = 0
        pending = getattr(self, "_serve_pending", None)
        if pending is None:
            pending = self._serve_pending = []

        def solve_one(msg):
            # x0 assembly (MHPCLocomotion.cpp:163-170):
            # [pos, eul, qJ, vWorld, eulrate, qJd]
            x = np.concatenate([
                np.asarray(msg.pos, dtype=float),
                np.asarray(msg.eul, dtype=float),
                np.asarray(msg.qJ, dtype=float),
                np.asarray(msg.vWorld, dtype=float),
                np.asarray(msg.eulrate, dtype=float),
                np.asarray(msg.qJd, dtype=float)])
            # sync the MPC clock to the robot's (MHPCLocomotion.cpp:171-172)
            t_msg = float(getattr(msg, "mpctime", 0.0))
            delta = t_msg - self.mpc_time
            if msg.reset_mpc or self.state is None:
                if delta > 1e-12:
                    self.qr.step(delta)
                self.mpc_time = t_msg
                cmd = self.initialize(x)
            else:
                cmd = self.update(x, dt=delta if delta > 1e-12 else None)
            endpoint.publish(cmd_channel, cmd)

        subs = getattr(self, "_serve_subs", None)
        if subs is None:
            subs = self._serve_subs = set()
        key = (id(endpoint), data_channel)
        if key not in subs:
            endpoint.subscribe(data_channel, w.MHPC_Data_lcmt,
                               lambda _c, m: pending.append(m))
            subs.add(key)
        if self.endpoint is None:
            self.endpoint = endpoint   # solver-info telemetry channel
        start = self._n_served
        while max_msgs is None or self._n_served - start < max_msgs:
            endpoint.handle(timeout=0.25)
            while endpoint.handle(timeout=0.0):   # drain the queue
                pass
            if pending:
                msg = pending[-1]
                pending.clear()
                solve_one(msg)
                self._n_served += 1
        return self._n_served - start
