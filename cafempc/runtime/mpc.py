"""Receding-horizon MPC runtime for the HKD problem.

Functional equivalent of the reference HKDMPCSolver (HKDMPC/HKDMPC.cpp) +
HKDProblem::update (HKDProblem.cpp:117-222):

  * every dt_mpc, the reference window advances and the flat knot plan is
    rebuilt on the host into the SAME static shapes (the reference instead
    mutates phase deques in place: pop_front / push_back_default / phase
    birth+death — here that becomes a cheap numpy rebuild, so the compiled
    solver never re-specializes),
  * warm starting maps the previous solution onto the new plan by absolute
    knot time within interval-matched phases (the reference gets this for
    free from its shifted deques),
  * the solve runs with the runtime iteration caps (HKDMPC.cpp:102-103),
  * a command tape is extracted mirroring publish_mpc_cmd
    (HKDMPC.cpp:243-298): per-step controls, desired body states, feedback
    gains, contacts, status durations, and next foot placements
    (update_foot_placement, HKDMPC.cpp:207-240).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from cafempc.models import hkd
from cafempc.problems import hkd_problem as hp
from cafempc.reference.quad_reference import QuadReference
from cafempc.solver.hsddp import make_solver
from cafempc.solver.options import SolverOptions
from cafempc.solver.plan import host_plan_to_device
from cafempc.runtime.warm_start import time_aligned_warm_start


@dataclasses.dataclass
class CommandTape:
    """Per-step MPC command (hkd_command_lcmt analogue)."""
    times: np.ndarray          # [n]
    controls: np.ndarray       # [n, 24]
    des_body_state: np.ndarray  # [n, 12]
    feedback: np.ndarray       # [n, 12, 12] gains on the body state
    contacts: np.ndarray       # [n, 4]
    status_times: np.ndarray   # [n, 4]
    foot_placements: np.ndarray  # [12]
    solve_info: dict


class HKDMPCRuntime:
    def __init__(self, quad_ref: QuadReference, cfg: hp.HKDConfig,
                 opts: SolverOptions, dtype=jnp.float64, endpoint=None,
                 debug_intermtraj=False):
        """debug_intermtraj: publish solver_intermtraj_lcmt on the
        reference's "intermediate_ddp_traj" channel after every AL outer
        iteration (MultiPhaseDDP.h:95-107); requires `endpoint`."""
        self.endpoint = endpoint   # optional comms.udpm.LCMEndpoint
        self.qr = quad_ref
        self.cfg = cfg
        self.dtype = dtype
        self.fns = hp.make_hkd_fns()
        cb = self._intermtraj_callback if debug_intermtraj else None
        self.solve_init = jax.jit(make_solver(self.fns, opts,
                                              iter_callback=cb))
        self.solve_rt = jax.jit(make_solver(self.fns, opts.runtime(),
                                            iter_callback=cb))
        self.dt_mpc = cfg.nsteps_between_mpc * cfg.dt_sim
        self.mpc_time = 0.0
        self.state = None
        self.plan_np = None
        self.meta = None
        self.pf = np.zeros((4, 3))
        # solve-time telemetry (MHPCLocomotion.cpp:134-142), milliseconds
        self.last_solve_ms = 0.0
        self.avg_solve_ms = 0.0
        self.max_solve_ms = 0.0
        self._n_solves = 0

    # ---------------- plan / warm start -----------------------------
    def _build(self):
        plan_np, pen_np, Xbar0, Ubar0, meta = hp.build_hkd_plan(
            self.qr, self.cfg)
        return plan_np, pen_np, Xbar0, Ubar0, meta

    def _knot_times_abs(self, plan_np, meta):
        t0 = self.mpc_time
        return t0 + np.asarray(plan_np.knot.t)

    def _warm_start(self, plan_np, meta, Xbar0, Ubar0):
        """Carry (Xbar, Ubar) from the previous solution onto the new plan
        by absolute knot time — the shared vectorized matcher
        (runtime/warm_start.py), same implementation as the MHPC runtime."""
        if self.state is None:
            return Xbar0, Ubar0
        return time_aligned_warm_start(
            self.plan_np.knot, self.mpc_time - self.dt_mpc,
            np.asarray(self.state.traj.Xbar),
            np.asarray(self.state.traj.Ubar),
            plan_np.knot, self.mpc_time, Xbar0, Ubar0)

    # ---------------- MPC steps --------------------------------------
    def _record_solve_time(self, t0):
        import time as _time
        self.last_solve_ms = (_time.perf_counter() - t0) * 1e3
        self._n_solves += 1
        self.avg_solve_ms += (self.last_solve_ms - self.avg_solve_ms) \
            / self._n_solves
        self.max_solve_ms = max(self.max_solve_ms, self.last_solve_ms)

    def initialize(self, x0):
        import time as _time
        plan_np, pen_np, Xbar0, Ubar0, meta = self._build()
        plan = host_plan_to_device(plan_np, self.dtype)
        pen = hp.pen_to_device(pen_np, self.dtype)
        t0 = _time.perf_counter()
        s = self.solve_init(plan, pen, jnp.asarray(x0, self.dtype),
                            jnp.asarray(Xbar0, self.dtype),
                            jnp.asarray(Ubar0, self.dtype))
        self.state = jax.block_until_ready(s)
        self._record_solve_time(t0)
        self.plan_np = plan_np
        self.meta = meta
        self._update_foot_placement()
        self._publish_solver_info()
        return self.command_tape()

    def update(self, x_meas, dt=None):
        """One MPC re-solve at the new measured state (HKDMPC.cpp:97-166).

        dt: actual elapsed MPC time since the previous solve (defaults to
        the nominal dt_mpc).  serve() passes the delta derived from the
        incoming message's mpctime so dropped state messages cannot desync
        the MPC clock / reference window from the robot (HKDMPC.cpp:188
        sets mpc_time from the message)."""
        dt = self.dt_mpc if dt is None else dt
        self.qr.step(dt)
        self.mpc_time += dt
        import time as _time
        plan_np, pen_np, Xbar0, Ubar0, meta = self._build()
        Xb, Ub = self._warm_start(plan_np, meta, Xbar0, Ubar0)
        plan = host_plan_to_device(plan_np, self.dtype)
        pen = hp.pen_to_device(pen_np, self.dtype)
        t0 = _time.perf_counter()
        s = self.solve_rt(plan, pen, jnp.asarray(x_meas, self.dtype),
                          jnp.asarray(Xb, self.dtype),
                          jnp.asarray(Ub, self.dtype))
        self.state = jax.block_until_ready(s)
        self._record_solve_time(t0)
        self.plan_np = plan_np
        self.meta = meta
        self._update_foot_placement()
        self._publish_solver_info()
        return self.command_tape()

    def _intermtraj_callback(self, Xbar, Ubar, it):
        """io_callback target: encode the current nominal trajectory as
        solver_intermtraj_lcmt (publish_trajectory,
        MultiPhaseDDP.h:95-107)."""
        if self.endpoint is None:
            return
        from cafempc.comms import lcm_wire as w
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
        from cafempc.comms import lcm_wire as w
        st = self.state
        msg = w.solver_info_lcmt(
            n_iter=int(st.info.iters), n_ls_iter=int(st.info.ls_iters),
            n_reg_iter=int(st.info.reg_iters),
            solve_time=self.last_solve_ms,
            cost=float(st.cost), dyn_feas=float(st.feas),
            ineq_violation=float(st.max_pconstr),
            eq_violation=float(st.max_tconstr))
        self.endpoint.publish("DDP_Solver_Info", msg)

    # ---------------- outputs ----------------------------------------
    def _update_foot_placement(self):
        """(HKDMPC.cpp:207-240): first future swing->stance transition's
        qdummy is the commanded foothold."""
        phases = self.meta["phases"]
        Xbar = np.asarray(self.state.traj.Xbar)
        j = 0
        found = [False] * 4
        starts = []
        for (ts, te, hor, c) in phases:
            starts.append(j)
            j += hor + 1
        for i in range(len(phases) - 1):
            c = phases[i][3]
            cn = phases[i + 1][3]
            x_start_next = Xbar[starts[i + 1]]
            for leg in range(4):
                if not found[leg] and c[leg] == 0 and cn[leg] == 1:
                    self.pf[leg] = x_start_next[12 + 3 * leg:15 + 3 * leg]
                    found[leg] = True
            if i >= 4:
                break

    def command_message(self, solve_time=0.0):
        """Encode the tape as hkd_command_lcmt (publish_mpc_cmd,
        HKDMPC.cpp:243-298).  The schema carries fixed 10-step arrays;
        shorter tapes pad by repeating the final step."""
        from cafempc.comms import lcm_wire as w
        tape = self.command_tape(n_steps=10)
        n = min(len(tape.times), 10)

        def pad(a, shape):
            out = np.zeros(shape, dtype=float)
            out[:n] = np.asarray(a)[:n]
            if 0 < n < shape[0]:
                out[n:] = out[n - 1]
            return out

        msg = w.hkd_command_lcmt(N_mpcsteps=n)
        msg.mpc_times = pad(tape.times, (10,))
        msg.hkd_controls = pad(tape.controls, (10, 24))
        msg.des_body_state = pad(tape.des_body_state, (10, 12))
        msg.contacts = pad(tape.contacts, (10, 4)).astype(np.int32)
        msg.statusTimes = pad(tape.status_times, (10, 4))
        msg.foot_placement = tape.foot_placements
        msg.feedback = pad(tape.feedback, (10, 12, 12))
        msg.solve_time = solve_time
        return msg

    # ---------------- LCM server loop --------------------------------
    def serve(self, endpoint, data_channel="mpc_data",
              cmd_channel="mpc_command", max_msgs=None):
        """Blocking MPC service over the wire (HKDMPCSolver::run +
        mpcdata_lcm_handler, HKDMPC.cpp:169-205): consume hkd_data_lcmt,
        re-solve, publish hkd_command_lcmt.  States that arrive while a
        solve is in flight are superseded — only the newest pending state
        is solved (the reference's detached-thread + mutex achieves the
        same "latest state wins" behavior).  `max_msgs` bounds the number
        of solves for tests/demos; None = run forever."""
        import time as _time
        from cafempc.comms import lcm_wire as w
        if not hasattr(self, "_n_served"):
            self._n_served = 0
        pending = getattr(self, "_serve_pending", None)
        if pending is None:
            pending = self._serve_pending = []

        def solve_one(msg):
            t0 = _time.perf_counter()
            eul = np.asarray(msg.rpy, dtype=float)[::-1]  # yaw,pitch,roll
            body = np.concatenate([
                eul, np.asarray(msg.p, dtype=float),
                np.asarray(msg.omegaBody, dtype=float),
                np.asarray(msg.vWorld, dtype=float)])
            qdummy = hkd.compute_hkd_state(
                jnp.asarray(body[0:3], self.dtype),
                jnp.asarray(body[3:6], self.dtype),
                jnp.asarray(np.asarray(msg.qJ, dtype=float), self.dtype),
                jnp.asarray(np.asarray(msg.contact, dtype=float),
                            self.dtype))
            x = np.concatenate([body, np.asarray(qdummy)])
            # sync the MPC clock to the robot's (HKDMPC.cpp:188): with
            # latest-state-wins supersession, a dropped message must not
            # leave the reference window behind real time
            t_msg = float(getattr(msg, "mpctime", 0.0))
            delta = t_msg - self.mpc_time
            if msg.reset_mpc or self.state is None:
                if delta > 1e-12:
                    self.qr.step(delta)
                self.mpc_time = t_msg
                self.initialize(x)
            else:
                self.update(x, dt=delta if delta > 1e-12 else None)
            cmd = self.command_message(
                solve_time=_time.perf_counter() - t0)
            endpoint.publish(cmd_channel, cmd)

        subs = getattr(self, "_serve_subs", None)
        if subs is None:
            subs = self._serve_subs = set()
        key = (id(endpoint), data_channel)
        if key not in subs:
            endpoint.subscribe(data_channel, w.hkd_data_lcmt,
                               lambda _c, m: pending.append(m))
            subs.add(key)
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

    def command_tape(self, n_steps=None):
        cfg = self.cfg
        n = n_steps or (cfg.nsteps_between_mpc + 7)  # HKDMPC.cpp:245-246
        plan = self.plan_np
        Xbar = np.asarray(self.state.traj.Xbar)
        Ubar = np.asarray(self.state.traj.Ubar)
        K = np.asarray(self.state.traj.K)
        active = np.asarray(plan.step.active)
        is_reset = np.asarray(plan.step.is_reset)
        dyn_idx = np.where((active > 0) & (is_reset == 0))[0][:n]
        # map each dyn step to its phase for contact/status durations
        # (HKDMPC.cpp:281: statusTimes[k] = contact_durations[phase(k)])
        contacts = np.asarray(plan.step.contact)[dyn_idx]
        status = np.zeros((len(dyn_idx), 4))
        spans, j = [], 0
        for (ts, te, h, c) in self.meta["phases"]:
            spans.append((j, j + h,
                          np.asarray(self.qr.contact_duration_at_t(ts))))
            j += h + 1
        for ii, k in enumerate(dyn_idx):
            for (s0, s1, dur) in spans:
                if s0 <= k < s1:
                    status[ii] = dur
                    break
        info = dict(
            cost=np.asarray(self.state.info.cost_buf[
                :int(self.state.info.n_entries)]),
            dyn_feas=float(self.state.feas),
            eqn_feas=float(self.state.max_tconstr),
            ineq_feas=float(self.state.max_pconstr),
            iters=int(self.state.info.iters))
        return CommandTape(
            times=self.mpc_time + np.arange(len(dyn_idx)) * cfg.dt_sim,
            controls=Ubar[dyn_idx],
            des_body_state=Xbar[dyn_idx][:, :12],
            feedback=K[dyn_idx][:, :12, :12],
            contacts=contacts,
            status_times=status,
            foot_placements=self.pf.reshape(12).copy(),
            solve_info=info)
