"""HS-DDP solver options.

Field-for-field mirror of the reference HSDDP_OPTION struct
(HSDDPSolver/common/HSDDP_CompoundTypes.h:13-55) plus a loader for the
boost-property-tree ``.info`` files the reference ships
(HSDDP_CompoundTypes.h:57-82).  The wall-clock ``max_cputime`` budget of the
reference (MultiPhaseDDP.cpp:291-330) has no analogue under jit; real-time
budgeting is done by the iteration caps (max_*_iter_runtime), which is how
the reference's runtime configs effectively bound the solve anyway.
"""
import dataclasses
import re


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Solver settings; the defaults are the settings of the HKD path
    (bench.py and cafempc/data), this repository's own values."""
    alpha: float = 0.1                 # line-search step shrink factor
    gamma: float = 0.01                # expected-cost-reduction scale
    update_penalty: float = 8.0        # AL sigma growth
    update_relax: float = 0.1          # ReB delta shrink
    update_regularization: float = 2.0
    update_ReB: float = 7.0            # ReB weight growth
    max_DDP_iter: int = 3
    max_AL_iter: int = 2
    max_DDP_iter_runtime: int = 1
    max_AL_iter_runtime: int = 2
    cost_thresh: float = 1e-3
    tconstr_thresh: float = 1e-3
    pconstr_thresh: float = 1e-3
    dynamics_feas_thresh: float = 1e-3
    merit_rho: float = 1e4
    merit_scale: float = 0.2
    merit_offset: float = 10.0
    AL_active: bool = True
    ReB_active: bool = True
    smooth_active: bool = False
    MS: bool = True                    # multiple shooting
    nsteps_per_node: int = 1
    # --- framework extensions (not in the reference struct) ---
    ls_eps_min: float = 1e-3           # line-search termination (MultiPhaseDDP.cpp:108)
    reg_max: float = 1e2               # regularization abort (MultiPhaseDDP.cpp:153)
    reg_min_init: float = 1e-3

    def runtime(self):
        """Runtime-capped variant (MHPCLocomotion.cpp:86-87 pattern)."""
        return dataclasses.replace(
            self, max_DDP_iter=self.max_DDP_iter_runtime,
            max_AL_iter=self.max_AL_iter_runtime)


def load_solver_options(fname: str) -> SolverOptions:
    """Parse the reference's ``ddp_setting.info`` format (a boost
    property-tree info file with a single ``ddp { key value ... }`` block)."""
    txt = open(fname).read()
    body = re.search(r"ddp\s*\{(.*?)\}", txt, re.S)
    if body is None:
        raise ValueError(f"no ddp block in {fname}")
    kv = {}
    for line in body.group(1).splitlines():
        line = line.split(";")[0].strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) != 2:
            continue
        kv[parts[0]] = parts[1]
    def fget(k, d):
        return float(kv.get(k, d))
    def iget(k, d):
        return int(kv.get(k, d))
    def bget(k, d):
        v = kv.get(k)
        if v is None:
            return d
        return v.lower() in ("1", "true")
    o = SolverOptions()
    return SolverOptions(
        alpha=fget("alpha", o.alpha), gamma=fget("gamma", o.gamma),
        update_penalty=fget("update_penalty", o.update_penalty),
        update_relax=fget("update_relax", o.update_relax),
        update_regularization=fget("update_regularization",
                                   o.update_regularization),
        update_ReB=fget("update_ReB", o.update_ReB),
        max_DDP_iter=iget("max_DDP_iter", o.max_DDP_iter),
        max_AL_iter=iget("max_AL_iter", o.max_AL_iter),
        max_DDP_iter_runtime=iget("max_DDP_iter_runtime",
                                  o.max_DDP_iter_runtime),
        max_AL_iter_runtime=iget("max_AL_iter_runtime",
                                 o.max_AL_iter_runtime),
        cost_thresh=fget("cost_thresh", o.cost_thresh),
        tconstr_thresh=fget("tconstr_thresh", o.tconstr_thresh),
        pconstr_thresh=fget("pconstr_thresh", o.pconstr_thresh),
        dynamics_feas_thresh=fget("dynamics_feas_thresh",
                                  o.dynamics_feas_thresh),
        merit_rho=fget("merit_rho", o.merit_rho),
        merit_scale=fget("merit_scale", o.merit_scale),
        merit_offset=fget("merit_offset", o.merit_offset),
        AL_active=bget("AL_active", o.AL_active),
        ReB_active=bget("ReB_active", o.ReB_active),
        smooth_active=bget("smooth_active", o.smooth_active),
        MS=bget("MS", o.MS),
        nsteps_per_node=iget("nsteps_per_node", o.nsteps_per_node),
    )
