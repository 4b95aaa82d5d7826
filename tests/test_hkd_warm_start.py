"""HKD warm-start semantics (ADVICE r4, low).

Round 4 replaced the HKD runtime's phase-based warm-start matcher
(overlapping phases with identical contact tuples, knot mapping inside
the matching phase on the dt grid) with the shared time-aligned matcher
(runtime/warm_start.py: absolute knot time + model id, post-reset knot
at duplicated phase-boundary times).  On real HKD plans the two are
equivalent — contact switch times are properties of the reference
schedule, so a time-matched knot always sits in a phase with the same
contact tuple.  This test pins that equivalence directly: the old
matcher is replicated verbatim (from git history, runtime/mpc.py pre
53640e5) and compared against the shared matcher across consecutive
receding-horizon plan rebuilds on gaits with differing/shifting phase
boundaries (bound has flight phases; pace has staggered two-leg phases).
"""
import numpy as np
import pytest

from cafempc.data import hkd_reference
from cafempc.problems import hkd_problem as hp
from cafempc.reference.quad_reference import QuadReference
from cafempc.runtime.warm_start import time_aligned_warm_start


def _phase_based_warm_start(old_meta, old_t0, oXb, oUb,
                            new_meta, new_t0, Xbar0, Ubar0, dt):
    """The pre-round-4 HKD matcher (runtime/mpc.py at 53640e5^),
    phase times normalized to each plan's own t=0 (the convention the
    flat knot layout uses)."""
    Xb = Xbar0.copy()
    Ub = Ubar0.copy()

    def phase_slices(meta_):
        base = meta_["phases"][0][0]
        out = []
        j = 0
        for (ts, te, hor, c) in meta_["phases"]:
            out.append((ts - base, te - base, hor,
                        tuple(int(x) for x in c), j))
            j += hor + 1
        return out

    old_ph = phase_slices(old_meta)
    new_ph = phase_slices(new_meta)
    for (nts, nte, nhor, nc, nj) in new_ph:
        for (ots, ote, ohor, oc, oj) in old_ph:
            o_s, o_e = ots + old_t0, ote + old_t0
            n_s, n_e = nts + new_t0, nte + new_t0
            if oc == nc and n_s < o_e - 1e-9 and o_s < n_e - 1e-9:
                for k in range(nhor + 1):
                    t_abs = n_s + k * dt
                    ko = int(round((t_abs - o_s) / dt))
                    if 0 <= ko <= ohor:
                        Xb[nj + k] = oXb[oj + ko]
                        if k < nhor and ko < ohor:
                            Ub[nj + k] = oUb[oj + ko]
                break
    return Xb, Ub


def _plan_sequence(gait, n_steps, plan_dur=0.5):
    qr = QuadReference(hkd_reference(gait))
    qr.initialize(plan_dur)
    cfg = hp.HKDConfig(plan_duration=plan_dur)
    dt_mpc = cfg.nsteps_between_mpc * cfg.dt_sim
    out = []
    for i in range(n_steps):
        plan_np, _pen, Xb0, Ub0, meta = hp.build_hkd_plan(qr, cfg)
        out.append((plan_np, Xb0, Ub0, meta, i * dt_mpc))
        qr.step(dt_mpc)
    return out, cfg


@pytest.mark.parametrize("gait", ["bound", "pace"])
def test_time_aligned_matches_phase_based(gait):
    plans, cfg = _plan_sequence(gait, n_steps=7)
    rng = np.random.default_rng(3)
    n_checked = 0
    for (old_p, oXb0, oUb0, old_meta, old_t0), \
            (new_p, nXb0, nUb0, new_meta, new_t0) in zip(plans, plans[1:]):
        # a fake "previous solution" distinct per knot so any mapping
        # difference shows up
        oXb = rng.normal(size=oXb0.shape)
        oUb = rng.normal(size=oUb0.shape)
        Xb_new, Ub_new = time_aligned_warm_start(
            old_p.knot, old_t0, oXb, oUb, new_p.knot, new_t0, nXb0, nUb0)
        Xb_old, Ub_old = _phase_based_warm_start(
            old_meta, old_t0, oXb, oUb, new_meta, new_t0, nXb0, nUb0,
            cfg.dt_sim)
        np.testing.assert_allclose(Xb_new, Xb_old, rtol=0, atol=0)
        np.testing.assert_allclose(Ub_new, Ub_old, rtol=0, atol=0)
        # the mapping must actually have carried knots over
        assert not np.allclose(Xb_new, nXb0)
        n_checked += 1
    assert n_checked >= 5
