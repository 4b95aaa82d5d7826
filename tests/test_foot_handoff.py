"""Transition-frozen foot handoff for the SRB tail (MHPCFootStep.h:26-57):
feet in stance at the WB->SRB handoff carry the solved WB foot XY (frozen
while continuously in contact), others keep reference placements."""
import numpy as np
import jax
import jax.numpy as jnp

from cafempc.models import wbm
from cafempc.problems import mhpc_problem as mp
from cafempc.reference.quad_reference import (QuadReference,
                                              load_quad_reference,
                                              wb_state_ref_at)

GAIT = "/root/reference/Reference/Data/trot/dynfeas/quad_reference.csv"


def test_handoff_overrides_stance_feet():
    qr = QuadReference(load_quad_reference(GAIT))
    qr.initialize(0.5)
    cfg = mp.MHPCConfig(plan_dur_wb=0.1, plan_dur_srb=0.3,
                        n_steps_max=24, wb_block=16)
    plan_np, pen, Xb, Ub, meta = mp.build_mhpc_plan(qr, cfg)
    pf_ref_before = plan_np.step.pf_ref.copy()

    model = wbm.load_model()
    # perturbed transition state -> FK foot XY differs from the reference
    x_tr = np.asarray(wb_state_ref_at(qr, cfg.plan_dur_wb))
    x_tr[0] += 0.05
    pf_fk = np.asarray(wbm.foot_positions(model, jnp.asarray(x_tr)))

    mp.apply_transition_foot_handoff(plan_np, cfg, x_tr, model)

    step = plan_np.step
    N = step.active.shape[0]
    srb = [k for k in range(cfg.wb_block, N)
           if step.active[k] > 0 and step.model_id[k] == 1]
    assert srb
    k0 = srb[0]
    rc0 = np.asarray(step.ref_contact[k0]) > 0
    frozen = rc0.copy()
    changed_any = False
    for k in srb:
        rc = np.asarray(step.ref_contact[k]) > 0
        for leg in range(4):
            sl = slice(3 * leg, 3 * leg + 2)
            if frozen[leg] and rc[leg]:
                # frozen to the SOLVED foot XY, z = ground
                np.testing.assert_allclose(step.pf_ref[k][sl],
                                           pf_fk[leg][:2], atol=1e-12)
                assert step.pf_ref[k][3 * leg + 2] == 0.0
                if abs(pf_ref_before[k][sl][0] - pf_fk[leg][0]) > 1e-6:
                    changed_any = True
            else:
                frozen[leg] = False
                # contact broke (or swing at handoff): reference placement
                np.testing.assert_allclose(step.pf_ref[k][sl],
                                           pf_ref_before[k][sl],
                                           atol=1e-12)
    # the perturbation must actually have shown up somewhere
    assert changed_any
