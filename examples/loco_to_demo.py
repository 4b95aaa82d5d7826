#!/usr/bin/env python3
"""Loco_TO: standalone whole-body locomotion trajectory optimization
(reference Locomotion/Loco_TO.cpp).  Solves the flypace reference from a
standing crouch at the loco_ddp_setting.info iteration caps and prints the
convergence trace.

  python examples/loco_to_demo.py [--plan-dur 1.0] [--gait flypace]
"""
import argparse
import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--plan-dur", type=float, default=None,
                    help="override plan_dur_wb (default: loco_config.info)")
    ap.add_argument("--gait", default=None)
    ap.add_argument("--max-al", type=int, default=None)
    ap.add_argument("--max-ddp", type=int, default=None)
    args = ap.parse_args()

    from cafempc.problems import loco_problem as lp
    s, plan, meta, qr = lp.solve_loco_to(
        plan_dur=args.plan_dur, gait=args.gait,
        max_AL_iter=args.max_al, max_DDP_iter=args.max_ddp)

    n = int(s.info.n_entries)
    costs = np.asarray(s.info.cost_buf[:n])
    feas = np.asarray(s.info.dyn_feas_buf[:n])
    print(f"success={bool(s.success)}  iters={int(s.info.iters)}  "
          f"ls_iters={int(s.info.ls_iters)}")
    print(f"cost: {costs[0]:.4f} -> {costs[-1]:.4f}")
    print(f"dyn feas: {feas[0]:.3e} -> {feas[-1]:.3e}")
    print(f"max |tconstr|: {float(s.max_tconstr):.3e}   "
          f"min pconstr: {float(s.max_pconstr):.3e}")
    Xbar = np.asarray(s.traj.Xbar)
    act = np.asarray(plan.knot.active) > 0
    print(f"body z range over plan: "
          f"[{Xbar[act][:, 2].min():.3f}, {Xbar[act][:, 2].max():.3f}] m")
    return 0 if bool(s.success) else 1


if __name__ == "__main__":
    sys.exit(main())
