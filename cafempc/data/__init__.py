"""In-repo inputs of the HKD-MPC path.

Everything the ``hkd`` configuration reads comes from this package, so the
benchmark, the examples and the tests run from a checkout alone.

* Gaits: generated at first use by `reference/generator.generate_reference`
  with the fixed parameters below and the closed-form mini-cheetah leg IK
  (models/hkd.leg_ik_local).  Generation is deterministic numpy and takes
  well under a second, so no CSV is committed: the parameters are the
  whole input, and a change to the generator shows up in the tests at once.
* Settings: the HKD constraint parameters are the defaults of
  `problems/hkd_problem.HKDConfig` and the solver settings those of
  `solver/options.SolverOptions`.  They are this repository's own values,
  not copies of the reference controller's settings files.
"""
from cafempc.reference.generator import generate_reference
from cafempc.reference.quad_reference import (QuadReferenceData,
                                              cheetah_order)

# Generator parameters per gait: 4 s of motion covers the 1 s bench horizon
# and the receding-horizon runs that step through the reference.  At the
# generator's default 0.24 m body height the HKD touchdown constraints stall
# near 6e-3 m; 0.26 m lets them converge to about 3e-3 m.
GAITS = {
    "bound": dict(gait_name="bound", duration=4.0, vx=0.5, z_des=0.26),
    "pace": dict(gait_name="pace", duration=4.0, vx=0.3, z_des=0.26),
}


def gait_reference(name: str) -> QuadReferenceData:
    """Reference trajectory of a gait in the urdf leg order (FL,FR,HL,HR),
    as MHPC consumes it."""
    if name not in GAITS:
        raise KeyError(f"no in-repo gait {name!r}; have {sorted(GAITS)}")
    return generate_reference(**GAITS[name])


def hkd_reference(name: str) -> QuadReferenceData:
    """The same gait in the Cheetah-Software leg order HKD-MPC uses."""
    return cheetah_order(gait_reference(name))
