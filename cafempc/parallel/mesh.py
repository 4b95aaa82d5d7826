"""Scenario-parallel batched solving over device meshes.

The reference's only parallelism is OpenMP over horizon knots inside one
solve (SinglePhase.cpp:265-293).  Here the scaling axis is *batched
scenario parallelism*: thousands of independent HS-DDP solves
(gaits x initial states x disturbance pushes) vmapped on one card and
sharded across a device mesh with `shard_map` — data-parallel over the
"scenario" axis.  Every card reaches every other at the same rate, so the
mesh follows the algorithm alone: a 1-D scenario mesh, or a
(scenario, knot) mesh for the knot-sharded sweep.  Per-scenario inputs are the initial state and the
penalty/plan arrays; the solver itself is replicated closure state.

`make_batched_solver` returns a function mapping stacked per-scenario
inputs -> stacked SolverStates.  With a mesh, inputs must be sharded along
axis 0 in multiples of the device count.
"""
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

from cafempc.solver.hsddp import make_solver


def make_batched_solver(fns, opts, *, all_shooting=True, mesh=None,
                        axis_name="scenario", trim_output=False,
                        knot_axis_name="knot", **solver_kwargs):
    """Returns solve_batch(plan, pen_b, x0_b, Xbar_b, Ubar_b).

    plan is shared (replicated) across scenarios; pen/x0/Xbar/Ubar carry a
    leading scenario axis.  If `mesh` is given, the batch axis is sharded
    over it with shard_map; otherwise plain vmap.

    If `mesh` also has a `knot_axis_name` axis (scenario_knot_mesh), the
    solver's backward Riccati sweep runs knot-sharded across it
    (hsddp.make_solver knot_axis; parallel/knot_riccati.py): scenario DP
    on one mesh axis x sequence-parallel sweep on the other.  Batch
    inputs stay sharded over the scenario axis only (replicated across
    the knot axis); every knot rank computes identical non-sweep stages.
    """
    if mesh is not None and knot_axis_name in mesh.shape \
            and mesh.shape[knot_axis_name] > 1:
        solver_kwargs = dict(solver_kwargs,
                             knot_axis=knot_axis_name,
                             knot_shards=int(mesh.shape[knot_axis_name]))
    solve = make_solver(fns, opts, all_shooting=all_shooting,
                        trim_output=trim_output, **solver_kwargs)
    vsolve = jax.vmap(solve, in_axes=(None, 0, 0, 0, 0))

    if mesh is None:
        return jax.jit(vsolve)

    pspec = P(axis_name)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), pspec, pspec, pspec, pspec),
             out_specs=pspec, check_vma=False)
    def sharded(plan, pen_b, x0_b, Xbar_b, Ubar_b):
        return vsolve(plan, pen_b, x0_b, Xbar_b, Ubar_b)

    return jax.jit(sharded)


def scenario_knot_mesh(n_scenario, n_knot, axis_name="scenario",
                       knot_axis_name="knot"):
    """2D (scenario, knot) mesh: scenario data-parallel solves with the
    backward sweep knot-sharded along the second axis."""
    import numpy as np
    devs = jax.devices()
    need = n_scenario * n_knot
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return Mesh(np.array(devs[:need]).reshape(n_scenario, n_knot),
                (axis_name, knot_axis_name))


def scenario_mesh(n_devices=None, axis_name="scenario"):
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np
    return Mesh(np.array(devs), (axis_name,))


def shard_batch(tree, mesh, axis_name="scenario"):
    """Place a stacked pytree with its leading axis sharded over the mesh."""
    sh = NamedSharding(mesh, P(axis_name))
    return jax.tree.map(lambda a: jax.device_put(a, sh), tree)


def replicate(tree, mesh):
    sh = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, sh), tree)
