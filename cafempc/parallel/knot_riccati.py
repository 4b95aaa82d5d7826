"""Knot-axis (sequence-parallel) Riccati sweep over a device mesh.

SURVEY section 2.7/5 names horizon-dimension partitioning of the Riccati
recursion as the accelerator analogue of sequence parallelism.  The in-solver
associative-scan sweep (solver/hsddp.py backward_sweep_parallel) already
expresses the backward pass as a suffix composition of linear-fractional
-transform elements — an associative op — so distributing it is a
two-level scan:

  1. each device runs the local associative_scan(reverse=True) over its
     contiguous block of knots (reset transforms compose like any other
     element, so phase boundaries inside OR between blocks are handled
     identically),
  2. one all_gather of the per-block composites (a single LFT element
     each) rides the mesh axis; every device folds the composites of all
     LATER blocks into a tail transform and applies it to its local
     suffixes.

Cost: O(N/P) local work + one P-element collective — the distributed
counterpart of the reference's strictly sequential
SinglePhase::backward_sweep loop (HSDDPSolver/source/SinglePhase.cpp:
323-391).  Correctness vs the sequential recursion is pinned on the
8-device virtual CPU mesh in tests/test_knot_riccati.py.
"""
import jax
import jax.numpy as jnp
from jax import shard_map
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cafempc.solver.hsddp import lft_combine, riccati_lft_elements


def knot_mesh(n_devices=None, axis="knot"):
    devs = jax.devices()[:n_devices] if n_devices else jax.devices()
    return Mesh(np.asarray(devs), (axis,))


def _identity_elem(xs, K, dtype):
    """Identity LFT element (leading dim K): composing it as the later
    factor leaves any element unchanged."""
    I = jnp.broadcast_to(jnp.eye(xs, dtype=dtype), (K, xs, xs))
    z = jnp.zeros((K, xs), dtype)
    zM = jnp.zeros((K, xs, xs), dtype)
    return (I, z, zM, z, zM)


def pad_elements(elems, mult):
    """Pad the knot axis to a multiple of `mult` with identity elements
    (appended after the terminal element — no-ops for every real
    suffix)."""
    N = elems[0].shape[0]
    pad = (-N) % mult
    if pad == 0:
        return elems, N
    ident = _identity_elem(elems[0].shape[-1], pad, elems[0].dtype)
    return tuple(jnp.concatenate([e, p]) for e, p in
                 zip(elems, ident)), N


def suffix_GH_local(e, axis, nP):
    """The per-device body of the two-level suffix scan: `e` is this
    device's contiguous block of LFT elements (5-tuple of [blk, ...]),
    `axis` a mesh axis name bound by an ENCLOSING shard_map (composes
    under vmap — the scenario batch stays a plain batch dim of the
    collectives), nP the static axis size.  Returns this block's
    (G [blk, xs], H [blk, xs, xs])."""
    xs = e[0].shape[-1]
    suf = jax.lax.associative_scan(lft_combine, e, reverse=True)
    block = jax.tree.map(lambda a: a[:1], suf)     # local composite
    blocks = jax.lax.all_gather(block, axis)       # [P, 1, ...]
    idx = jax.lax.axis_index(axis)
    # tail transform: composites of all LATER blocks, folded
    # later-first so T_j = compose(block_j .. block_{P-1})
    T = jax.tree.map(lambda a: a[0], _identity_elem(
        xs, 1, e[0].dtype))
    for j in reversed(range(nP)):
        bj = jax.tree.map(lambda a: a[j, 0], blocks)
        Tj = lft_combine(T, bj)
        use = j > idx
        T = jax.tree.map(
            lambda new, old: jnp.where(use, new, old), Tj, T)
    n_loc = e[0].shape[0]
    Tb = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (n_loc,) + a.shape), T)
    out = lft_combine(Tb, suf)
    return out[3], out[4]


def sharded_suffix_GH(elems, mesh, axis="knot"):
    """(G, H) at every knot from the suffix composition of LFT elements,
    knot axis sharded over `mesh[axis]`.  elems: 5-tuple of [NK, ...]
    arrays with NK divisible by the axis size.  Returns (G [NK, xs],
    H [NK, xs, xs]) sharded the same way."""
    nP = mesh.shape[axis]
    spec = P(axis)
    return shard_map(
        lambda e: suffix_GH_local(e, axis, nP), mesh=mesh,
        in_specs=(tuple(spec for _ in elems),),
        out_specs=(spec, spec))(elems)


def sharded_riccati_GH(A, B, C, D, lx, lu, ly, lxx, luu, lux, lyy,
                       phix, phixx, defect, w, reg, mesh, axis="knot"):
    """Full knot-sharded value sweep: build the LFT elements (shared
    math with the in-solver parallel sweep), pad to the mesh axis, run
    the two-level suffix scan, unpad.  Returns (G, H) [N+1, ...] — the
    same outputs as hsddp's sequential backward sweep."""
    elems, _ = riccati_lft_elements(A, B, C, D, lx, lu, ly, lxx, luu,
                                    lux, lyy, phix, phixx, defect, w,
                                    reg)
    nP = mesh.shape[axis]
    elems_p, N = pad_elements(elems, nP)
    G, H = sharded_suffix_GH(elems_p, mesh, axis)
    G = G[:N]
    H = H[:N]
    G = G.at[0].add(H[0] @ defect[0])
    return G, H
