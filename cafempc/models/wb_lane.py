"""Lane-form (knot-minor) whole-body kinematics + dynamics linearization.

The generic WB LQ path evaluates `vmap(jacfwd)`-style per-knot partials
with the knot axis LEADING, so every intermediate is [..., 18, 18]-ish
with tiny trailing dims.  This module re-expresses the whole-body
linearization in *lane form*: every quantity carries the flattened
scenario x knot axis K as its LAST (lane-minor) axis, small structure
dims lead, and all contractions are explicit multiply+reduce over the
small leading axes — no dot_general, no layout churn, near-zero padding.

Math mirrored 1:1 from models/rbda.py (itself the batched re-design of
the reference's Pinocchio usage + analytical KKT derivative assembly,
MHPC/MHPC-Trajopt/WBM.cpp:368-543):

  * FK over the PX,PY,PZ,RZ,RY,RX + 12-revolute tree,
  * mass matrix from body Jacobians (batched per body),
  * bias force via ONE 18-direction batched jvp of r(q) = M(q) v
    (h = Mdot v - 0.5 d/dq(v^T M v) + g, both terms read off dMv),
  * contact/impulse KKT via unrolled lane Cholesky + Schur complement,
  * the factored-KKT derivative assembly: 18 q-tangents + 18 v-tangents
    through the residual, one multi-RHS application of the factored KKT
    (WBM.cpp:459-505 structure).

Derivative directions are batched (vmap-of-jvp), so the tangent graphs
stay one-op-per-primal-op with a leading direction axis — temps are
[18, ..., K], still lane-minor.

Parity vs the rbda path is pinned in tests/test_wb_lane.py (f64).
"""
import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cafempc.models.urdf import (REVOLUTE, load_urdf_floating_base)
from cafempc.models import wbm

GRAVITY = 9.81


class WBLaneModel(NamedTuple):
    """Host-side numpy topology/constants (no device transfers at trace
    time; jnp constants are minted per-op with the working dtype)."""
    parent: tuple
    jtype: tuple
    axis: np.ndarray        # [nd, 3]
    R_tree: np.ndarray      # [nd, 3, 3]
    p_tree: np.ndarray      # [nd, 3]
    mass: np.ndarray        # [nd]
    com: np.ndarray         # [nd, 3]
    inertia: np.ndarray     # [nd, 3, 3]
    frame_dof: tuple
    frame_R: np.ndarray     # [nf, 3, 3]
    frame_p: np.ndarray     # [nf, 3]
    mb_idx: np.ndarray      # massy body indices
    ancestors: np.ndarray   # [nd, nd] bool

    @property
    def nd(self):
        return len(self.parent)


@functools.lru_cache(maxsize=4)
def load_lane_model(urdf_path=wbm.DEFAULT_URDF) -> WBLaneModel:
    tree = load_urdf_floating_base(urdf_path)
    nd = tree.nd
    anc = np.zeros((nd, nd), dtype=bool)
    for i in range(nd):
        j = i
        while j >= 0:
            anc[i, j] = True
            j = int(tree.parent[j])
    has_mass = [bool(m > 0 or np.any(I))
                for m, I in zip(tree.mass, tree.inertia)]
    return WBLaneModel(
        parent=tuple(int(p) for p in tree.parent),
        jtype=tuple(int(t) for t in tree.jtype),
        axis=np.asarray(tree.axis, float),
        R_tree=np.asarray(tree.R_tree, float),
        p_tree=np.asarray(tree.p_tree, float),
        mass=np.asarray(tree.mass, float),
        com=np.asarray(tree.com, float),
        inertia=np.asarray(tree.inertia, float),
        frame_dof=tuple(int(f[1]) for f in tree.frames),
        frame_R=np.stack([np.asarray(f[2], float) for f in tree.frames]),
        frame_p=np.stack([np.asarray(f[3], float) for f in tree.frames]),
        mb_idx=np.asarray([b for b in range(nd) if has_mass[b]]),
        ancestors=anc)


# ------------------------------------------------------------------
# lane algebra helpers: [..., a, b, K] arrays, K minor
# ------------------------------------------------------------------

def lanedot(A, B):
    """[..., a, c, K] @ [..., c, b, K] -> [..., a, b, K] via explicit
    multiply + reduce (keeps K lane-minor; no dot_general)."""
    return (A[..., :, :, None, :] * B[..., None, :, :, :]).sum(-3)


def lanemv(A, x):
    """[..., a, b, K] @ [..., b, K] -> [..., a, K]."""
    return (A * x[..., None, :, :]).sum(-2)


def lanecross(a, b):
    """[..., 3, K] x [..., 3, K] (cross along the 3-axis)."""
    a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return jnp.stack([a1 * b2 - a2 * b1,
                      a2 * b0 - a0 * b2,
                      a0 * b1 - a1 * b0], axis=-2)


def laneT(A):
    """Transpose the two structure axes of [..., a, b, K]."""
    return jnp.swapaxes(A, -3, -2)


def jac_lane(f, x):
    """Batched forward-mode Jacobian of a lane-form function: f maps
    x [n, K] -> [..., K]; returns [n, ..., K] with the direction axis
    leading.  ONE traced jvp with a vmapped tangent — tangent temps are
    [n, ..., K], lane-minor."""
    n = x.shape[0]
    basis = jnp.eye(n, dtype=x.dtype)

    def one(e):
        t = jnp.broadcast_to(e[:, None], x.shape)
        return jax.jvp(f, (x,), (t,))[1]
    return jax.vmap(one)(basis)


def lane_cholesky(M):
    """Unrolled Cholesky of [n, n, K] SPD matrices (lane-batched).
    Returns the lower factor as a list-of-lists of [K] lanes."""
    n = M.shape[0]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(s)
        L[j][j] = d
        inv = 1.0 / d
        for i in range(j + 1, n):
            s2 = M[i, j]
            for k in range(j):
                s2 = s2 - L[i][k] * L[j][k]
            L[i][j] = s2 * inv
    return L


def lane_cho_solve(L, B):
    """Solve (L L^T) X = B for B [n, m, K] given the unrolled factor."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = B[i]
        for k in range(i):
            s = s - L[i][k][None, :] * y[k]
        y[i] = s / L[i][i][None, :]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i][None, :] * x[k]
        x[i] = s / L[i][i][None, :]
    return jnp.stack(x, axis=0)


# ------------------------------------------------------------------
# kinematics
# ------------------------------------------------------------------

def _rot_axis_lane(axis_np, q):
    """Rodrigues rotation about a constant unit axis; q [K] -> [3, 3, K]."""
    c, s = jnp.cos(q), jnp.sin(q)
    Kx = np.array([[0, -axis_np[2], axis_np[1]],
                   [axis_np[2], 0, -axis_np[0]],
                   [-axis_np[1], axis_np[0], 0]])
    KK = Kx @ Kx
    I = np.eye(3)
    return (jnp.asarray(I[:, :, None], q.dtype)
            + jnp.asarray(Kx[:, :, None], q.dtype) * s[None, None, :]
            + jnp.asarray(KK[:, :, None], q.dtype) * (1 - c)[None, None, :])


def fk_lane(m: WBLaneModel, q):
    """Lane-form FK: q [nd, K] -> (R [nd,3,3,K], p [nd,3,K], aw [nd,3,K]),
    mirroring rbda.fk."""
    K = q.shape[-1]
    dtype = q.dtype
    Rs, ps, aw = [], [], []
    for i in range(m.nd):
        pi = m.parent[i]
        if pi >= 0:
            Rp, pp = Rs[pi], ps[pi]
            R_pre = lanedot(Rp, jnp.asarray(m.R_tree[i][:, :, None], dtype))
            p_i = pp + lanemv(Rp, jnp.asarray(m.p_tree[i][:, None], dtype))
        else:
            R_pre = jnp.broadcast_to(
                jnp.asarray(m.R_tree[i][:, :, None], dtype), (3, 3, K))
            p_i = jnp.broadcast_to(
                jnp.asarray(m.p_tree[i][:, None], dtype), (3, K))
        if m.jtype[i] == REVOLUTE:
            R_i = lanedot(R_pre, _rot_axis_lane(m.axis[i], q[i]))
        else:
            R_i = R_pre
            p_i = p_i + lanemv(R_pre, jnp.asarray(m.axis[i][:, None],
                                                  dtype)) * q[i][None, :]
        a_i = lanemv(R_pre, jnp.asarray(m.axis[i][:, None], dtype))
        Rs.append(R_i)
        ps.append(p_i)
        aw.append(a_i)
    return jnp.stack(Rs), jnp.stack(ps), jnp.stack(aw)


def _rev_mask(m):
    return np.array([1.0 if t == REVOLUTE else 0.0 for t in m.jtype])


def _point_jacobians_lane(m, p, aw, points, dofs):
    """Linear world Jacobians of points [np_, 3, K] attached to bodies
    `dofs`.  Returns Jv [np_, 3, nd, K] (rbda._point_jacobians_batch)."""
    dtype = points.dtype
    anc = np.asarray(m.ancestors[np.asarray(dofs)], float)  # [np_, nd]
    rev = _rev_mask(m)                                      # [nd]
    d = points[:, None, :, :] - p[None, :, :, :]            # [np_,nd,3,K]
    cr = lanecross(jnp.broadcast_to(aw[None], d.shape), d)  # [np_,nd,3,K]
    cols = jnp.asarray(rev[None, :, None, None], dtype) * cr \
        + jnp.asarray((1.0 - rev)[None, :, None, None], dtype) * aw[None]
    cols = cols * jnp.asarray(anc[:, :, None, None], dtype)
    return jnp.transpose(cols, (0, 2, 1, 3))                # [np_,3,nd,K]


def _body_jacobians_lane(m, R, p, aw):
    """CoM world positions + Jacobians + world inertias for every massy
    body (rbda._body_jacobians, lane form).  Returns
    (com_w [nb,3,K], Jw [nb,3,nd,K], Jv [nb,3,nd,K], Iw [nb,3,3,K])."""
    dtype = p.dtype
    mb = m.mb_idx
    Rb = R[mb]                                              # [nb,3,3,K]
    com_w = p[mb] + lanemv(Rb, jnp.asarray(m.com[mb][:, :, None], dtype))
    Jv = _point_jacobians_lane(m, p, aw, com_w, list(mb))
    anc = np.asarray(m.ancestors[mb], float)                # [nb, nd]
    rev = _rev_mask(m)
    Jw = jnp.transpose(
        (jnp.asarray(rev[None, :, None, None], dtype) * aw[None])
        * jnp.asarray(anc[:, :, None, None], dtype), (0, 2, 1, 3))
    Ic = jnp.asarray(m.inertia[mb][:, :, :, None], dtype)   # [nb,3,3,1]
    Iw = lanedot(lanedot(Rb, Ic), laneT(Rb))
    return com_w, Jw, Jv, Iw


def mass_matrix_lane(m: WBLaneModel, q):
    """M(q) [nd, nd, K] = sum_b Jw^T Iw Jw + mass Jv^T Jv, accumulated
    per body to bound temporaries at [3, nd, nd, K]."""
    R, p, aw = fk_lane(m, q)
    com_w, Jw, Jv, Iw = _body_jacobians_lane(m, R, p, aw)
    nb = len(m.mb_idx)
    M = jnp.zeros((m.nd, m.nd, q.shape[-1]), q.dtype)
    for b in range(nb):
        IwJw = lanedot(Iw[b], Jw[b])                       # [3, nd, K]
        M = M + (Jw[b][:, :, None, :] * IwJw[:, None, :, :]).sum(0)
        M = M + float(m.mass[m.mb_idx[b]]) \
            * (Jv[b][:, :, None, :] * Jv[b][:, None, :, :]).sum(0)
    return M


def gravity_force_lane(m: WBLaneModel, q):
    """g(q) [nd, K] (rbda.gravity_force)."""
    R, p, aw = fk_lane(m, q)
    com_w, Jw, Jv, Iw = _body_jacobians_lane(m, R, p, aw)
    mass = np.asarray(m.mass[m.mb_idx])
    # -sum_b m_b Jv_b^T [0,0,-g] = g * sum_b m_b Jv_b[z-row]
    return GRAVITY * (jnp.asarray(mass[:, None, None], q.dtype)
                      * Jv[:, 2, :, :]).sum(0)


def Mv_lane(m: WBLaneModel, q, v):
    """r(q) = M(q) v with v held constant, contracted PER BODY —
    sum_b Jw^T (Iw (Jw v)) + mass Jv^T (Jv v).  Never materializes the
    full M, so q-tangents through it stay [dirs, nb, 3, nd, K] instead
    of [dirs, nd, nd, K] x inner-tangent blowup (the OOM source when
    the residual Jacobian differentiates M qdd at the cascade batch)."""
    R, p, aw = fk_lane(m, q)
    com_w, Jw, Jv, Iw = _body_jacobians_lane(m, R, p, aw)
    wb = lanemv(Jw, v)                                     # [nb, 3, K]
    vb = lanemv(Jv, v)
    Lb = lanemv(Iw, wb)
    mass = np.asarray(m.mass[m.mb_idx])
    r = (Jw * Lb[:, :, None, :]).sum((0, 1))
    r = r + (jnp.asarray(mass[:, None, None, None], q.dtype)
             * Jv * vb[:, :, None, :]).sum((0, 1))
    return r


def bias_force_lane(m: WBLaneModel, q, v):
    """h(q, v) = C v + g via Jacobian-transpose Newton-Euler with
    qdd = 0 (the structure Pinocchio's RNEA derivatives exploit,
    WBM.cpp:459-505 upstream):

        h = sum_b [ Jv_b^T m_b a_b + Jw_b^T (dIw_b/dt w_b + Iw_b wdot_b) ]
            + g(q),
        a_b = (dJv_b/dt) v,  wdot_b = (dJw_b/dt) v   (qdd = 0),

    with every d/dt a single jvp along v.  Crucially h is FIRST-order in
    FK derivatives, so the factored-KKT residual Jacobian (which
    differentiates h once more) only ever needs second FK derivatives of
    [nb, 3, nd, K] objects — the full d2M/dq2 never exists."""
    def bundle(q_):
        R, p, aw = fk_lane(m, q_)
        com_w, Jw, Jv, Iw = _body_jacobians_lane(m, R, p, aw)
        return Jw, Jv, Iw
    (Jw, Jv, Iw), (dJw, dJv, dIw) = jax.jvp(bundle, (q,), (v,))
    wb = lanemv(Jw, v)
    wdot = lanemv(dJw, v)
    ab = lanemv(dJv, v)
    dLdt = lanemv(dIw, wb) + lanemv(Iw, wdot)              # [nb, 3, K]
    mass = np.asarray(m.mass[m.mb_idx])
    h = (Jw * dLdt[:, :, None, :]).sum((0, 1))
    h = h + (jnp.asarray(mass[:, None, None, None], q.dtype)
             * Jv * ab[:, :, None, :]).sum((0, 1))
    return h + gravity_force_lane(m, q)


def foot_points_lane(m: WBLaneModel, R, p):
    """End-effector frame origins [nf, 3, K]."""
    fidx = np.asarray(m.frame_dof)
    dtype = p.dtype
    return p[fidx] + lanemv(R[fidx],
                            jnp.asarray(m.frame_p[:, :, None], dtype))


def foot_jacobians_lane(m: WBLaneModel, q):
    """[nf, 3, nd, K] linear world foot Jacobians."""
    R, p, aw = fk_lane(m, q)
    pts = foot_points_lane(m, R, p)
    return _point_jacobians_lane(m, p, aw, pts, list(m.frame_dof))


def foot_positions_lane(m: WBLaneModel, q):
    R, p, aw = fk_lane(m, q)
    return foot_points_lane(m, R, p)


def foot_velocities_lane(m: WBLaneModel, q, v):
    """[nf, 3, K]."""
    return lanemv(foot_jacobians_lane(m, q), v)


def foot_drift_lane(m: WBLaneModel, q, v):
    """Jdot(q, v) v [nf, 3, K] via jvp along v (rbda.foot_drift)."""
    return jax.jvp(lambda q_: foot_velocities_lane(m, q_, v), (q,), (v,))[1]


# ------------------------------------------------------------------
# closed-form FK directional derivatives (ancestor cross-product rules)
# ------------------------------------------------------------------
#
# Every world-frame FK quantity has an exact first derivative in q:
#
#   d aw_i / dq_j  = anc(i,j) rev_j (aw_j x aw_i)
#   d pt   / dq_j  = anc(body(pt),j) [rev_j aw_j x (pt - p_j)
#                                     + (1-rev_j) aw_j]      (any point)
#   d Iw_b / dq_j  = anc(b,j) rev_j ([aw_j]x Iw_b - Iw_b [aw_j]x)
#   d Jcol(pt,l)/dq_j = anc(body(pt),l) { rev_l [ daw[j,l] x (pt - p_l)
#                         + aw_l x (dpt[j] - dp[j,l]) ]
#                         + (1-rev_l) daw[j,l] }             (product rule)
#
# (full ancestor masks: the j = i diagonal terms vanish identically for
# revolute joints via a x a = 0 and are correct for prismatic ones).
# These replace the 18-direction batched jvp through the KKT residual
# (PERF.md roadmap #2): the tangent work becomes flat masked
# cross-products over (dirs x bodies) instead of 18 re-traversals of the
# sequential FK tree, and ALL time-derivatives — including the mixed
# second derivatives d/dt(dJ/dq_j) the bias-force tangents need — come
# from ONE jvp of this bundle along v (mixed partials commute).
# Reference correspondence: WBM.cpp:459-543 (the analytical derivative
# assembly these rules feed) and Pinocchio's RNEA-derivative structure.


class _CFBundle(NamedTuple):
    """Primal FK quantities + their [18, ...] q-derivative stacks."""
    p: jnp.ndarray        # [nd, 3, K] joint origins
    aw: jnp.ndarray       # [nd, 3, K] world joint axes
    pts: jnp.ndarray      # [nf, 3, K] foot points
    com: jnp.ndarray      # [nb, 3, K]
    Iw: jnp.ndarray       # [nb, 3, 3, K]
    Jw: jnp.ndarray       # [nb, 3, nd, K]
    Jv: jnp.ndarray       # [nb, 3, nd, K]
    J: jnp.ndarray        # [nf, 3, nd, K] foot point Jacobians
    daw: jnp.ndarray      # [nd(j), nd, 3, K]
    dp: jnp.ndarray       # [nd(j), nd, 3, K]
    dpts: jnp.ndarray     # [nd(j), nf, 3, K]
    dcom: jnp.ndarray     # [nd(j), nb, 3, K]
    dIw: jnp.ndarray      # [nd(j), nb, 3, 3, K]
    dJw: jnp.ndarray      # [nd(j), nb, 3, nd, K]
    dJv: jnp.ndarray      # [nd(j), nb, 3, nd, K]
    dJ: jnp.ndarray       # [nd(j), nf, 3, nd, K]


def _dpoint(aw, pts, p, anc_pts, rev):
    """d pt / dq_j for points pts [np_,3,K] with ancestor mask
    anc_pts [np_, nd].  Returns [nd(j), np_, 3, K]."""
    dtype = pts.dtype
    d = pts[None, :, :, :] - p[:, None, :, :]          # [j, np_, 3, K]
    cr = lanecross(jnp.broadcast_to(aw[:, None], d.shape), d)
    out = jnp.asarray(rev[:, None, None, None], dtype) * cr \
        + jnp.asarray((1.0 - rev)[:, None, None, None], dtype) \
        * aw[:, None, :, :]
    return out * jnp.asarray(anc_pts.T[:, :, None, None], dtype)


def _dpoint_jac(m, aw, daw, dp, pts, dpts, p, anc_pts, rev):
    """d Jcol(pt, l) / dq_j: [nd(j), np_, 3, nd(l), K] via the product
    rule on the primal point-Jacobian formula."""
    dtype = pts.dtype
    nd = m.nd
    # rev_l [ daw[j,l] x (pt - p_l) + aw_l x (dpt[j] - dp[j,l]) ]
    d_pl = pts[None, None] - p[None, :, None]          # [1, l, np_, 3, K]
    daw_jl = daw[:, :, None, :, :]                     # [j, l, 1, 3, K]
    t1 = lanecross(jnp.broadcast_to(daw_jl,
                                    daw_jl.shape[:2] + d_pl.shape[2:]),
                   jnp.broadcast_to(d_pl, daw_jl.shape[:2]
                                    + d_pl.shape[2:]))
    dd = dpts[:, None, :, :, :] - dp[:, :, None, :, :]  # [j, l, np_, 3, K]
    aw_l = jnp.broadcast_to(aw[None, :, None, :, :], dd.shape)
    t2 = lanecross(aw_l, dd)
    out = jnp.asarray(rev[None, :, None, None, None], dtype) * (t1 + t2) \
        + jnp.asarray((1.0 - rev)[None, :, None, None, None], dtype) \
        * daw_jl
    out = out * jnp.asarray(anc_pts.T[None, :, :, None, None], dtype)
    # [j, l, np_, 3, K] -> [j, np_, 3, l, K]
    return jnp.transpose(out, (0, 2, 3, 1, 4))


def cf_bundle(m: WBLaneModel, q) -> _CFBundle:
    """Primal FK + closed-form first-derivative stacks, lane form."""
    dtype = q.dtype
    nd = m.nd
    R, p, aw = fk_lane(m, q)
    pts = foot_points_lane(m, R, p)
    com_w, Jw, Jv, Iw = _body_jacobians_lane(m, R, p, aw)
    J = _point_jacobians_lane(m, p, aw, pts, list(m.frame_dof))
    rev = _rev_mask(m)
    anc = np.asarray(m.ancestors, float)               # [i, j]
    anc_f = np.asarray(m.ancestors[np.asarray(m.frame_dof)], float)
    anc_b = np.asarray(m.ancestors[m.mb_idx], float)

    # daw[j, i] = anc(i,j) rev_j (aw_j x aw_i)
    cr = lanecross(jnp.broadcast_to(aw[:, None], (nd, nd, 3, q.shape[-1])),
                   jnp.broadcast_to(aw[None, :], (nd, nd, 3, q.shape[-1])))
    daw = cr * jnp.asarray((rev[:, None] * anc.T)[:, :, None, None],
                           dtype)
    dp = _dpoint(aw, p, p, anc, rev)
    dpts = _dpoint(aw, pts, p, anc_f, rev)
    dcom = _dpoint(aw, com_w, p, anc_b, rev)

    # dIw[j, b] = anc(b,j) rev_j ( [aw_j]x Iw_b - Iw_b [aw_j]x );
    # with Iw symmetric, [a]x Iw - Iw [a]x = axI + axI^T where
    # axI = [a]x Iw (cross each column)
    K = q.shape[-1]
    nb = Iw.shape[0]
    Iw_cols = jnp.broadcast_to(jnp.swapaxes(Iw[None], -3, -2),
                               (nd, nb, 3, 3, K))      # [j, b, c, r, K]
    a_bc = jnp.broadcast_to(aw[:, None, None, :, :], (nd, nb, 3, 3, K))
    axI = jnp.swapaxes(lanecross(a_bc, Iw_cols), -3, -2)
    mask_jb = jnp.asarray((rev[:, None] * anc_b.T)[:, :, None, None,
                                                   None], dtype)
    dIw = (axI + jnp.swapaxes(axI, -3, -2)) * mask_jb

    # dJw[j, b, :, l] = anc(b,l) rev_l daw[j, l]
    wmask = jnp.asarray((anc_b * rev[None, :])[None, :, None, :, None],
                        dtype)
    dJw = jnp.transpose(daw, (0, 2, 1, 3))[:, None, :, :, :] * wmask
    dJv = _dpoint_jac(m, aw, daw, dp, com_w, dcom, p, anc_b, rev)
    dJ = _dpoint_jac(m, aw, daw, dp, pts, dpts, p, anc_f, rev)
    return _CFBundle(p, aw, pts, com_w, Iw, Jw, Jv, J,
                     daw, dp, dpts, dcom, dIw, dJw, dJv, dJ)

# --- bundle-contraction helpers (dirs axis j leading) --------------

def _dmv(dT, x):
    """[j, b, 3, nd, K] applied to x [nd, K] -> [j, b, 3, K]."""
    return (dT * x[None, None, None, :, :]).sum(-2)


def _dmtv_b(dT, y):
    """[j, b, 3, nd, K] transpose-applied to y [b, 3, K], summed over
    bodies -> [j, nd, K]."""
    return (dT * y[None, :, :, None, :]).sum((1, 2))


def _wtv(W, y):
    """[b, 3, nd, K] transpose-applied to y [j, b, 3, K], summed over
    bodies -> [j, nd, K]."""
    return (W[None] * y[:, :, :, None, :]).sum((1, 2))


def _mass_from_bundle(m, cf):
    """M(q) from the CF bundle (mass_matrix_lane without re-running
    FK)."""
    M = jnp.zeros((m.nd, m.nd, cf.p.shape[-1]), cf.p.dtype)
    for b in range(len(m.mb_idx)):
        IwJw = lanedot(cf.Iw[b], cf.Jw[b])
        M = M + (cf.Jw[b][:, :, None, :] * IwJw[:, None, :, :]).sum(0)
        M = M + float(m.mass[m.mb_idx[b]]) \
            * (cf.Jv[b][:, :, None, :] * cf.Jv[b][:, None, :, :]).sum(0)
    return M


def _mv_from_bundle(m, cf, v):
    """M(q) v per-body from the CF bundle (Mv_lane without re-running
    FK)."""
    dtype = cf.p.dtype
    mw = jnp.asarray(np.asarray(m.mass[m.mb_idx])[:, None, None], dtype)
    wb = lanemv(cf.Jw, v)
    vb = lanemv(cf.Jv, v)
    Lb = lanemv(cf.Iw, wb)
    r = (cf.Jw * Lb[:, :, None, :]).sum((0, 1))
    return r + (mw[..., None] * cf.Jv * vb[:, :, None, :]).sum((0, 1))


def _cf_dMv(m, cf, u):
    """d/dq_j [M(q) u] for constant u, per-body contraction on the CF
    bundle (the full dM/dq never exists).  Returns [j, nd, K]."""
    dtype = cf.p.dtype
    mw = jnp.asarray(np.asarray(m.mass[m.mb_idx])[:, None, None], dtype)
    wu = lanemv(cf.Jw, u)
    Lu = lanemv(cf.Iw, wu)
    vu = lanemv(cf.Jv, u)
    return (_dmtv_b(cf.dJw, Lu)
            + _wtv(cf.Jw, lanemv(cf.dIw, wu[None])
                   + lanemv(cf.Iw[None], _dmv(cf.dJw, u)))
            + _dmtv_b(cf.dJv, mw * vu)
            + _wtv(cf.Jv, mw[None] * _dmv(cf.dJv, u)))


def _cf_primal(m, cf, td, v, bg_alpha):
    """Primal KKT pieces from the CF bundle + its v-jvp: (M, h,
    J [12,nd,K], Jdot [12,nd,K], gamma_raw [12,K]).  h is assembled
    exactly as bias_force_lane (Jacobian-transpose Newton-Euler with
    qdd = 0): h = sum_b m_b Jv^T a_b + Jw^T (Iwdot w_b + Iw wdot_b) + g."""
    dtype = cf.p.dtype
    nd = m.nd
    K = cf.p.shape[-1]
    mass = np.asarray(m.mass[m.mb_idx])
    mw = jnp.asarray(mass[:, None, None], dtype)        # [b, 1, 1]
    J = cf.J.reshape(12, nd, K)
    Jdot = td.J.reshape(12, nd, K)
    w_b = lanemv(cf.Jw, v)                              # [b, 3, K]
    wdot = lanemv(td.Jw, v)
    a_b = lanemv(td.Jv, v)
    dLdt = lanemv(td.Iw, w_b) + lanemv(cf.Iw, wdot)
    g = GRAVITY * (mw * cf.Jv[:, 2, :, :]).sum(0)
    h = (cf.Jw * dLdt[:, :, None, :]).sum((0, 1)) \
        + (mw[..., None] * cf.Jv * a_b[:, :, None, :]).sum((0, 1)) + g
    gamma_raw = lanemv(Jdot, v) + 2.0 * bg_alpha * lanemv(J, v)
    return _mass_from_bundle(m, cf), h, J, Jdot, gamma_raw


def _cf_tangents(m, cf, td, v, qdd, z_l, cmask3, bg_alpha):
    """Closed-form q- and v-tangent stacks of the contact-KKT residual,
    replacing the two 18-direction jac_lane calls (PERF.md roadmap #2).

    Returns (dG_dq [nd, nd+12, K], dG_dv [nd, nd+12, K]).  ALL
    time-derivative quantities, including the MIXED second derivatives
    d/dt(dJ/dq_j) the bias-force tangents need, come from the one jvp
    of cf_bundle along v (td): mixed partials commute, so the v-jvp of
    the closed-form first-derivative stacks IS the q-derivative of the
    time-derivative stacks."""
    dtype = cf.p.dtype
    nd = m.nd
    K = cf.p.shape[-1]
    mass = np.asarray(m.mass[m.mb_idx])
    mw = jnp.asarray(mass[:, None, None], dtype)        # [b, 1, 1]

    J = cf.J.reshape(12, nd, K)
    Jdot = td.J.reshape(12, nd, K)
    dJ = cf.dJ.reshape(nd, 12, nd, K)
    dJdot = td.dJ.reshape(nd, 12, nd, K)
    w_b = lanemv(cf.Jw, v)
    wdot = lanemv(td.Jw, v)
    a_b = lanemv(td.Jv, v)
    dLdt = lanemv(td.Iw, w_b) + lanemv(cf.Iw, wdot)

    # ---- q-tangents: top = d[M qdd] + dh + dJm^T z ----------------
    dMv = _cf_dMv(m, cf, qdd)

    dw = _dmv(cf.dJw, v)                                # [j, b, 3, K]
    dwdot = _dmv(td.dJw, v)
    dA = _dmv(td.dJv, v)
    # sum over bodies of m_b * z-row of dJv
    dg = GRAVITY * (jnp.asarray(mass[None, :, None, None], dtype)
                    * cf.dJv[:, :, 2, :, :]).sum(1)     # [j, nd, K]
    dh = (_dmtv_b(cf.dJw, dLdt)
          + _wtv(cf.Jw, lanemv(td.dIw, w_b[None])
                 + lanemv(td.Iw[None], dw)
                 + lanemv(cf.dIw, wdot[None])
                 + lanemv(cf.Iw[None], dwdot))
          + _dmtv_b(cf.dJv, mw * a_b)
          + _wtv(cf.Jv, mw[None] * dA)
          + dg)

    dJm = dJ * cmask3[None, :, None, :]                 # [j, 12, nd, K]
    dJmT_z = (dJm * z_l[None, :, None, :]).sum(1)       # [j, nd, K]
    top_q = dMv + dh + dJmT_z
    dgamma = ((dJdot * v[None, None, :, :]).sum(2)
              + 2.0 * bg_alpha * (dJ * v[None, None, :, :]).sum(2)) \
        * cmask3[None]
    bot_q = (dJm * qdd[None, None, :, :]).sum(2) + dgamma
    dG_dq = jnp.concatenate([top_q, bot_q], axis=1)     # [j, nd+12, K]

    # ---- v-tangents ----------------------------------------------
    # dh/dv_j = sum_b m_b Jv^T (dJv[j] v + Jvdot[:, :, j])
    #         + Jw^T ( dIw[j] w_b + Iwdot Jw[:, :, j]
    #                  + Iw (dJw[j] v + Jwdot[:, :, j]) )
    Jw_col = jnp.transpose(cf.Jw, (2, 0, 1, 3))         # [j, b, 3, K]
    Jwdot_col = jnp.transpose(td.Jw, (2, 0, 1, 3))
    Jvdot_col = jnp.transpose(td.Jv, (2, 0, 1, 3))
    inner = (lanemv(cf.dIw, w_b[None])
             + lanemv(td.Iw[None], Jw_col)
             + lanemv(cf.Iw[None], dw + Jwdot_col))
    dh_dv = (_wtv(cf.Jw, inner)
             + _wtv(cf.Jv, mw[None] * (_dmv(cf.dJv, v) + Jvdot_col)))
    dgamma_dv = ((dJ * v[None, None, :, :]).sum(2)
                 + jnp.transpose(Jdot, (1, 0, 2))
                 + 2.0 * bg_alpha * jnp.transpose(J, (1, 0, 2))) \
        * cmask3[None]
    dG_dv = jnp.concatenate([dh_dv, dgamma_dv], axis=1)
    return dG_dq, dG_dv


def _kkt_schur_solve_lane(M, Jm, Sdiag, r1, r2):
    """Lane-form Schur-complement KKT solve (rbda._kkt_schur_solve):
    M [nd,nd,K] SPD, Jm [12,nd,K], Sdiag [12,K], r1 [nd,m,K],
    r2 [12,m,K].  Returns (a [nd,m,K], b [12,m,K])."""
    Lm = lane_cholesky(M)
    MinvJT = lane_cho_solve(Lm, laneT(Jm))                 # [nd, 12, K]
    Minv_r1 = lane_cho_solve(Lm, r1)                       # [nd, m, K]
    A_s = lanedot(Jm, MinvJT)                              # [12, 12, K]
    A_s = A_s + jnp.asarray(np.eye(12)[:, :, None], M.dtype) \
        * Sdiag[:, None, :]
    Ls = lane_cholesky(A_s)
    b = lane_cho_solve(Ls, lanedot(Jm, Minv_r1) - r2)      # [12, m, K]
    a = Minv_r1 - lanedot(MinvJT, b)
    return a, b


def contact_kkt_dynamics_lane(m: WBLaneModel, q, v, tau, contact,
                              bg_alpha, damping=1e-12):
    """(qdd [nd,K], GRF [12,K]) — rbda.contact_kkt_dynamics lane form.
    contact [4, K] float mask, tau [nd, K] full generalized force."""
    nd = m.nd
    cmask3 = jnp.repeat(contact, 3, axis=0)                # [12, K]
    M = mass_matrix_lane(m, q)
    h = bias_force_lane(m, q, v)
    J = foot_jacobians_lane(m, q).reshape(12, nd, -1)
    Jm = J * cmask3[:, None, :]
    vf = lanemv(J, v)
    gamma = (foot_drift_lane(m, q, v).reshape(12, -1)
             + 2.0 * bg_alpha * vf) * cmask3
    Sdiag = (1.0 - cmask3) + damping * cmask3
    qdd, b = _kkt_schur_solve_lane(M, Jm, Sdiag,
                                   (tau - h)[:, None, :],
                                   -gamma[:, None, :])
    lam = -b[:, 0, :] * cmask3
    return qdd[:, 0, :], lam


def contact_kkt_dynamics_partials_lane(m: WBLaneModel, q, v, tau, contact,
                                       bg_alpha, damping=1e-12):
    """Factored-KKT analytic derivative assembly, lane form — mirrors
    rbda.contact_kkt_dynamics_partials (itself WBM.cpp:459-505): 18
    q-tangents + 18 v-tangents through the KKT residual, then ONE
    multi-RHS application of the factored KKT matrix.

    Returns (dqdd_dq, dqdd_dv, dqdd_dtau, dlam_dq, dlam_dv, dlam_dtau)
    with shapes [nd|12, nd, K].

    CAFEMPC_WB_CF=1 switches the residual tangents to the closed-form
    FK derivative bundle (cf_bundle + _cf_tangents — ancestor
    cross-product rules); the batched-jvp path is the default.  Which
    is faster on the GPU is not measured yet (ROADMAP, Queue 3).
    Equality of both paths is pinned in tests/test_wb_lane.py."""
    dtype = q.dtype
    nd = m.nd
    K = q.shape[-1]
    cmask3 = jnp.repeat(contact, 3, axis=0)
    use_cf = os.environ.get("CAFEMPC_WB_CF", "0") == "1"
    if use_cf:
        cf, td = jax.jvp(lambda q_: cf_bundle(m, q_), (q,), (v,))
        M, h, J, Jdot, gamma_raw = _cf_primal(m, cf, td, v, bg_alpha)
        gamma_m = gamma_raw * cmask3
    else:
        M = mass_matrix_lane(m, q)
        h = bias_force_lane(m, q, v)
        J = foot_jacobians_lane(m, q).reshape(12, nd, K)
        gamma_m = (foot_drift_lane(m, q, v).reshape(12, K)
                   + 2.0 * bg_alpha * lanemv(J, v)) * cmask3
    Jm = J * cmask3[:, None, :]
    Sdiag = (1.0 - cmask3) + damping * cmask3
    sol, b = _kkt_schur_solve_lane(M, Jm, Sdiag,
                                   (tau - h)[:, None, :],
                                   -gamma_m[:, None, :])
    qdd = sol[:, 0, :]
    z_l = b[:, 0, :]

    if use_cf:
        dG_dq, dG_dv = _cf_tangents(m, cf, td, v, qdd, z_l, cmask3,
                                    bg_alpha)
        return _kkt_partials_tail(m, M, Jm, Sdiag, cmask3, dG_dq, dG_dv,
                                  dtype)

    def resid_q(q_):
        h_ = bias_force_lane(m, q_, v)
        J_ = foot_jacobians_lane(m, q_).reshape(12, nd, K)
        Jm_ = J_ * cmask3[:, None, :]
        g_ = (foot_drift_lane(m, q_, v).reshape(12, K)
              + 2.0 * bg_alpha * lanemv(J_, v)) * cmask3
        # M(q_) qdd contracted per body (Mv_lane) — the full M is never
        # built under the tangent directions
        top = Mv_lane(m, q_, qdd) + h_ + lanemv(laneT(Jm_), z_l)
        bot = lanemv(Jm_, qdd) + g_
        return jnp.concatenate([top, bot], axis=0)         # [nd+12, K]

    dG_dq = jac_lane(resid_q, q)                           # [nd, nd+12, K]

    def resid_v(v_):
        h_ = bias_force_lane(m, q, v_)
        g_ = (foot_drift_lane(m, q, v_).reshape(12, K)
              + 2.0 * bg_alpha * lanemv(J, v_)) * cmask3
        return jnp.concatenate([h_, g_], axis=0)

    dG_dv = jac_lane(resid_v, v)                           # [nd, nd+12, K]
    return _kkt_partials_tail(m, M, Jm, Sdiag, cmask3, dG_dq, dG_dv,
                              dtype)


def _kkt_partials_tail(m, M, Jm, Sdiag, cmask3, dG_dq, dG_dv, dtype):
    """One multi-RHS application of the factored KKT matrix: columns
    [q-dirs | v-dirs | tau-dirs] (shared by the closed-form and jvp
    tangent paths)."""
    nd = m.nd
    K = Jm.shape[-1]
    dGq = jnp.transpose(dG_dq, (1, 0, 2))                  # [nd+12, nd, K]
    dGv = jnp.transpose(dG_dv, (1, 0, 2))
    I_nd = jnp.broadcast_to(jnp.eye(nd, dtype=dtype)[:, :, None],
                            (nd, nd, K))
    R1 = jnp.concatenate([-dGq[:nd], -dGv[:nd], I_nd], axis=1)
    R2 = jnp.concatenate([-dGq[nd:], -dGv[nd:],
                          jnp.zeros((12, nd, K), dtype)], axis=1)
    dqdd, db = _kkt_schur_solve_lane(M, Jm, Sdiag, R1, R2)
    dlam = -db * cmask3[:, None, :]
    return (dqdd[:, :nd], dqdd[:, nd:2 * nd], dqdd[:, 2 * nd:],
            dlam[:, :nd], dlam[:, nd:2 * nd], dlam[:, 2 * nd:])


def impulse_dynamics_lane(m: WBLaneModel, q, v, impact_mask,
                          damping=1e-12):
    """Inelastic impact, lane form (rbda.impulse_dynamics /
    WBM.cpp:427-456): M(v+ - v) = Jm^T Lam, Jm v+ = 0.
    impact_mask [4, K].  Returns (v_post [nd,K], impulse [12,K])."""
    nd = m.nd
    K = q.shape[-1]
    cmask3 = jnp.repeat(impact_mask, 3, axis=0)
    M = mass_matrix_lane(m, q)
    J = foot_jacobians_lane(m, q).reshape(12, nd, K)
    Jm = J * cmask3[:, None, :]
    Sdiag = (1.0 - cmask3) + damping * cmask3
    Mv = Mv_lane(m, q, v)
    v_post, b = _kkt_schur_solve_lane(M, Jm, Sdiag, Mv[:, None, :],
                                      jnp.zeros((12, 1, K), q.dtype))
    imp = -b[:, 0, :] * cmask3
    return v_post[:, 0, :], imp


def impulse_dynamics_partials_lane(m: WBLaneModel, q, v, impact_mask,
                                   damping=1e-12):
    """Analytic impulse partials, lane form
    (rbda.impulse_dynamics_partials / WBM.cpp:508-543): q-tangents
    through the residual with per-body M-contractions, v-columns one
    multi-RHS application of the factored KKT (rhs = M).
    Returns (dvpost_dq [nd,nd,K], dvpost_dv [nd,nd,K]).

    CAFEMPC_WB_CF=1 switches to closed-form q-tangents from the FK
    derivative bundle; the batched-jvp path is the default (see
    contact_kkt_dynamics_partials_lane).
    Equality pinned in tests/test_wb_lane.py."""
    dtype = q.dtype
    nd = m.nd
    K = q.shape[-1]
    cmask3 = jnp.repeat(impact_mask, 3, axis=0)
    use_cf = os.environ.get("CAFEMPC_WB_CF", "0") == "1"
    if use_cf:
        cf = cf_bundle(m, q)
        M = _mass_from_bundle(m, cf)
        J = cf.J.reshape(12, nd, K)
    else:
        M = mass_matrix_lane(m, q)
        J = foot_jacobians_lane(m, q).reshape(12, nd, K)
    Jm = J * cmask3[:, None, :]
    Sdiag = (1.0 - cmask3) + damping * cmask3
    vp, b = _kkt_schur_solve_lane(M, Jm, Sdiag,
                                  Mv_lane(m, q, v)[:, None, :]
                                  if not use_cf else
                                  _mv_from_bundle(m, cf, v)[:, None, :],
                                  jnp.zeros((12, 1, K), dtype))
    v_post = vp[:, 0, :]
    z_l = b[:, 0, :]
    dv = v_post - v

    if use_cf:
        dJ = cf.dJ.reshape(nd, 12, nd, K)
        dJm = dJ * cmask3[None, :, None, :]
        top = _cf_dMv(m, cf, dv) + (dJm * z_l[None, :, None, :]).sum(1)
        bot = (dJm * v_post[None, None, :, :]).sum(2)
        dG_dq = jnp.transpose(
            jnp.concatenate([top, bot], axis=1), (1, 0, 2))
    else:
        def resid_q(q_):
            J_ = foot_jacobians_lane(m, q_).reshape(12, nd, K)
            Jm_ = J_ * cmask3[:, None, :]
            top = Mv_lane(m, q_, dv) + lanemv(laneT(Jm_), z_l)
            bot = lanemv(Jm_, v_post)
            return jnp.concatenate([top, bot], axis=0)

        dG_dq = jnp.transpose(jac_lane(resid_q, q), (1, 0, 2))
    R1 = jnp.concatenate([-dG_dq[:nd], M], axis=1)
    R2 = jnp.concatenate([-dG_dq[nd:], jnp.zeros((12, nd, K), dtype)],
                         axis=1)
    dvp, _ = _kkt_schur_solve_lane(M, Jm, Sdiag, R1, R2)
    return dvp[:, :nd], dvp[:, nd:]


# ------------------------------------------------------------------
# whole-body discrete-dynamics linearization (wbm layer, lane form)
# ------------------------------------------------------------------

NQ = 18


def wb_dynamics_lane(m: WBLaneModel, x, u, dt, contact, bg_alpha):
    """Forward-Euler WB step, lane form: x [36,K], u [12,K], dt [K],
    contact [4,K].  Returns (xnext [36,K], grf [12,K]) — mirrors
    wbm.dynamics (WBM.cpp:17-32)."""
    q, v = x[:NQ], x[NQ:]
    tau = jnp.concatenate([jnp.zeros((6,) + u.shape[1:], x.dtype), u])
    qdd, grf = contact_kkt_dynamics_lane(m, q, v, tau, contact, bg_alpha)
    xnext = jnp.concatenate([q + v * dt[None, :],
                             v + qdd * dt[None, :]])
    return xnext, grf


def wb_dyn_partials_lane(m: WBLaneModel, x, u, dt, contact, bg_alpha):
    """A [36,36,K], B [36,12,K], C [12,36,K], D [12,12,K] — lane-form
    wbm.dynamics_partials_analytic."""
    dtype = x.dtype
    K = x.shape[-1]
    q, v = x[:NQ], x[NQ:]
    tau = jnp.concatenate([jnp.zeros((6, K), dtype), u])
    (dqdd_dq, dqdd_dv, dqdd_dtau, dlam_dq, dlam_dv,
     dlam_dtau) = contact_kkt_dynamics_partials_lane(
        m, q, v, tau, contact, bg_alpha)
    I = jnp.broadcast_to(jnp.eye(NQ, dtype=dtype)[:, :, None],
                         (NQ, NQ, K))
    dtc = dt[None, None, :]
    A = jnp.concatenate([
        jnp.concatenate([I, dtc * I], axis=1),
        jnp.concatenate([dtc * dqdd_dq, I + dtc * dqdd_dv], axis=1),
    ], axis=0)
    B = jnp.concatenate([jnp.zeros((NQ, 12, K), dtype),
                         dtc * dqdd_dtau[:, 6:]], axis=0)
    C = jnp.concatenate([dlam_dq, dlam_dv], axis=1)
    D = dlam_dtau[:, 6:]
    return A, B, C, D
