"""Batched rigid-body dynamics algorithms in JAX for the whole-body model.

Replaces the reference's Pinocchio usage (crba / nonLinearEffects /
forwardDynamics / impulseDynamics / frame kinematics,
MHPC/MHPC-Trajopt/WBM.cpp:368-543) and the 107-kLoC generated kinematics
derivative file with a compact, AD-differentiable formulation:

  * world-frame kinematics over an 18-dof single-dof-joint tree (the
    floating base is the PX,PY,PZ,RZ,RY,RX chain, PinocchioInteface.cpp),
  * mass matrix from body Jacobians:  M = sum_b J_b^T I_b J_b  — pure
    batched matmuls, MXU-friendly,
  * bias forces via AD identities:    h = Mdot v - 0.5 d/dq (v^T M v) + g,
  * contact/impulse dynamics as masked fixed-size KKT solves (static
    shapes for 0..4 active feet instead of dynamically-sized systems),
  * ALL derivatives via jax.jacfwd through these functions (replacing
    Pinocchio's analytical derivative assembly, WBM.cpp:459-543).

Foot-frame ids FL, FR, HL, HR mirror WBM.h:21.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cafempc.models.urdf import TreeModel, REVOLUTE


class RBDAModel(NamedTuple):
    """Static-topology device model (leaves are jnp arrays; topology lists
    stay python so loops unroll under trace)."""
    parent: tuple           # python ints
    jtype: tuple
    axis: jnp.ndarray       # [nd, 3]
    R_tree: jnp.ndarray     # [nd, 3, 3]
    p_tree: jnp.ndarray     # [nd, 3]
    mass: jnp.ndarray       # [nd]
    com: jnp.ndarray        # [nd, 3]
    inertia: jnp.ndarray    # [nd, 3, 3]
    frame_dof: tuple        # per end-effector frame: parent dof
    frame_R: jnp.ndarray    # [nf, 3, 3]
    frame_p: jnp.ndarray    # [nf, 3]
    has_mass: tuple         # python bools: body carries inertia/mass
    ancestors: np.ndarray   # [nd, nd] bool: ancestors[i, j] = dof j on path
                            # from root to body i (inclusive)

    @property
    def nd(self):
        return len(self.parent)


def build_model(tree: TreeModel, dtype=jnp.float64) -> RBDAModel:
    nd = tree.nd
    anc = np.zeros((nd, nd), dtype=bool)
    for i in range(nd):
        j = i
        while j >= 0:
            anc[i, j] = True
            j = int(tree.parent[j])
    return RBDAModel(
        parent=tuple(int(p) for p in tree.parent),
        jtype=tuple(int(t) for t in tree.jtype),
        axis=jnp.asarray(tree.axis, dtype),
        R_tree=jnp.asarray(tree.R_tree, dtype),
        p_tree=jnp.asarray(tree.p_tree, dtype),
        mass=jnp.asarray(tree.mass, dtype),
        com=jnp.asarray(tree.com, dtype),
        inertia=jnp.asarray(tree.inertia, dtype),
        frame_dof=tuple(int(f[1]) for f in tree.frames),
        frame_R=jnp.asarray(np.stack([f[2] for f in tree.frames]), dtype),
        frame_p=jnp.asarray(np.stack([f[3] for f in tree.frames]), dtype),
        has_mass=tuple(bool(m > 0 or np.any(I)) for m, I in
                       zip(tree.mass, tree.inertia)),
        ancestors=anc)


def _rot_axis(axis, q):
    """Rodrigues rotation about a unit axis."""
    c, s = jnp.cos(q), jnp.sin(q)
    K = jnp.array([[0, -axis[2], axis[1]],
                   [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]], dtype=q.dtype)
    return jnp.eye(3, dtype=q.dtype) + s * K + (1 - c) * (K @ K)


def fk(model: RBDAModel, q):
    """Forward kinematics.

    Returns (R[nd,3,3] body->world rotations, p[nd,3] world origins,
    a_w[nd,3] world joint axes).
    """
    Rs, ps, aw = [], [], []
    for i in range(model.nd):
        pi = model.parent[i]
        Rp = Rs[pi] if pi >= 0 else jnp.eye(3, dtype=q.dtype)
        pp = ps[pi] if pi >= 0 else jnp.zeros(3, dtype=q.dtype)
        R_pre = Rp @ model.R_tree[i]
        p_i = pp + Rp @ model.p_tree[i]
        if model.jtype[i] == REVOLUTE:
            R_i = R_pre @ _rot_axis(model.axis[i], q[i])
        else:
            R_i = R_pre
            p_i = p_i + R_pre @ (model.axis[i] * q[i])
        a_i = R_pre @ model.axis[i]
        Rs.append(R_i)
        ps.append(p_i)
        aw.append(a_i)
    return jnp.stack(Rs), jnp.stack(ps), jnp.stack(aw)


def point_jacobian(model, R, p, aw, dof, point_w, dtype):
    """6x nd spatial Jacobian [Jw; Jv] of a point attached to body `dof`,
    world-aligned.  Columns built from the ancestor chain (unrolled)."""
    nd = model.nd
    cols_w, cols_v = [], []
    for j in range(nd):
        if model.ancestors[dof, j]:
            if model.jtype[j] == REVOLUTE:
                cols_w.append(aw[j])
                cols_v.append(jnp.cross(aw[j], point_w - p[j]))
            else:
                cols_w.append(jnp.zeros(3, dtype))
                cols_v.append(aw[j])
        else:
            cols_w.append(jnp.zeros(3, dtype))
            cols_v.append(jnp.zeros(3, dtype))
    return jnp.stack(cols_w, axis=1), jnp.stack(cols_v, axis=1)


def _rev_mask(model):
    return np.array([1.0 if t == REVOLUTE else 0.0 for t in model.jtype])


def _point_jacobians_batch(model, p, aw, points_w, dofs):
    """Linear world Jacobians of several points at once, vectorized over
    the dof axis (no per-dof python loop): points_w [np,3] attached to
    bodies `dofs` (python ints).  Returns Jv [np, 3, nd]."""
    dtype = points_w.dtype
    anc = jnp.asarray(model.ancestors[np.asarray(dofs)], dtype)  # [np, nd]
    rev = jnp.asarray(_rev_mask(model), dtype)                   # [nd]
    d = points_w[:, None, :] - p[None, :, :]                     # [np,nd,3]
    cr = jnp.cross(jnp.broadcast_to(aw[None], d.shape), d)       # [np,nd,3]
    cols = rev[None, :, None] * cr \
        + (1.0 - rev)[None, :, None] * aw[None]                  # [np,nd,3]
    return jnp.swapaxes(cols * anc[:, :, None], 1, 2)            # [np,3,nd]


def _body_jacobians(model, R, p, aw):
    """CoM Jacobians for every massy body at once (tensorized; replaces
    the per-body point_jacobian loop whose tiny ops splinter the XLA
    graph under the B x N double-vmap).  Returns (mb_idx, com_w [nb,3],
    Jw [nb,3,nd], Jv [nb,3,nd], Iw [nb,3,3])."""
    dtype = p.dtype
    mb = [b for b in range(model.nd) if model.has_mass[b]]
    mb_idx = np.asarray(mb)
    Rb = R[mb_idx]
    com_w = p[mb_idx] + jnp.einsum("bij,bj->bi", Rb, model.com[mb_idx])
    Jv = _point_jacobians_batch(model, p, aw, com_w, mb)
    anc = jnp.asarray(model.ancestors[mb_idx], dtype)            # [nb, nd]
    rev = jnp.asarray(_rev_mask(model), dtype)
    Jw = jnp.swapaxes((rev[None, :, None] * aw[None])
                      * anc[:, :, None], 1, 2)                   # [nb,3,nd]
    Iw = jnp.einsum("bij,bjk,blk->bil", Rb, model.inertia[mb_idx], Rb)
    return mb_idx, com_w, Jw, Jv, Iw


def mass_matrix(model: RBDAModel, q):
    """M(q) = sum_b [ Jw^T (R I_c R^T) Jw + m Jv_com^T Jv_com ],
    assembled as three batched einsums over all massy bodies at once."""
    R, p, aw = fk(model, q)
    mb_idx, com_w, Jw, Jv, Iw = _body_jacobians(model, R, p, aw)
    m = model.mass[mb_idx]
    M = jnp.einsum("bin,bij,bjm->nm", Jw, Iw, Jw) \
        + jnp.einsum("b,bin,bim->nm", m, Jv, Jv)
    return M


GRAVITY = 9.81


def gravity_force(model: RBDAModel, q):
    """g(q): generalized gravity (enters M qdd + C v + g = tau)."""
    R, p, aw = fk(model, q)
    dtype = q.dtype
    mb_idx, com_w, Jw, Jv, Iw = _body_jacobians(model, R, p, aw)
    g_vec = jnp.array([0.0, 0.0, -GRAVITY], dtype)
    return -jnp.einsum("b,bin,i->n", model.mass[mb_idx], Jv, g_vec)


def bias_force(model: RBDAModel, q, v):
    """h(q,v) = C(q,v) v + g(q), via the AD identity
    C v = Mdot v - 0.5 * d/dq (v^T M v)."""
    Mdot = jax.jvp(lambda q_: mass_matrix(model, q_), (q,), (v,))[1]
    dKE = jax.grad(lambda q_: 0.5 * v @ (mass_matrix(model, q_) @ v))(q)
    return Mdot @ v - dKE + gravity_force(model, q)


def foot_kinematics(model: RBDAModel, q):
    """World positions of the end-effector frames.  [nf, 3]."""
    R, p, _ = fk(model, q)
    out = []
    for f, dof in enumerate(model.frame_dof):
        out.append(p[dof] + R[dof] @ model.frame_p[f])
    return jnp.stack(out)


def foot_jacobians(model: RBDAModel, q):
    """Linear world-aligned Jacobians of the end-effector frames.
    [nf, 3, nd] — the reference's get_footJacobians (WBM.cpp:349-364)."""
    R, p, aw = fk(model, q)
    dofs = list(model.frame_dof)
    fidx = np.asarray(dofs)
    pts = p[fidx] + jnp.einsum("fij,fj->fi", R[fidx], model.frame_p)
    return _point_jacobians_batch(model, p, aw, pts, dofs)


def foot_velocities(model: RBDAModel, q, v):
    """[nf, 3] world foot velocities (WBM.cpp:309-320)."""
    return jnp.einsum("fij,j->fi", foot_jacobians(model, q), v)


def foot_vel_dq(model: RBDAModel, q, v):
    """d(foot velocity)/dq — the reference's generated footVelPartialDq
    kernel (WBM.cpp:565-585).  [nf, 3, nd]."""
    return jax.jacfwd(lambda q_: foot_velocities(model, q_, v))(q)


def foot_drift(model: RBDAModel, q, v):
    """Classical foot acceleration with qdd = 0:  Jdot(q, v) v.  [nf, 3]."""
    return jax.jvp(lambda q_: foot_velocities(model, q_, v), (q,), (v,))[1]


def _kkt_schur_solve(M, Jm, Sdiag, r1, r2):
    """Solve the contact KKT system

        [ M    Jm^T ] [ a ]   [ r1 ]
        [ Jm   -S   ] [ b ] = [ r2 ]

    via the Schur complement on the SPD mass matrix — two Cholesky
    factorizations (nd and 12) instead of an LU of the (nd+12) saddle
    system, whose batched LU lowers to a long sequential column loop.
    Supports multi-RHS
    r1 [nd, k], r2 [12, k].  Returns (a, b)."""
    Lm = jnp.linalg.cholesky(M)
    MinvJT = jax.scipy.linalg.cho_solve((Lm, True), Jm.T)   # [nd, 12]
    Minv_r1 = jax.scipy.linalg.cho_solve((Lm, True), r1)
    A_s = Jm @ MinvJT + jnp.diag(Sdiag)                     # [12, 12] SPD
    Ls = jnp.linalg.cholesky(A_s)
    b = jax.scipy.linalg.cho_solve((Ls, True), Jm @ Minv_r1 - r2)
    a = Minv_r1 - MinvJT @ b
    return a, b


def contact_kkt_dynamics(model: RBDAModel, q, v, tau, contact, bg_alpha,
                         damping=1e-12):
    """Contact-constrained forward dynamics with Baumgarte velocity
    stabilization (WBM.cpp:368-424), masked fixed-size KKT:

        [ M    Jm^T ] [ qdd  ]   [ tau - h  ]
        [ Jm   -S   ] [ -lam ] = [ -gamma_m ]

    with Jm = contact-masked stacked foot Jacobians (12 x nd), S =
    diag(1-mask) + damping*mask, gamma = Jdot v + 2*bg_alpha*v_foot.
    Returns (qdd, GRF[12]).
    """
    dtype = q.dtype
    nd = model.nd
    cmask3 = jnp.repeat(contact, 3)
    M = mass_matrix(model, q)
    h = bias_force(model, q, v)
    J = foot_jacobians(model, q).reshape(12, nd)
    Jm = J * cmask3[:, None]
    vf = (J @ v).reshape(4, 3)
    gamma = foot_drift(model, q, v).reshape(4, 3) + 2.0 * bg_alpha * vf
    gamma_m = gamma.reshape(12) * cmask3
    Sdiag = (1.0 - cmask3) + damping * cmask3
    qdd, b = _kkt_schur_solve(M, Jm, Sdiag, tau - h, -gamma_m)
    lam = -b * cmask3
    return qdd, lam


def contact_kkt_dynamics_partials(model: RBDAModel, q, v, tau, contact,
                                  bg_alpha, damping=1e-12):
    """Analytic derivative assembly for `contact_kkt_dynamics` — the
    reference's KKT-matrix-inverse trick (WBM.cpp:459-505 via pinocchio
    computeKKTContactDynamicMatrixInverse + computeRNEADerivatives),
    re-expressed for AD:

        K z = rhs,   dz = K^{-1} (drhs - dK z)

    so every derivative column is ONE application of the already-factored
    KKT matrix to an assembled right-hand side:
      * d/dtau:  [I; 0]                         (constant)
      * d/dv:    [-dh/dv; -dgamma_m/dv]         (18 v-tangents through the
                                                 v-dependent terms only)
      * d/dq:    -d/dq [M qdd + h - Jm^T lam;   (18 q-tangents; the
                        Jm qdd + gamma_m]        RNEA-derivative analogue)
    — no tangents propagate through the linear solve, and the kinematics
    stack is differentiated with 18 tangents instead of the naive
    jacfwd's 48 (none of which could reuse the factorization).

    Returns (dqdd_dq, dqdd_dv, dqdd_dtau, dlam_dq, dlam_dv, dlam_dtau).
    """
    dtype = q.dtype
    nd = model.nd
    cmask3 = jnp.repeat(contact, 3)
    M = mass_matrix(model, q)
    h = bias_force(model, q, v)
    J = foot_jacobians(model, q).reshape(12, nd)
    Jm = J * cmask3[:, None]
    vf = J @ v
    gamma_m = (foot_drift(model, q, v).reshape(12)
               + 2.0 * bg_alpha * vf) * cmask3
    Sdiag = (1.0 - cmask3) + damping * cmask3
    qdd, z_l = _kkt_schur_solve(M, Jm, Sdiag, tau - h, -gamma_m)
    # z_l = -lam_full

    # --- q columns: directional derivatives of the KKT residual --------
    def resid_q(q_):
        M_ = mass_matrix(model, q_)
        h_ = bias_force(model, q_, v)
        J_ = foot_jacobians(model, q_).reshape(12, nd)
        Jm_ = J_ * cmask3[:, None]
        g_ = (foot_drift(model, q_, v).reshape(12)
              + 2.0 * bg_alpha * (J_ @ v)) * cmask3
        top = M_ @ qdd + h_ + Jm_.T @ z_l
        bot = Jm_ @ qdd + g_
        return jnp.concatenate([top, bot])

    dG_dq = jax.jacfwd(resid_q)(q)                       # [nd+12, nd]

    # --- v columns ------------------------------------------------------
    def resid_v(v_):
        h_ = bias_force(model, q, v_)
        g_ = (foot_drift(model, q, v_).reshape(12)
              + 2.0 * bg_alpha * (J @ v_)) * cmask3
        return jnp.concatenate([h_, g_])

    dG_dv = jax.jacfwd(resid_v)(v)                       # [nd+12, nd]

    # --- one multi-RHS application of the factored KKT matrix -----------
    R1 = jnp.concatenate([-dG_dq[:nd], -dG_dv[:nd],
                          jnp.eye(nd, dtype=dtype)], axis=1)
    R2 = jnp.concatenate([-dG_dq[nd:], -dG_dv[nd:],
                          jnp.zeros((12, nd), dtype)], axis=1)
    dqdd, db = _kkt_schur_solve(M, Jm, Sdiag, R1, R2)
    dlam = -db * cmask3[:, None]
    return (dqdd[:, :nd], dqdd[:, nd:2 * nd], dqdd[:, 2 * nd:],
            dlam[:, :nd], dlam[:, nd:2 * nd], dlam[:, 2 * nd:])


def impulse_dynamics_partials(model: RBDAModel, q, v, contact,
                              damping=1e-12):
    """Analytic partials of `impulse_dynamics` (WBM.cpp:508-543,
    KKTImpactDerivatives): same factored-KKT reuse as the contact
    dynamics.  Returns (dvpost_dq, dvpost_dv)."""
    dtype = q.dtype
    nd = model.nd
    cmask3 = jnp.repeat(contact, 3)
    M = mass_matrix(model, q)
    J = foot_jacobians(model, q).reshape(12, nd)
    Jm = J * cmask3[:, None]
    Sdiag = (1.0 - cmask3) + damping * cmask3
    v_post, z_l = _kkt_schur_solve(M, Jm, Sdiag, M @ v,
                                   jnp.zeros(12, dtype))

    def resid_q(q_):
        M_ = mass_matrix(model, q_)
        J_ = foot_jacobians(model, q_).reshape(12, nd)
        Jm_ = J_ * cmask3[:, None]
        top = M_ @ (v_post - v) + Jm_.T @ z_l
        bot = Jm_ @ v_post
        return jnp.concatenate([top, bot])

    dG_dq = jax.jacfwd(resid_q)(q)
    R1 = jnp.concatenate([-dG_dq[:nd], M], axis=1)
    R2 = jnp.concatenate([-dG_dq[nd:], jnp.zeros((12, nd), dtype)],
                         axis=1)
    dvp, _ = _kkt_schur_solve(M, Jm, Sdiag, R1, R2)
    return dvp[:, :nd], dvp[:, nd:]


def impulse_dynamics(model: RBDAModel, q, v, contact, damping=1e-12):
    """Inelastic impact (restitution 0): M(v+ - v) = J^T Lam, Jm v+ = 0
    (WBM.cpp:427-456 / pinocchio impulseDynamics).  Returns (v_post,
    impulse[12])."""
    dtype = q.dtype
    nd = model.nd
    cmask3 = jnp.repeat(contact, 3)
    M = mass_matrix(model, q)
    J = foot_jacobians(model, q).reshape(12, nd)
    Jm = J * cmask3[:, None]
    Sdiag = (1.0 - cmask3) + damping * cmask3
    v_post, b = _kkt_schur_solve(M, Jm, Sdiag, M @ v, jnp.zeros(12, dtype))
    imp = -b * cmask3
    return v_post, imp


def com_position(model: RBDAModel, q):
    R, p, _ = fk(model, q)
    mb_idx, com_w, _, _, _ = _body_jacobians(model, R, p,
                                             jnp.zeros_like(p))
    m = model.mass[mb_idx]
    return jnp.einsum("b,bi->i", m, com_w) / jnp.sum(m)


def centroidal_angular_momentum(model: RBDAModel, q, v):
    """k_G: angular momentum about the CoM (reference
    evalute_centroidal_momemtum, WBM.cpp:142-150)."""
    R, p, aw = fk(model, q)
    mb_idx, com_w, Jw, Jv, Iw = _body_jacobians(model, R, p, aw)
    m = model.mass[mb_idx]
    com = jnp.einsum("b,bi->i", m, com_w) / jnp.sum(m)
    w_b = jnp.einsum("bin,n->bi", Jw, v)
    v_b = jnp.einsum("bin,n->bi", Jv, v)
    return jnp.einsum("bij,bj->i", Iw, w_b) \
        + jnp.einsum("b,bi->i", m, jnp.cross(com_w - com[None, :], v_b))
