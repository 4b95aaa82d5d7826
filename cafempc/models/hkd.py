"""Hybrid-kinodynamic (HKD) quadruped model, re-derived in closed form as
pure batched JAX functions.

State (24):   [eul(3: yaw,pitch,roll), pos(3), omega_body(3), vWorld(3),
               qdummy(12)]
Control (24): [GRF_world(12), commanded joint velocities(12)]

Per-leg ``qdummy`` semantics: joint angles (abad, hip, knee) while the leg
swings; world-frame foot position while it stances (x,y frozen; z treated as
a coordinate that stays put).  Leg order is the Cheetah-Software convention
FR, FL, HR, HL.

Mirrors (behavior, not code) the reference's CasADi-generated kernels:
  * discrete dynamics  `hkinodyn`           (HKDMPC/HKD-TrajOpt/HKDModel.h:33-45)
  * dynamics partials  `hkinodyn_par`       (HKDModel.h:46-61) -- here via jacfwd
  * foot FK            `compute_foot_position` (HKDReset.h:62-68)
  * foot Jacobians     `comp_foot_jacob_1..4`  (HKDReset.h:99-126)
  * reset map          HKDReset::resetmap   (HKDReset.h:41-75)
Model constants (mass / inertia / geometry) were extracted numerically from
the generated kernels; verified to <1e-12 against tests/fixtures/hkd_*.npz.
"""
import jax
import jax.numpy as jnp
import numpy as np

from cafempc.utils.rotations import (
    eul_to_rot, euldrate_to_omega_mat, omega_to_euldrate_mat, rotx, roty,
    rotz, skew)

XS = 24
US = 24
YS = 0

# Constants are numpy arrays so that they take the dtype of the solve
# they enter (float32 with x64 off, float64 under jax.enable_x64).
MASS = 8.912
INERTIA_DIAG = np.array([0.02746078, 0.2425157968, 0.2651935768])
GRAVITY = 9.81

# Leg geometry (Cheetah-Software convention; FR, FL, HR, HL)
HIP_X = np.array([0.19, 0.19, -0.19, -0.19])
HIP_Y = np.array([-0.049, 0.049, -0.049, 0.049])
SIDE_SIGN = np.array([-1.0, 1.0, -1.0, 1.0])
L1 = 0.062   # abad link
L2 = 0.209   # thigh
L3 = 0.195   # shank
QLEG_DEFAULT = np.array([0.0, -0.8, 1.7])  # HKDReset.h:37

# constant one-hot placement [4,3,12]: leg l's 3-vector into qdummy cols
_QD_PLACE = np.zeros((4, 3, 12))
for _l in range(4):
    _QD_PLACE[_l, :, 3 * _l:3 * _l + 3] = np.eye(3)


def leg_fk_local(qleg, leg):
    """Foot position in the body frame for one leg.

    qleg: (3,) [abad, hip, knee] angles; leg: static int 0..3.
    """
    s1, c1 = jnp.sin(qleg[0]), jnp.cos(qleg[0])
    s2, c2 = jnp.sin(qleg[1]), jnp.cos(qleg[1])
    s3, c3 = jnp.sin(qleg[2]), jnp.cos(qleg[2])
    s23 = s2 * c3 + c2 * s3
    c23 = c2 * c3 - s2 * s3
    sig = SIDE_SIGN[leg]
    ext = L3 * c23 + L2 * c2           # leg extension along -z of abad frame
    px = HIP_X[leg] + L3 * s23 + L2 * s2
    py = HIP_Y[leg] + sig * L1 * c1 + s1 * ext
    pz = sig * L1 * s1 - c1 * ext
    return jnp.stack([px, py, pz])


def leg_ik_local(p, leg):
    """Closed-form inverse of `leg_fk_local` (numpy, float64): the joint
    angles [abad, hip, knee] that put the foot of `leg` at body-frame
    position p, on the knee-positive branch of the default posture."""
    px, py, pz = p[0] - HIP_X[leg], p[1] - HIP_Y[leg], p[2]
    sig = SIDE_SIGN[leg]
    ext = np.sqrt(max(py * py + pz * pz - L1 * L1, 0.0))
    q1 = np.arctan2(pz, py) + np.arctan2(ext, sig * L1)
    c3 = (px * px + ext * ext - L2 * L2 - L3 * L3) / (2.0 * L2 * L3)
    q3 = np.arccos(np.clip(c3, -1.0, 1.0))
    q2 = np.arctan2(px, ext) - np.arctan2(L3 * np.sin(q3),
                                          L2 + L3 * np.cos(q3))
    return np.array([np.arctan2(np.sin(q1), np.cos(q1)), q2, q3])


def foot_position(pos, eul, qleg, leg):
    """World-frame foot position (reference `compute_foot_position`)."""
    R = eul_to_rot(eul)
    return pos + R @ leg_fk_local(qleg, leg)


def _rot_derivs(eul):
    """R(eul) and its partials wrt (yaw, pitch, roll) for the ZYX chain
    R = Rz(yaw) Ry(pitch) Rx(roll)."""
    yaw, pitch, roll = eul[0], eul[1], eul[2]
    Rz, Ry, Rx = rotz(yaw), roty(pitch), rotx(roll)
    R = Rz @ Ry @ Rx
    dtype = eul.dtype
    ez = jnp.array([0.0, 0.0, 1.0], dtype)
    ey = jnp.array([0.0, 1.0, 0.0], dtype)
    ex = jnp.array([1.0, 0.0, 0.0], dtype)
    dR_dy = skew(ez) @ R
    dR_dp = Rz @ skew(ey) @ Ry @ Rx
    dR_dr = Rz @ Ry @ skew(ex) @ Rx
    return R, dR_dy, dR_dp, dR_dr


def leg_jacobian_local(qleg, leg):
    """Analytic 3x3 Jacobian of `leg_fk_local` wrt the leg's joint angles."""
    s1, c1 = jnp.sin(qleg[0]), jnp.cos(qleg[0])
    s2, c2 = jnp.sin(qleg[1]), jnp.cos(qleg[1])
    s3, c3 = jnp.sin(qleg[2]), jnp.cos(qleg[2])
    s23 = s2 * c3 + c2 * s3
    c23 = c2 * c3 - s2 * s3
    sig = SIDE_SIGN[leg]
    ext = L3 * c23 + L2 * c2
    dext2 = -L3 * s23 - L2 * s2
    dext3 = -L3 * s23
    z = jnp.zeros((), qleg.dtype)
    return jnp.array([
        [z, ext, L3 * c23],
        [-sig * L1 * s1 + c1 * ext, s1 * dext2, s1 * dext3],
        [sig * L1 * c1 + s1 * ext, -c1 * dext2, -c1 * dext3]])


def foot_world_jacobians(pos, eul, qleg, leg):
    """Analytic partials of the world-frame foot position:
    returns (J_eul [3,3], J_q [3,3]); d/dpos is the identity."""
    R, dR_dy, dR_dp, dR_dr = _rot_derivs(eul)
    p_l = leg_fk_local(qleg, leg)
    J_eul = jnp.stack([dR_dy @ p_l, dR_dp @ p_l, dR_dr @ p_l], axis=1)
    J_q = R @ leg_jacobian_local(qleg, leg)
    return J_eul, J_q


def foot_jacobian(pos, eul, qleg, leg):
    """d foot_position / d (pos(3), eul(3), qleg... full qdummy(12)).

    Returns (3, 18) with column layout [d/dpos(3), d/deul(3), d/dqdummy(12)]
    matching the reference `comp_foot_jacob_*` output (HKDReset.h:131-133
    consumes cols 0:3 wrt pos, 3:6 wrt eul, 6:18 wrt qdummy).
    """
    def fk(pos_, eul_, qd_):
        return foot_position(pos_, eul_, qd_[3 * leg:3 * leg + 3], leg)

    qd = jnp.zeros(12).at[3 * leg:3 * leg + 3].set(qleg)
    Jp, Je, Jq = jax.jacfwd(fk, argnums=(0, 1, 2))(pos, eul, qd)
    return jnp.concatenate([Jp, Je, Jq], axis=-1)


def _body_accels(eul, pos, omega, grf, contact, p_feet):
    """Shared SRB-style body dynamics: returns (omega_dot, v_dot).

    grf: (12,) world-frame forces; p_feet: (4,3) world foot positions;
    contact: (4,) float mask.
    """
    R = eul_to_rot(eul)
    f = grf.reshape(4, 3) * contact[:, None]
    f_tot = f.sum(axis=0)
    # The reference kernel computes the torque arm with the foot height
    # zeroed (feet on the ground plane), verified against fixtures.
    p_arm = p_feet * jnp.array([1.0, 1.0, 0.0])
    tau_w = jnp.cross(p_arm - pos[None, :], f).sum(axis=0)
    tau_b = R.T @ tau_w
    Iw = INERTIA_DIAG * omega
    omega_dot = (tau_b - jnp.cross(omega, Iw)) / INERTIA_DIAG
    v_dot = f_tot / MASS + jnp.array([0.0, 0.0, -GRAVITY])
    return omega_dot, v_dot


def dynamics_continuous(x, u, contact):
    """Continuous-time HKD dynamics xdot = f(x, u; contact).

    contact: (4,) float (0/1) stance mask, a static per-phase quantity in the
    reference but here an ordinary traced input so phases batch.
    """
    eul, pos = x[0:3], x[3:6]
    omega, vel = x[6:9], x[9:12]
    qdummy = x[12:24]
    grf, qJd_cmd = u[0:12], u[12:24]

    # Foot positions: stance legs read qdummy directly as the foot position.
    p_feet = qdummy.reshape(4, 3)

    omega_dot, v_dot = _body_accels(eul, pos, omega, grf, contact, p_feet)
    euld = omega_to_euldrate_mat(eul) @ omega

    # qdummy rate: commanded joint velocity when swinging, frozen in stance.
    qdummy_dot = qJd_cmd * (1.0 - jnp.repeat(contact, 3))

    return jnp.concatenate([euld, vel, omega_dot, v_dot, qdummy_dot])


def dynamics(x, u, dt, contact):
    """Discrete forward-Euler step (reference `hkinodyn`)."""
    return x + dt * dynamics_continuous(x, u, contact)


def dynamics_partials_ad(x, u, dt, contact):
    """A = dxnext/dx, B = dxnext/du via jacfwd (48 tangents)."""
    A = jax.jacfwd(dynamics, argnums=0)(x, u, dt, contact)
    B = jax.jacfwd(dynamics, argnums=1)(x, u, dt, contact)
    return A, B


def dynamics_partials(x, u, dt, contact):
    """A = dxnext/dx, B = dxnext/du in closed form (reference
    `hkinodyn_par`): the forward-Euler HKD Jacobian assembled from
    analytic blocks instead of a 48-tangent jacfwd — ~20x fewer flops
    and far fewer small ops in the batched LQ stage.  Verified against
    `dynamics_partials_ad` to machine precision (tests/test_hkd_model.py).
    """
    dtype = x.dtype
    eul, pos = x[0:3], x[3:6]
    omega = x[6:9]
    qdummy = x[12:24]
    grf = u[0:12]
    f = grf.reshape(4, 3) * contact[:, None]

    yaw, pitch, roll = eul[0], eul[1], eul[2]
    sp, cp = jnp.sin(pitch), jnp.cos(pitch)
    sr, cr = jnp.sin(roll), jnp.cos(roll)
    z = jnp.zeros((), dtype)

    # --- euld = W(eul) @ omega -------------------------------------
    W = omega_to_euldrate_mat(eul)
    cp2 = cp * cp
    dW_dp = jnp.array([[0.0, 0.0, 0.0]] * 3, dtype).at[0, 1].set(
        sr * sp / cp2).at[0, 2].set(cr * sp / cp2) \
        .at[2, 1].set(sr / cp2).at[2, 2].set(cr / cp2)
    dW_dr = jnp.zeros((3, 3), dtype) \
        .at[0, 1].set(cr / cp).at[0, 2].set(-sr / cp) \
        .at[1, 1].set(-sr).at[1, 2].set(-cr) \
        .at[2, 1].set(sp * cr / cp).at[2, 2].set(-sp * sr / cp)
    deuld_deul = jnp.stack(
        [jnp.zeros(3, dtype), dW_dp @ omega, dW_dr @ omega], axis=1)

    # --- omega_dot = Iinv (R^T tau_w - omega x (I omega)) ----------
    Rz, Ry, Rx = rotz(yaw), roty(pitch), rotx(roll)
    R = Rz @ Ry @ Rx
    ez = jnp.array([0.0, 0.0, 1.0], dtype)
    ey = jnp.array([0.0, 1.0, 0.0], dtype)
    ex = jnp.array([1.0, 0.0, 0.0], dtype)
    dR_dy = skew(ez) @ R
    dR_dp = Rz @ skew(ey) @ Ry @ Rx
    dR_dr = Rz @ Ry @ skew(ex) @ Rx

    p_feet = qdummy.reshape(4, 3)
    p_arm = p_feet * jnp.array([1.0, 1.0, 0.0], dtype)
    arms = p_arm - pos[None, :]
    tau_w = jnp.cross(arms, f).sum(axis=0)
    Iinv = 1.0 / INERTIA_DIAG.astype(dtype)

    dwd_deul = Iinv[:, None] * jnp.stack(
        [dR_dy.T @ tau_w, dR_dp.T @ tau_w, dR_dr.T @ tau_w], axis=1)
    f_tot = f.sum(axis=0)
    RT = R.T
    dwd_dpos = Iinv[:, None] * (RT @ skew(f_tot))
    Iw = INERTIA_DIAG.astype(dtype) * omega
    dwd_domega = Iinv[:, None] * (skew(Iw)
                                  - skew(omega) * INERTIA_DIAG[None, :])
    # per-leg qdummy block: Iinv RT (-skew(f_l)) diag(1,1,0)
    sk_f = skew(f)                                   # [4,3,3]
    dwd_dqd = -jnp.einsum("ij,ljk->ilk", RT, sk_f) \
        * jnp.array([1.0, 1.0, 0.0], dtype)[None, None, :]
    dwd_dqd = (Iinv[:, None, None] * dwd_dqd).reshape(3, 12)
    # per-leg grf block: Iinv RT skew(arm_l) * contact_l
    dwd_dgrf = jnp.einsum("ij,ljk->ilk", RT, skew(arms)) \
        * contact[None, :, None]
    dwd_dgrf = (Iinv[:, None, None] * dwd_dgrf).reshape(3, 12)

    # --- assemble continuous-time Jacobians ------------------------
    # Built by CONCATENATION of blocks, not .at[slice].set chains: under
    # the solver's [B, N] double-vmap every sequential slice-set becomes a
    # full-buffer dynamic-update-slice copy of the [B,N,24,24] array
    # (~40 ms/solve at B=256 in the round-2 trace); concatenation fuses.
    I3 = jnp.eye(3, dtype=dtype)
    Z33 = jnp.zeros((3, 3), dtype)
    Z3_12 = jnp.zeros((3, 12), dtype)
    row_eul = jnp.concatenate([deuld_deul, Z33, W, Z33, Z3_12], axis=1)
    row_pos = jnp.concatenate([Z33, Z33, Z33, I3, Z3_12], axis=1)
    row_omg = jnp.concatenate([dwd_deul, dwd_dpos, dwd_domega, Z33,
                               dwd_dqd], axis=1)
    row_vel = jnp.zeros((3, 24), dtype)
    row_qd = jnp.zeros((12, 24), dtype)
    Fx = jnp.concatenate([row_eul, row_pos, row_omg, row_vel, row_qd],
                         axis=0)

    Z12 = jnp.zeros((3, 12), dtype)
    u_omg = jnp.concatenate([dwd_dgrf, Z12], axis=1)
    u_vel = jnp.concatenate([jnp.kron(contact[None, :], I3)
                             .reshape(3, 12) / MASS, Z12], axis=1)
    swing = 1.0 - jnp.repeat(contact, 3)
    u_qd = jnp.concatenate([jnp.zeros((12, 12), dtype),
                            swing[:, None] * jnp.eye(12, dtype=dtype)],
                           axis=1)
    Fu = jnp.concatenate([jnp.zeros((6, 24), dtype), u_omg, u_vel, u_qd],
                         axis=0)

    A = jnp.eye(24, dtype=dtype) + dt * Fx
    B = dt * Fu
    return A, B


def compute_hkd_state(eul, pos, qJ, contact):
    """Build qdummy from joint angles + FK (reference compute_hkd_state,
    HKDModel.h:66-96): joint angles for swing legs, foot positions for
    stance legs."""
    qd_parts = []
    for leg in range(4):
        qleg = qJ[3 * leg:3 * leg + 3]
        pf = foot_position(pos, eul, qleg, leg)
        qd_parts.append(jnp.where(contact[leg] > 0, pf, qleg))
    return jnp.concatenate(qd_parts)


def reset_map_td_lo(x, td4, lo4):
    """reset_map with precomputed per-leg touchdown / liftoff masks."""
    eul, pos = x[0:3], x[3:6]
    qdummy = x[12:24]
    out = []
    for leg in range(4):
        qleg = qdummy[3 * leg:3 * leg + 3]
        td, lo = td4[leg], lo4[leg]
        pf = foot_position(pos, eul, qleg, leg) * jnp.array([1.0, 1.0, 0.0])
        q_new = (td * pf + lo * QLEG_DEFAULT
                 + (1.0 - td - lo) * qleg)
        out.append(q_new)
    return jnp.concatenate([x[0:12]] + out)


def reset_map(x, contact_cur, contact_next):
    """Hybrid reset of qdummy at a contact-mode switch (HKDReset.h:41-75).

    stance->swing: qdummy_leg := default joint angle.
    swing->stance: qdummy_leg := [pf_x, pf_y, 0] via FK from joint angles.
    """
    td4 = (1.0 - contact_cur) * contact_next       # touchdown
    lo4 = contact_cur * (1.0 - contact_next)       # liftoff
    return reset_map_td_lo(x, td4, lo4)


def reset_map_partial_ad(x, contact_cur, contact_next):
    """Px = d reset / dx via jacfwd (24 tangents); reference for tests."""
    return jax.jacfwd(reset_map, argnums=0)(x, contact_cur, contact_next)


def reset_map_partial_td_lo(x, td4, lo4):
    """reset_map_partial with precomputed touchdown / liftoff masks."""
    dtype = x.dtype
    eul, pos = x[0:3], x[3:6]
    qdummy = x[12:24]
    I3 = jnp.eye(3, dtype=dtype)
    zmask = jnp.diag(jnp.array([1.0, 1.0, 0.0], dtype))
    P = jnp.zeros((24, 24), dtype).at[0:12, 0:12].set(
        jnp.eye(12, dtype=dtype))
    for leg in range(4):
        qleg = qdummy[3 * leg:3 * leg + 3]
        td, lo = td4[leg], lo4[leg]
        keep = 1.0 - td - lo
        J_eul, J_q = foot_world_jacobians(pos, eul, qleg, leg)
        r = 12 + 3 * leg
        P = P.at[r:r + 3, 0:3].set(td * (zmask @ J_eul))
        P = P.at[r:r + 3, 3:6].set(td * zmask)
        P = P.at[r:r + 3, r:r + 3].set(td * (zmask @ J_q) + keep * I3)
    return P


def reset_map_partial(x, contact_cur, contact_next):
    """Px = d reset / dx (HKDReset.h:78-136), closed form.

    Matches the reference exactly, including its structure: identity for
    unchanged legs, zero rows for stance->swing legs, and the (z-masked)
    foot Jacobian for swing->stance legs.  Assembled analytically instead
    of a 24-tangent jacfwd — the solver's LQ stage evaluates this on every
    knot (mask-selected), so it must be as cheap as the dynamics Jacobian.
    """
    td4 = (1.0 - contact_cur) * contact_next
    lo4 = contact_cur * (1.0 - contact_next)
    return reset_map_partial_td_lo(x, td4, lo4)


def _legs_fk_local(qd4):
    """leg_fk_local for all 4 legs at once: qd4 [4,3] -> p_local [4,3]."""
    s1, c1 = jnp.sin(qd4[:, 0]), jnp.cos(qd4[:, 0])
    s2, c2 = jnp.sin(qd4[:, 1]), jnp.cos(qd4[:, 1])
    s3, c3 = jnp.sin(qd4[:, 2]), jnp.cos(qd4[:, 2])
    s23 = s2 * c3 + c2 * s3
    c23 = c2 * c3 - s2 * s3
    sig = SIDE_SIGN.astype(qd4.dtype)
    ext = L3 * c23 + L2 * c2
    px = HIP_X.astype(qd4.dtype) + L3 * s23 + L2 * s2
    py = HIP_Y.astype(qd4.dtype) + sig * L1 * c1 + s1 * ext
    pz = sig * L1 * s1 - c1 * ext
    return jnp.stack([px, py, pz], axis=1)


def _legs_jacobian_local(qd4):
    """leg_jacobian_local for all 4 legs: qd4 [4,3] -> J [4,3,3]."""
    s1, c1 = jnp.sin(qd4[:, 0]), jnp.cos(qd4[:, 0])
    s2, c2 = jnp.sin(qd4[:, 1]), jnp.cos(qd4[:, 1])
    s3, c3 = jnp.sin(qd4[:, 2]), jnp.cos(qd4[:, 2])
    s23 = s2 * c3 + c2 * s3
    c23 = c2 * c3 - s2 * s3
    sig = SIDE_SIGN.astype(qd4.dtype)
    ext = L3 * c23 + L2 * c2
    dext2 = -L3 * s23 - L2 * s2
    dext3 = -L3 * s23
    z = jnp.zeros_like(s1)
    row_x = jnp.stack([z, ext, L3 * c23], axis=1)
    row_y = jnp.stack([-sig * L1 * s1 + c1 * ext, s1 * dext2, s1 * dext3],
                      axis=1)
    row_z = jnp.stack([sig * L1 * c1 + s1 * ext, -c1 * dext2, -c1 * dext3],
                      axis=1)
    return jnp.stack([row_x, row_y, row_z], axis=1)


def foot_heights(x):
    """World-frame foot z for all 4 legs (leg-vectorized): [4]."""
    eul, pos = x[0:3], x[3:6]
    p_l = _legs_fk_local(x[12:24].reshape(4, 3))
    R = eul_to_rot(eul)
    return pos[2] + p_l @ R[2]


def touchdown_height_partials(x):
    """dh/dx for h_l = foot_z(pos, eul, qdummy_leg), all 4 legs: [4, 24],
    closed form (reference TouchDownConstraint partials via casadi foot
    Jacobians, HKDConstraints.cpp:122-160).

    Leg-vectorized: R and its euler partials are built ONCE and only their
    z-rows are used, so the whole thing is a handful of [4,3] contractions
    instead of per-leg matrix soup (the first closed form cost 5x the
    dynamics Jacobian in the batched LQ stage)."""
    dtype = x.dtype
    eul = x[0:3]
    qd4 = x[12:24].reshape(4, 3)
    R, dR_dy, dR_dp, dR_dr = _rot_derivs(eul)
    p_l = _legs_fk_local(qd4)                       # [4,3]
    J_loc = _legs_jacobian_local(qd4)               # [4,3,3]
    # z-row of d(R p)/deul per leg: [4,3]
    dR_z = jnp.stack([dR_dy[2], dR_dp[2], dR_dr[2]], axis=0)   # [3,3]
    heul = p_l @ dR_z.T                             # [4,3]
    # z-row of R J_loc per leg: [4,3]
    hq = jnp.einsum("j,ljk->lk", R[2], J_loc)
    hpos = jnp.tile(jnp.array([0.0, 0.0, 1.0], dtype), (4, 1))
    zmid = jnp.zeros((4, 6), dtype)
    # qdummy block-diagonal placement via a constant one-hot tensor
    # (per-leg slice-sets would lower to dynamic-update-slice copies)
    E = jnp.asarray(_QD_PLACE, dtype)                # [4,3,12]
    hqd = jnp.einsum("lk,lkp->lp", hq, E)
    return jnp.concatenate([heul, hpos, zmid, hqd], axis=1)
