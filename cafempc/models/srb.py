"""Single-rigid-body (SRB) model for the cascaded-fidelity tail horizon,
re-derived as pure batched JAX functions.

State (12):   [pos(3), eul(3: yaw,pitch,roll), vWorld(3), eulrate(3)]
Control (12): GRF_world per leg (FL, FR, HL, HR in MHPC/urdf convention)
Inputs:       world foot positions (12) + contact mask (4)

Mirrors (behavior, not code) the reference's generated `SRBDynamics` /
`SRBDynamicsDerivatives` kernels (MHPC/MHPC-Trajopt/SRBM.h:43-93).  The
state layout follows SRBReference::get_reference_at_t
(MHPC/MHPC-Trajopt/MHPCReference.cpp:63-77): body_state = [pos, eul, vel,
eulrate].  Mass/inertia extracted numerically from the generated kernel and
verified to <1e-12 against tests/fixtures/srb_dynamics.npz.
"""
import jax
import jax.numpy as jnp

from cafempc.utils.rotations import (
    eul_to_rot, euldrate_to_omega_mat, omega_to_euldrate_mat)

XS = 12
US = 12
YS = 0

MASS = 8.912
INERTIA = jnp.array([
    [0.061578036, 0.0, 5.38e-05],
    [0.0, 0.2207093, 0.0],
    [5.38e-05, 0.0, 0.272612336],
])
GRAVITY = 9.81


def dynamics_continuous(x, u, p_feet, contact):
    """xdot = f(x, u; p_feet, contact).

    p_feet: (12,) world foot positions; contact: (4,) float mask.
    """
    pos, eul = x[0:3], x[3:6]
    vel, euld = x[6:9], x[9:12]
    R = eul_to_rot(eul)
    B = euldrate_to_omega_mat(eul)
    omega = B @ euld

    f = u.reshape(4, 3) * contact[:, None]
    f_tot = f.sum(axis=0)
    r = p_feet.reshape(4, 3) - pos[None, :]
    tau_b = R.T @ jnp.cross(r, f).sum(axis=0)

    Iw = INERTIA @ omega
    omega_dot = jnp.linalg.solve(INERTIA, tau_b - jnp.cross(omega, Iw))

    # euldd = Binv @ (omega_dot - Bdot @ euld), Bdot via jvp through eul.
    Bdot = jax.jvp(euldrate_to_omega_mat, (eul,), (euld,))[1]
    euldd = omega_to_euldrate_mat(eul) @ (omega_dot - Bdot @ euld)

    v_dot = f_tot / MASS + jnp.array([0.0, 0.0, -GRAVITY])
    return jnp.concatenate([vel, euld, v_dot, euldd])


def dynamics(x, u, p_feet, contact, dt):
    """Discrete forward-Euler step (reference SRBM.h:43-49)."""
    return x + dt * dynamics_continuous(x, u, p_feet, contact)


def dynamics_partials_continuous(x, u, p_feet, contact):
    Ac = jax.jacfwd(dynamics_continuous, argnums=0)(x, u, p_feet, contact)
    Bc = jax.jacfwd(dynamics_continuous, argnums=1)(x, u, p_feet, contact)
    return Ac, Bc


def dynamics_partials(x, u, p_feet, contact, dt):
    """A = I + Ac*dt, B = Bc*dt (reference SRBM.h:66-75)."""
    A = jax.jacfwd(dynamics, argnums=0)(x, u, p_feet, contact, dt)
    B = jax.jacfwd(dynamics, argnums=1)(x, u, p_feet, contact, dt)
    return A, B
