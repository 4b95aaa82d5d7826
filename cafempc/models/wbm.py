"""Whole-body model (WBM): 36-state contact-constrained dynamics.

Functional mirror of the reference WBM::Model (MHPC/MHPC-Trajopt/WBM.{h,cpp}):
  state x = [q(18), v(18)],  q = [pos, yaw, pitch, roll, qJ(12)],  v = q̇
  control u = 12 joint torques,  output y = 12 world-frame GRFs.

All heavy lifting lives in cafempc.models.rbda; derivatives come from
jax.jacfwd through the dynamics (replacing WBM.cpp:459-543's analytical
assembly).  Leg order FL, FR, HL, HR (urdf convention).
"""
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cafempc.models import rbda
from cafempc.models.urdf import load_urdf_floating_base

XS = 36
US = 12
YS = 12
NQ = 18
NV = 18

DEFAULT_URDF = \
    "/root/reference/urdf/mini_cheetah_simple_correctedInertia.urdf"
# Second supported robot (gen_regular_arcdog.py / BASELINE config 5)
ARCDOG_URDF = \
    "/root/reference/urdf/arcdog_simple_correctedInertia.urdf"


@functools.lru_cache(maxsize=4)
def load_model(urdf_path=DEFAULT_URDF):
    return rbda.build_model(load_urdf_floating_base(urdf_path))


def _tau_full(u, dtype):
    """Selection matrix action (WBM.h:38-47): actuate the last 12 dofs."""
    return jnp.concatenate([jnp.zeros(6, dtype), u])


def dynamics_continuous(model, x, u, contact, bg_alpha=10.0):
    """(WBM.cpp:38-57).  Returns (xdot, GRF)."""
    q, v = x[:NQ], x[NQ:]
    tau = _tau_full(u, x.dtype)
    qdd, grf = rbda.contact_kkt_dynamics(model, q, v, tau, contact,
                                         bg_alpha)
    return jnp.concatenate([v, qdd]), grf


def dynamics(model, x, u, dt, contact, bg_alpha=10.0):
    """Forward-Euler discrete step (WBM.cpp:17-32).  Returns (xnext, GRF)."""
    q, v = x[:NQ], x[NQ:]
    xdot, grf = dynamics_continuous(model, x, u, contact, bg_alpha)
    xnext = jnp.concatenate([q + v * dt, v + xdot[NQ:] * dt])
    return xnext, grf


def dynamics_partials(model, x, u, dt, contact, bg_alpha=10.0):
    """A, B, C, D via jacfwd (reference: WBM.cpp:59-139)."""
    (A, B), (C, D) = jax.jacfwd(
        lambda x_, u_: dynamics(model, x_, u_, dt, contact, bg_alpha),
        argnums=(0, 1))(x, u)
    return A, B, C, D


def dynamics_partials_analytic(model, x, u, dt, contact, bg_alpha=10.0):
    """A, B, C, D from the factored-KKT analytic assembly
    (rbda.contact_kkt_dynamics_partials — the reference's
    WBM::KKTContactDynamicsDerivatives structure, WBM.cpp:459-505):
    only 18 q-tangents run through the kinematics stack vs jacfwd's 48,
    and no tangents run through the KKT solve."""
    q, v = x[:NQ], x[NQ:]
    tau = _tau_full(u, x.dtype)
    (dqdd_dq, dqdd_dv, dqdd_dtau,
     dlam_dq, dlam_dv, dlam_dtau) = rbda.contact_kkt_dynamics_partials(
        model, q, v, tau, contact, bg_alpha)
    dtype = x.dtype
    I = jnp.eye(NQ, dtype=dtype)
    # xnext = [q + v dt; v + qdd dt]
    A = jnp.block([[I, dt * I],
                   [dt * dqdd_dq, I + dt * dqdd_dv]])
    B = jnp.concatenate([jnp.zeros((NQ, US), dtype),
                         dt * dqdd_dtau[:, 6:]], axis=0)
    C = jnp.concatenate([dlam_dq, dlam_dv], axis=1)
    D = dlam_dtau[:, 6:]
    return A, B, C, D


def impact_partial_analytic(model, x, contact_cur, contact_next):
    """Px for the impulse reset from the factored KKT
    (rbda.impulse_dynamics_partials; WBM.cpp:508-543)."""
    q, v = x[:NQ], x[NQ:]
    impact_mask = (1.0 - contact_cur) * contact_next
    dvp_dq, dvp_dv = rbda.impulse_dynamics_partials(model, q, v,
                                                    impact_mask)
    dtype = x.dtype
    I = jnp.eye(NQ, dtype=dtype)
    Z = jnp.zeros((NQ, NQ), dtype)
    return jnp.block([[I, Z], [dvp_dq, dvp_dv]])


def impact(model, x, contact_cur, contact_next):
    """Impulse reset at touchdown (WBM.cpp:178-206).  Legs entering contact
    get an inelastic impact; q unchanged.  Returns (xnext, impulse)."""
    q, v = x[:NQ], x[NQ:]
    impact_mask = (1.0 - contact_cur) * contact_next
    v_post, imp = rbda.impulse_dynamics(model, q, v, impact_mask)
    return jnp.concatenate([q, v_post]), imp


def impact_partial(model, x, contact_cur, contact_next):
    return jax.jacfwd(
        lambda x_: impact(model, x_, contact_cur, contact_next)[0])(x)


def foot_positions(model, x):
    return rbda.foot_kinematics(model, x[:NQ])


def foot_velocities(model, x):
    return rbda.foot_velocities(model, x[:NQ], x[NQ:])


def foot_jacobians(model, x):
    """[4, 3, 18] — d foot / d q (WBM.cpp:349-364)."""
    return rbda.foot_jacobians(model, x[:NQ])


def foot_vel_dq(model, x):
    """[4, 3, 18] — d foot velocity / d q (casadi footVelPartialDq)."""
    return rbda.foot_vel_dq(model, x[:NQ], x[NQ:])


def foot_heights(model, x):
    return foot_positions(model, x)[:, 2]


def centroidal_momentum(model, x):
    return rbda.centroidal_angular_momentum(model, x[:NQ], x[NQ:])
