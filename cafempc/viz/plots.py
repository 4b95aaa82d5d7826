"""Trajectory visualization.

Replaces the reference's PyBullet/LCM visualization scripts
(scripts/Visualization/) with matplotlib renderings that need no
simulator: gait charts, body/foot trajectories, solver convergence, and a
stick-figure side view of the whole-body plan.  Also provides the LCM
publisher for the reference's `visualize_wb_traj` channel so existing
external animators keep working (utils.publish_trajectory_lcm analogue).
"""
import numpy as np


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_gait_schedule(contacts, dt, path, leg_names=("FL", "FR", "HL",
                                                      "HR")):
    """Contact-schedule bar chart (utils.plot_gait_schedule analogue)."""
    plt = _mpl()
    contacts = np.asarray(contacts)
    T = contacts.shape[0]
    fig, ax = plt.subplots(figsize=(8, 2.5))
    for leg in range(4):
        on = contacts[:, leg] > 0
        t = np.arange(T) * dt
        ax.broken_barh(
            [(t[s], dt * (e - s)) for s, e in _runs(on)],
            (3 - leg - 0.4, 0.8))
    ax.set_yticks([3, 2, 1, 0])
    ax.set_yticklabels(leg_names)
    ax.set_xlabel("time (s)")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def _runs(mask):
    out = []
    s = None
    for i, m in enumerate(mask):
        if m and s is None:
            s = i
        if not m and s is not None:
            out.append((s, i))
            s = None
    if s is not None:
        out.append((s, len(mask)))
    return out


def plot_solve_convergence(info, path):
    """Cost / feasibility / constraint-violation iteration curves from a
    SolverInfo."""
    plt = _mpl()
    n = int(info.n_entries)
    fig, axs = plt.subplots(1, 3, figsize=(12, 3))
    axs[0].semilogy(np.maximum(np.asarray(info.cost_buf[:n]), 1e-12))
    axs[0].set_title("cost")
    axs[1].semilogy(np.maximum(np.asarray(info.dyn_feas_buf[:n]), 1e-12))
    axs[1].set_title("dynamics infeasibility")
    axs[2].semilogy(np.maximum(np.asarray(info.eqn_feas_buf[:n]), 1e-12))
    axs[2].set_title("terminal-constraint violation")
    for a in axs:
        a.set_xlabel("iteration")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_body_trajectory(Xbar, knot_active, path, body_slice=slice(0, 6),
                         labels=("x", "y", "z", "yaw", "pitch", "roll")):
    plt = _mpl()
    X = np.asarray(Xbar)[np.asarray(knot_active) > 0]
    fig, axs = plt.subplots(2, 3, figsize=(12, 5))
    for i in range(6):
        ax = axs[i // 3, i % 3]
        ax.plot(X[:, body_slice][:, i])
        ax.set_title(labels[i])
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_wb_stickfigure(model, Xbar, knot_active, path, stride=4,
                        plane=(1, 2)):
    """Side-view stick figure of a whole-body plan: trunk segment + legs
    drawn hip->foot at regular knots (visualize_motion.py stand-in)."""
    from cafempc.models import rbda
    import jax.numpy as jnp
    plt = _mpl()
    X = np.asarray(Xbar)[np.asarray(knot_active) > 0]
    fig, ax = plt.subplots(figsize=(10, 4))
    a, b = plane
    for k in range(0, X.shape[0], stride):
        q = jnp.asarray(X[k][:18])
        R, p, _ = rbda.fk(rbda_model_or(model), q)
        p = np.asarray(p)
        feet = np.asarray(rbda.foot_kinematics(rbda_model_or(model), q))
        trunk_f = p[5] + np.asarray(R[5]) @ np.array([0.19, 0, 0])
        trunk_h = p[5] + np.asarray(R[5]) @ np.array([-0.19, 0, 0])
        ax.plot([trunk_h[a], trunk_f[a]], [trunk_h[b], trunk_f[b]],
                "k-", lw=2, alpha=0.6)
        for leg in range(4):
            hip = p[6 + 3 * leg]
            knee = p[8 + 3 * leg]
            ax.plot([hip[a], knee[a], feet[leg][a]],
                    [hip[b], knee[b], feet[leg][b]], "-", lw=1, alpha=0.5)
    ax.set_aspect("equal")
    ax.axhline(0.0, color="gray", lw=0.5)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def rbda_model_or(model):
    if model is None:
        from cafempc.models import wbm
        return wbm.load_model()
    return model


def publish_wb_traj(endpoint, Xbar, knot_active, dt, contacts=None,
                    channel="visualize_wb_traj"):
    """Publish a wbTraj_lcmt for external animators
    (utils.publish_trajectory_lcm analogue)."""
    from cafempc.comms import lcm_wire as w
    X = np.asarray(Xbar)[np.asarray(knot_active) > 0]
    sz = X.shape[0]
    msg = w.wbTraj_lcmt(sz=sz, wb_sz=sz)
    msg.time = np.arange(sz) * dt
    msg.pos = X[:, 0:3]
    msg.eul = X[:, 3:6]
    msg.qJ = X[:, 6:18]
    msg.vWorld = X[:, 18:21]
    msg.eulrate = X[:, 21:24]
    msg.qJd = X[:, 24:36]
    msg.torque = np.zeros((sz, 12))
    msg.defect = np.zeros(sz)
    msg.hg = np.zeros((sz, 3))
    msg.dhg = np.zeros((sz, 3))
    msg.contact = np.zeros((sz, 4), dtype=np.int32) if contacts is None \
        else np.asarray(contacts)[:sz].astype(np.int32)
    endpoint.publish(channel, msg)
