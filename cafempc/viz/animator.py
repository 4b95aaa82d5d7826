"""LCM animator: consume planned-trajectory viz messages and render them.

The in-repo consumer of the `visualize_wb_traj` channel — the headless
counterpart of the reference's PyBullet animator
(scripts/Visualization/animator.py + visualize_motion.py:47, which
subscribes to the same wbTraj_lcmt stream).  Each received trajectory is
rendered to a stick-figure animation (GIF via matplotlib) or a frame
strip PNG.

Usage (blocking service):
    from cafempc.comms.udpm import LCMEndpoint
    from cafempc.viz.animator import WBTrajAnimator
    anim = WBTrajAnimator(out_dir="viz_out")
    anim.serve(LCMEndpoint(), max_msgs=1)

or one-shot on a decoded message: `anim.render(msg)`.
"""
import os

import numpy as np

from cafempc.viz.plots import _mpl, rbda_model_or


class WBTrajAnimator:
    def __init__(self, out_dir="viz_out", model=None, fps=25,
                 plane=(0, 2)):
        self.out_dir = out_dir
        self.model = rbda_model_or(model)
        self.fps = fps
        self.plane = plane
        self.n_rendered = 0
        os.makedirs(out_dir, exist_ok=True)

    # ---------------- frame geometry --------------------------------
    def _frame_segments(self, x):
        """Stick-figure line segments for one 36-dim WB state."""
        import jax.numpy as jnp
        from cafempc.models import rbda
        q = jnp.asarray(np.concatenate([x[0:3], x[3:6], x[6:18]])[:18])
        R, p, _ = rbda.fk(self.model, q)
        p = np.asarray(p)
        feet = np.asarray(rbda.foot_kinematics(self.model, q))
        R5 = np.asarray(R[5])
        segs = [(p[5] + R5 @ np.array([-0.19, 0, 0]),
                 p[5] + R5 @ np.array([0.19, 0, 0]))]
        for leg in range(4):
            segs.append((p[6 + 3 * leg], p[8 + 3 * leg]))
            segs.append((p[8 + 3 * leg], feet[leg]))
        return segs

    def render(self, msg, name=None):
        """Render one wbTraj_lcmt to <out_dir>/<name>.gif (falls back to a
        frame-strip PNG if the GIF writer is unavailable).  Returns the
        written path."""
        plt = _mpl()
        import matplotlib.animation as manim
        X = np.concatenate([
            np.asarray(msg.pos, dtype=float),
            np.asarray(msg.eul, dtype=float),
            np.asarray(msg.qJ, dtype=float)], axis=1)
        a, b = self.plane
        name = name or f"wb_traj_{self.n_rendered:03d}"
        self.n_rendered += 1

        fig, ax = plt.subplots(figsize=(7, 4))
        ax.set_aspect("equal")
        ax.axhline(0.0, color="gray", lw=0.5)
        lo = np.asarray(msg.pos)[:, a].min() - 0.4
        hi = np.asarray(msg.pos)[:, a].max() + 0.4
        ax.set_xlim(lo, hi)
        ax.set_ylim(-0.05, 0.55)
        lines = [ax.plot([], [], "k-" if i == 0 else "b-",
                         lw=2 if i == 0 else 1)[0] for i in range(9)]

        def draw(k):
            segs = self._frame_segments(X[k])
            for ln, (p0, p1) in zip(lines, segs):
                ln.set_data([p0[a], p1[a]], [p0[b], p1[b]])
            return lines

        try:
            ani = manim.FuncAnimation(fig, draw, frames=X.shape[0],
                                      blit=True)
            path = os.path.join(self.out_dir, f"{name}.gif")
            ani.save(path, writer=manim.PillowWriter(fps=self.fps))
        except Exception:
            # frame strip fallback
            path = os.path.join(self.out_dir, f"{name}.png")
            stride = max(1, X.shape[0] // 12)
            for k in range(0, X.shape[0], stride):
                for (p0, p1) in self._frame_segments(X[k]):
                    ax.plot([p0[a], p1[a]], [p0[b], p1[b]], "b-",
                            lw=1, alpha=0.5)
            fig.savefig(path, dpi=120)
        plt.close(fig)
        return path

    # ---------------- LCM service -----------------------------------
    def serve(self, endpoint, channel="visualize_wb_traj", max_msgs=None,
              timeout=None):
        """Blocking subscribe-decode-render loop (animator.py analogue).
        Returns the list of written file paths."""
        import time as _time
        from cafempc.comms import lcm_wire as w
        got = []
        endpoint.subscribe(channel, w.wbTraj_lcmt,
                           lambda _c, m: got.append(m))
        written = []
        t0 = _time.time()
        while max_msgs is None or len(written) < max_msgs:
            endpoint.handle(timeout=0.25)
            while got:
                written.append(self.render(got.pop(0)))
            if timeout is not None and _time.time() - t0 > timeout:
                break
        return written
