"""Visualization smoke tests (matplotlib Agg, no display)."""
import os

import numpy as np
import pytest

from cafempc.viz import plots


class _FakeInfo:
    n_entries = 5
    cost_buf = np.array([10.0, 5.0, 2.0, 1.0, 0.5, 0, 0])
    dyn_feas_buf = np.array([1.0, 0.1, 0.01, 1e-3, 1e-4, 0, 0])
    eqn_feas_buf = np.array([0.1, 0.05, 0.01, 1e-3, 1e-4, 0, 0])


def test_gait_schedule_plot(tmp_path):
    contacts = np.array([[1, 1, 1, 1]] * 5 + [[1, 0, 0, 1]] * 5
                        + [[0, 1, 1, 0]] * 5)
    p = str(tmp_path / "gait.png")
    plots.plot_gait_schedule(contacts, 0.01, p)
    assert os.path.getsize(p) > 1000


def test_convergence_plot(tmp_path):
    p = str(tmp_path / "conv.png")
    plots.plot_solve_convergence(_FakeInfo(), p)
    assert os.path.getsize(p) > 1000


def test_body_trajectory_plot(tmp_path):
    X = np.random.default_rng(0).normal(size=(20, 36))
    act = np.ones(20)
    p = str(tmp_path / "body.png")
    plots.plot_body_trajectory(X, act, p)
    assert os.path.getsize(p) > 1000


def test_stickfigure_plot(tmp_path):
    rng = np.random.default_rng(0)
    X = np.zeros((8, 36))
    X[:, 2] = 0.3
    X[:, 6:18] = np.tile([0.0, -0.8, 1.6], 4)
    X[:, 1] = np.linspace(0, 0.5, 8)
    p = str(tmp_path / "stick.png")
    plots.plot_wb_stickfigure(None, X, np.ones(8), p, stride=2)
    assert os.path.getsize(p) > 1000
