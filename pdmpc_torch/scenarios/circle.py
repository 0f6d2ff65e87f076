"""Circle scenario: N vehicles on a circle heading through the center.

Reference: scenarios/free_space/Circle.m:7-44 — radius 2 m around the lab
center (2.25, 2), straight-line reference paths to the antipodal point,
reference speed = the MPA's maximum straight speed.
"""

from __future__ import annotations

import numpy as np

from pdmpc_torch.config import Config
from pdmpc_torch.models.mpa import Mpa
from pdmpc_torch.scenarios.scenario import Scenario

CENTER_X = 2.25
CENTER_Y = 2.0
RADIUS = 2.0


def create_circle_scenario(options: Config, mpa: Mpa) -> Scenario:
    n = options.amount
    yaws = 2.0 * np.pi / n * np.arange(n)

    reference_speed = float(np.max(mpa.get_straight_speeds()))

    paths = []
    start_poses = np.zeros((n, 3))
    for i, yaw in enumerate(yaws):
        c, s = np.cos(yaw), np.sin(yaw)
        x_start = -c * RADIUS + CENTER_X
        y_start = -s * RADIUS + CENTER_Y
        x_end = x_start + c * 2 * RADIUS
        y_end = y_start + s * 2 * RADIUS
        paths.append(np.array([[x_start, y_start], [x_end, y_end]]))
        start_poses[i] = (x_start, y_start, yaw)

    # vehicles start at standstill: equilibrium trim
    eq = int(np.nonzero(mpa.trims_stop)[0][0])
    start_trims = np.full(n, eq, dtype=np.int64)

    plot_limits = (
        np.array([[0.0, 4.5], [1.5, 2.5]])
        if n <= 2
        else np.array([[0.0, 4.5], [0.0, 4.0]])
    )
    return Scenario(
        reference_paths=paths,
        reference_speeds=np.full(n, reference_speed),
        start_poses=start_poses,
        start_trims=start_trims,
        plot_limits=plot_limits,
    )
