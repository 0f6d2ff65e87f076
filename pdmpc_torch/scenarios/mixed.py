"""Mixed road-network / free-space scenario.

Torch package's copy of pdmpc_tpu/scenarios/mixed.py (not in the
reference, whose scenarios are either road or free-space): one fleet where
the first vehicles drive the CPM road network and the rest fly free-space
circle crossings in off-map clusters. Free-space vehicles reuse the
"lanelet 0 = no lanelet" convention: their boundary-segment rows are fully
masked and their corridor ring is the degenerate dummy, so lanelet-boundary
constraints and corridor clipping are inert for them while road vehicles
keep full road semantics.

Default split: 64 vehicles = 40 road (path ids 1-40) + 24 free-space
(3 circle-crossing clusters of 8, radius 1.5 m, centered off-map).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pdmpc_torch.config import Config, ScenarioType
from pdmpc_torch.models.mpa import Mpa
from pdmpc_torch.scenarios.commonroad import create_commonroad_scenario
from pdmpc_torch.scenarios.loops import PATH_ID_TABLE
from pdmpc_torch.scenarios.scenario import Scenario

CLUSTER_RADIUS = 1.5
CLUSTER_SIZE = 8
# off-map cluster centers (the CPM map spans ~[0, 4.5] x [0, 4])
CLUSTER_CENTERS = [(7.5, 2.0), (7.5, 6.0), (2.25, 7.5),
                   (-3.0, 2.0), (-3.0, 6.0), (7.5, -2.0)]


def create_mixed_scenario(options: Config, mpa: Mpa) -> Scenario:
    n = options.amount
    n_road = min(40, max(1, (5 * n) // 8))
    n_free = n - n_road
    assert n_free <= len(CLUSTER_CENTERS) * CLUSTER_SIZE, (
        f"mixed scenario supports at most "
        f"{40 + len(CLUSTER_CENTERS) * CLUSTER_SIZE} vehicles"
    )

    road_ids = tuple(sorted(PATH_ID_TABLE)[:n_road])
    road_cfg = dataclasses.replace(
        options, scenario_type=ScenarioType.commonroad, amount=n_road,
        path_ids=road_ids, start_poses=(),
    )
    sc = create_commonroad_scenario(road_cfg, mpa)

    # free-space circle clusters (Circle.m geometry at off-map centers)
    reference_speed = float(np.max(mpa.get_straight_speeds()))
    eq = int(np.nonzero(mpa.trims_stop)[0][0])
    paths = list(sc.reference_paths)
    speeds = list(sc.reference_speeds)
    start_poses = list(sc.start_poses)
    start_trims = list(sc.start_trims)
    lanelet_indices = list(sc.lanelet_indices)
    points_indices = list(sc.points_indices)
    for f in range(n_free):
        cx, cy = CLUSTER_CENTERS[f // CLUSTER_SIZE]
        in_cluster = min(CLUSTER_SIZE, n_free - (f // CLUSTER_SIZE)
                         * CLUSTER_SIZE)
        yaw = 2.0 * np.pi / in_cluster * (f % CLUSTER_SIZE)
        c, s = np.cos(yaw), np.sin(yaw)
        x0 = -c * CLUSTER_RADIUS + cx
        y0 = -s * CLUSTER_RADIUS + cy
        path = np.array([
            [x0, y0],
            [x0 + c * 2 * CLUSTER_RADIUS, y0 + s * 2 * CLUSTER_RADIUS],
        ])
        paths.append(path)
        speeds.append(reference_speed)
        start_poses.append(np.array([x0, y0, yaw]))
        start_trims.append(eq)
        # "no lanelet": masked dummy boundary row 0 for every path segment
        lanelet_indices.append([0])
        points_indices.append(np.array([path.shape[0]]))

    return Scenario(
        reference_paths=paths,
        reference_speeds=np.asarray(speeds),
        start_poses=np.asarray(start_poses),
        start_trims=np.asarray(start_trims, dtype=np.int64),
        road=sc.road,
        lanelet_indices=lanelet_indices,
        points_indices=points_indices,
        plot_limits=np.array([[-5.0, 9.5], [-4.0, 9.5]]),
    )
