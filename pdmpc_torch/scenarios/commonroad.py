"""CommonRoad (CPM lab road network) scenario.

Reference: scenarios/road_network/Commonroad.m +
generate_reference_path_loop.m: per-vehicle looped reference path from
``path_ids`` (lanelet centerlines concatenated, duplicate junction points
removed), randomized reference speed per vehicle (seeded by the path-id
sum), start pose at the first reference point.
"""

from __future__ import annotations

import numpy as np

from pdmpc_torch.config import Config
from pdmpc_torch.models.mpa import Mpa
from pdmpc_torch.scenarios.loops import get_reference_lanelets_loop
from pdmpc_torch.scenarios.road import RelationshipType, RoadData, get_road_data
from pdmpc_torch.scenarios.scenario import Scenario


def generate_reference_path_loop(lanelet_ids: list[int], road: RoadData):
    """Concatenate lanelet centerlines into one path.

    Reference: generate_reference_path_loop.m — identical successive points
    (endpoint of one lanelet == start of its successor) are removed; the
    per-lanelet last-point indices are tracked.
    """
    centers = [road.lanelet(i).center for i in lanelet_ids]
    path = np.concatenate(centers, axis=0)

    diffs = np.abs(np.diff(path, axis=0)).sum(axis=1)
    redundant = np.concatenate([[False], diffs < 1e-4])
    path_reduced = path[~redundant]

    lengths = np.array([c.shape[0] for c in centers])
    cum_lengths = np.cumsum(lengths)
    cum_redundant = np.cumsum(redundant)
    points_index = cum_lengths - cum_redundant[cum_lengths - 1]
    return path_reduced, points_index


def _calculate_yaw_np(points: np.ndarray) -> np.ndarray:
    """utility/calculate_yaw.m: central differences, one-sided at the ends."""
    d = np.empty_like(points)
    d[1:-1] = points[2:] - points[:-2]
    d[0] = points[1] - points[0]
    d[-1] = points[-1] - points[-2]
    return np.arctan2(d[:, 1], d[:, 0])


def create_commonroad_scenario(options: Config, mpa: Mpa,
                               road: RoadData | None = None) -> Scenario:
    if road is None:
        road = get_road_data()
    n = options.amount
    rng = np.random.default_rng(int(sum(options.path_ids)))
    straight_speeds = mpa.get_straight_speeds()

    paths: list[np.ndarray] = []
    speeds = np.zeros(n)
    start_poses = np.zeros((n, 3))
    lanelet_indices: list[list[int]] = []
    points_indices: list[np.ndarray] = []
    is_loop = np.zeros(n, dtype=bool)

    for v in range(n):
        ids = get_reference_lanelets_loop(int(options.path_ids[v]))
        path, points_index = generate_reference_path_loop(ids, road)
        lanelet_indices.append(ids)
        points_indices.append(points_index)

        # loop iff last lanelet connects longitudinally to the first
        # (Commonroad.m:25-34)
        lo, hi = min(ids[0], ids[-1]), max(ids[0], ids[-1])
        if road.relationship_type[lo, hi] == RelationshipType.longitudinal:
            is_loop[v] = True
            # close the path geometrically so arc-length sampling wraps
            if np.linalg.norm(path[0] - path[-1]) > 1e-8:
                path = np.concatenate([path, path[:1]], axis=0)

        if options.start_poses:
            start_poses[v] = options.start_poses[v]
        else:
            yaw = _calculate_yaw_np(path)[0]
            start_poses[v] = (path[0, 0], path[0, 1], yaw)

        # random MPA straight-speed level (Commonroad.m:44-45)
        speeds[v] = straight_speeds[rng.integers(len(straight_speeds))]
        paths.append(path)

    eq = int(np.nonzero(mpa.trims_stop)[0][0])
    return Scenario(
        reference_paths=paths,
        reference_speeds=speeds,
        start_poses=start_poses,
        start_trims=np.full(n, eq, dtype=np.int64),
        plot_limits=np.array([[0.0, 4.5], [0.0, 4.0]]),
        road=road,
        lanelet_indices=lanelet_indices,
        points_indices=points_indices,
    )
