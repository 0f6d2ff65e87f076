"""Scenario container: fixed-shape tensors describing vehicles and roads.

Torch twin of pdmpc_tpu/scenarios/scenario.py: a scenario is a set of
padded tensors (reference paths, speeds, start poses) on one device, plus
road-network data for commonroad scenarios. The packing is numpy, so every
field equals its JAX twin exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from pdmpc_torch.models.bicycle import VEHICLE_LENGTH, VEHICLE_WIDTH
from pdmpc_torch.scenarios.road import RelationshipType

# Obstacle polygons are padded to a common vertex count
# (pdmpc_tpu/ops/search.py VO).
VO = 16


class RoadTensors(NamedTuple):
    """Road-network constants. Boundary segments are indexed by 1-based
    lanelet id; row 0 is a dummy all-masked entry (id 0 = no lanelet)."""

    boundary_segments: torch.Tensor   # [L+1, S_max, 2, 2] f32
    boundary_seg_mask: torch.Tensor   # [L+1, S_max] bool
    corridor_rings: torch.Tensor      # [L+1, R_max, 2] f32 (pad-by-repeat)
    adjacency_lanelets: torch.Tensor  # [L+1, L+1] bool
    hdv_predecessor: torch.Tensor     # [L+1, L+1] bool
    hdv_overlap: torch.Tensor         # [L+1, L+1] bool
    centerlines: torch.Tensor         # [L+1, C_max, 2] f32 (row 0 far away)


class ScenarioTensors(NamedTuple):
    """Scenario constants on one device."""

    reference_paths: torch.Tensor  # [N, P, 2] f32, padded by repeating
    path_cumlen: torch.Tensor      # [N, P] f32 cumulative arc length
    is_loop: torch.Tensor          # [N] bool
    reference_speed: torch.Tensor  # [N] f32
    start_poses: torch.Tensor      # [N, 3] f32
    start_trims: torch.Tensor      # [N] i64
    is_hdv: torch.Tensor           # [N] bool
    static_obstacles: Any = None       # [O, VO, 2] f32
    static_obstacle_mask: Any = None   # [O] bool
    segment_lanelet: Any = None    # [N, P-1] i64: 1-based lanelet id
    road: Any = None               # RoadTensors

    @property
    def n_vehicles(self) -> int:
        return self.start_poses.shape[0]


@dataclass
class Scenario:
    """Host-side scenario description (numpy)."""

    reference_paths: list[np.ndarray]   # per vehicle [P_i, 2]
    reference_speeds: np.ndarray        # [N]
    start_poses: np.ndarray             # [N, 3]
    start_trims: np.ndarray             # [N] int
    vehicle_length: float = VEHICLE_LENGTH
    vehicle_width: float = VEHICLE_WIDTH
    plot_limits: np.ndarray = field(
        default_factory=lambda: np.array([[0.0, 4.5], [0.0, 4.0]])
    )
    road: Any = None  # RoadData for commonroad scenarios
    is_hdv: Any = None  # [N] bool
    obstacles: list[np.ndarray] = field(default_factory=list)
    lanelet_indices: Any = None   # per vehicle: list of 1-based lanelet ids
    points_indices: Any = None    # per vehicle: last-point count per lanelet

    @property
    def n_vehicles(self) -> int:
        return self.start_poses.shape[0]

    def to_tensors(self, device: torch.device | str = "cuda"
                   ) -> ScenarioTensors:
        n = self.n_vehicles
        p_max = max(p.shape[0] for p in self.reference_paths)
        paths = np.zeros((n, p_max, 2), dtype=np.float32)
        is_loop = np.zeros(n, dtype=bool)
        for i, p in enumerate(self.reference_paths):
            paths[i, : p.shape[0]] = p
            paths[i, p.shape[0]:] = p[-1]
            # loop iff first and last points coincide
            # (sample_reference_trajectory.m:40)
            is_loop[i] = np.linalg.norm(p[0] - p[-1]) < 1e-8
        seg = np.linalg.norm(np.diff(paths, axis=1), axis=-1)
        cumlen = np.concatenate(
            [np.zeros((n, 1), dtype=np.float32), np.cumsum(seg, axis=1)],
            axis=1,
        )

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a, dtype=dtype), device=device)

        segment_lanelet = road_tensors = None
        if self.road is not None and self.lanelet_indices is not None:
            segment_lanelet = t(self._segment_lanelet_array(p_max), np.int64)
            road_tensors = road_to_tensors(self.road, device)

        is_hdv = (np.asarray(self.is_hdv, dtype=bool)
                  if self.is_hdv is not None else np.zeros(n, dtype=bool))

        static_obstacles = static_obstacle_mask = None
        if self.obstacles:
            obs = np.zeros((len(self.obstacles), VO, 2), dtype=np.float32)
            for i, poly in enumerate(self.obstacles):
                poly = np.asarray(poly, dtype=np.float32)
                assert poly.shape[0] <= VO, (
                    f"obstacle polygon has {poly.shape[0]} > {VO} vertices"
                )
                obs[i, : poly.shape[0]] = poly
                obs[i, poly.shape[0]:] = poly[-1]
            static_obstacles = t(obs, np.float32)
            static_obstacle_mask = t(np.ones(len(self.obstacles)), bool)
        return ScenarioTensors(
            reference_paths=t(paths, np.float32),
            path_cumlen=t(cumlen, np.float32),
            is_loop=t(is_loop, bool),
            reference_speed=t(self.reference_speeds, np.float32),
            start_poses=t(self.start_poses, np.float32),
            start_trims=t(self.start_trims, np.int64),
            is_hdv=t(is_hdv, bool),
            static_obstacles=static_obstacles,
            static_obstacle_mask=static_obstacle_mask,
            segment_lanelet=segment_lanelet,
            road=road_tensors,
        )

    def _segment_lanelet_array(self, p_max: int) -> np.ndarray:
        """1-based lanelet id of each path segment, padded to [N, p_max-1].

        Segment s spans points s -> s+1; its lanelet is the lanelet of its
        end point (the lanelet being entered at junctions).
        """
        n = self.n_vehicles
        out = np.zeros((n, p_max - 1), dtype=np.int64)
        for v in range(n):
            ids = np.asarray(self.lanelet_indices[v], dtype=np.int64)
            points_index = np.asarray(self.points_indices[v])
            n_points = self.reference_paths[v].shape[0]
            for s in range(p_max - 1):
                p_end = min(s + 1, n_points - 1)
                # lanelet j covers points [points_index[j-1], points_index[j])
                j = int(np.searchsorted(points_index, p_end, side="right"))
                j = min(j, len(ids) - 1)
                out[v, s] = ids[j]
        return out


def road_to_tensors(road, device: torch.device | str = "cuda") -> RoadTensors:
    """Pack per-lanelet extended boundaries into fixed-shape segment
    tensors (row 0 = dummy for 'no lanelet')."""
    n_lanelets = road.n_lanelets
    seg_counts = [
        (road.boundary_left[i].shape[0] - 1)
        + (road.boundary_right[i].shape[0] - 1)
        for i in range(n_lanelets)
    ]
    s_max = max(seg_counts)
    segs = np.zeros((n_lanelets + 1, s_max, 2, 2), dtype=np.float32)
    mask = np.zeros((n_lanelets + 1, s_max), dtype=bool)
    for i in range(n_lanelets):
        parts = [np.stack([b[:-1], b[1:]], axis=1)
                 for b in (road.boundary_left[i], road.boundary_right[i])]
        all_segs = np.concatenate(parts, axis=0)
        segs[i + 1, : all_segs.shape[0]] = all_segs
        mask[i + 1, : all_segs.shape[0]] = True

    # corridor rings: left bound followed by reversed right bound closes the
    # drivable band of each lanelet (get_lanelets_boundary.m's polyshape)
    r_max = max(
        road.boundary_left[i].shape[0] + road.boundary_right[i].shape[0]
        for i in range(n_lanelets)
    )
    rings = np.zeros((n_lanelets + 1, r_max, 2), dtype=np.float32)
    for i in range(n_lanelets):
        ring = np.concatenate(
            [road.boundary_left[i], road.boundary_right[i][::-1]], axis=0
        )
        rings[i + 1, : ring.shape[0]] = ring
        rings[i + 1, ring.shape[0]:] = ring[-1]
    # directional CAV-HDV matrices (is_hdv_behind.m): lanelet h precedes c
    # if their relationship is longitudinal and h's end meets c's start
    # (tol 1e-6, is_hdv_behind.m:36-56); overlap = merging/forking (:28-32)
    rel = road.relationship_type
    rel_sym = np.maximum(rel, rel.T)  # rel is upper-triangular by (min,max)
    tol = 1e-6
    pred = np.zeros((n_lanelets + 1, n_lanelets + 1), dtype=bool)
    for c in range(1, n_lanelets + 1):
        lc = road.lanelets[c - 1]
        for h in range(1, n_lanelets + 1):
            if h == c or rel_sym[c, h] != RelationshipType.longitudinal:
                continue
            lh = road.lanelets[h - 1]
            pred[c, h] = (
                np.linalg.norm(lc.center[0] - lh.center[-1]) <= tol
                or np.linalg.norm(lc.left[0] - lh.right[-1]) <= tol
                or np.linalg.norm(lc.right[0] - lh.left[-1]) <= tol
            )
    overlap = (rel_sym == RelationshipType.merging) | (
        rel_sym == RelationshipType.forking
    )
    overlap[0, :] = overlap[:, 0] = False
    c_max = max(road.lanelets[i].center.shape[0] for i in range(n_lanelets))
    centers = np.full((n_lanelets + 1, c_max, 2), 1e6, dtype=np.float32)
    for i in range(n_lanelets):
        c = road.lanelets[i].center
        centers[i + 1, : c.shape[0]] = c
        centers[i + 1, c.shape[0]:] = c[-1]

    def t(a):
        return torch.as_tensor(a, device=device)

    return RoadTensors(
        boundary_segments=t(segs),
        boundary_seg_mask=t(mask),
        corridor_rings=t(rings),
        adjacency_lanelets=t(np.asarray(road.adjacency_lanelets, dtype=bool)),
        hdv_predecessor=t(pred),
        hdv_overlap=t(overlap),
        centerlines=t(centers),
    )


def map_position_to_closest_lanelets(road: RoadTensors, xy: torch.Tensor):
    """1-based id of the lanelet whose centerline is closest to ``xy``
    [..., 2], plus the mask [..., L+1] of all lanelets within 0.1 m of that
    minimum. Reference: map_position_to_closest_lanelets.m:1-25."""
    diff = road.centerlines - xy[..., None, None, :]
    d = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    d_min = d.amin(dim=-1)                              # [..., L+1]
    best = torch.argmin(d_min, dim=-1)
    within = d_min <= d_min.gather(-1, best[..., None]) + 0.1
    return best, within
