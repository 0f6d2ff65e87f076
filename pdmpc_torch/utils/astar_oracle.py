"""Host-side A* oracle — numpy re-implementation of the reference search.

Torch twin of pdmpc_tpu/utils/astar_oracle.py (numpy only). Replicates
hlc/optimizer/graph_search/GraphSearch.m (A* over the trim lattice with a
binary-heap priority queue, lazy exact edge evaluation on pop, goal test
at depth Hp) and expand_node.m (successor poses, cost-to-come g,
admissible cost-to-go h). Used to validate that the port's batched beam
search (ops/search.py) returns the reference optimum, on the planning
inputs ``controller.make_prioritized_step(..., debug_capture=True)``
records — the role the MATLAB implementation plays for the reference's
system tests.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from pdmpc_torch.models.mpa import Mpa


# mirror of ops/collision.py SEG_CROSS_TOL — the two predicates must stay
# in lockstep
SEG_CROSS_TOL = 1e-4


def _segments_cross_np(a1, a2, b1, b2) -> bool:
    """Any-pair segment crossing with the search's robust predicate.

    a1, a2: [A, 2] candidate-edge endpoints; b1, b2: [S, 2]. Mirrors
    ops/collision's crossing predicate (division-free, parameter band
    [-TOL, 1+TOL]) so the oracle accepts/rejects exactly the same
    touches as the device search.
    """
    r = (a2 - a1)[:, None, :]                        # [A, 1, 2]
    s = (b2 - b1)[None, :, :]                        # [1, S, 2]
    qp = b1[None, :, :] - a1[:, None, :]             # [A, S, 2]
    d = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    a_num = qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]
    b_num = qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]
    ad = np.abs(d)
    t_lim = SEG_CROSS_TOL * d * d
    m_lim = ad * (1.0 + SEG_CROSS_TOL)
    hit = (
        (ad >= 1e-9)
        & (a_num * d >= -t_lim) & (np.abs(a_num) <= m_lim)
        & (b_num * d >= -t_lim) & (np.abs(b_num) <= m_lim)
    )
    return bool(hit.any())


def _poly_edges(p: np.ndarray):
    """Closed-outline edge endpoints of polygon [V, 2]."""
    return p, np.roll(p, -1, axis=0)


def _outline_collide_np(a: np.ndarray, b: np.ndarray) -> bool:
    """Non-convex InterX-equivalent: outlines intersect
    (ops/collision.outline_hits semantics)."""
    a1, a2 = _poly_edges(a)
    b1, b2 = _poly_edges(b)
    return _segments_cross_np(a1, a2, b1, b2)


def _sat_collide_np(a: np.ndarray, b: np.ndarray) -> bool:
    """SAT for convex polygons [V, 2] (intersect_sat.m semantics)."""

    def separated(p, q):
        e = np.roll(p, -1, axis=0) - p
        axes = np.stack([-e[:, 1], e[:, 0]], axis=-1)
        n = np.linalg.norm(axes, axis=-1, keepdims=True)
        axes = axes / np.maximum(n, 1e-9)
        pa = axes @ p.T
        pb = axes @ q.T
        d1 = pa.min(axis=1) - pb.max(axis=1)
        d2 = pb.min(axis=1) - pa.max(axis=1)
        return bool(np.any(d1 > 0) or np.any(d2 > 0))

    return not (separated(a, b) or separated(b, a))


@dataclass
class OraclePlan:
    trims: np.ndarray      # [Hp]
    poses: np.ndarray      # [Hp, 3]
    cost: float
    is_exhausted: bool
    n_expanded: int


def astar_plan(
    mpa: Mpa,
    x0: np.ndarray,
    trim0: int,
    ref_points: np.ndarray,
    v_ref: np.ndarray,
    obs_polys: np.ndarray,   # [n_obs, Hp, V, 2]
    obs_mask: np.ndarray,    # [n_obs, Hp]
    dt: float,
    boundary_segments: np.ndarray | None = None,   # [S, 2, 2]
    boundary_mask: np.ndarray | None = None,       # [S]
    non_convex: bool = False,
) -> OraclePlan:
    """Reference A* with the full road-path constraint set.

    ``non_convex`` switches the obstacle check from SAT to the
    outline-crossing (InterX-equivalent) test on the non-convex area
    family; ``boundary_segments`` adds the lanelet-boundary constraint
    (without-offset swept area, large-offset at the final step —
    GraphSearch.m:166-174 shapes_for_boundary_check).
    """
    hp = mpa.Hp
    if non_convex:
        area_obs = mpa.area_nc
        area_bnd_no = mpa.area_nc_no_offset
        area_bnd_lg = mpa.area_nc_large_offset
    else:
        area_obs = mpa.area_conv
        area_bnd_no = mpa.area_conv_no_offset
        area_bnd_lg = mpa.area_conv_large_offset
    if boundary_segments is not None:
        bseg = np.asarray(boundary_segments, dtype=float)
        bmask = np.asarray(boundary_mask, dtype=bool)
        bnd1 = bseg[bmask, 0]
        bnd2 = bseg[bmask, 1]
    else:
        bnd1 = bnd2 = None
    # node: (x, y, yaw, trim, k, g)
    nodes = [(float(x0[0]), float(x0[1]), float(x0[2]), int(trim0), 0, 0.0)]
    parents = [-1]
    checked: list[bool] = [True]

    counter = 0
    pq: list[tuple[float, int, int]] = [(0.0, counter, 0)]
    n_expanded = 0

    def edge_collides(node_id: int) -> bool:
        p = parents[node_id]
        if p < 0:
            return False
        px, py, pyaw, ptrim, _, _ = nodes[p]
        _, _, _, ctrim, ck, _ = nodes[node_id]
        c, s = np.cos(pyaw), np.sin(pyaw)

        def to_world(local):
            return np.stack(
                [
                    c * local[:, 0] - s * local[:, 1] + px,
                    s * local[:, 0] + c * local[:, 1] + py,
                ],
                axis=-1,
            )

        world = to_world(area_obs[ptrim, ctrim])
        k = ck - 1  # 0-based prediction step of this edge
        hit_test = _outline_collide_np if non_convex else _sat_collide_np
        for o in range(obs_polys.shape[0]):
            if not obs_mask[o, k]:
                continue
            if hit_test(world, obs_polys[o, k]):
                return True
        if bnd1 is not None and len(bnd1):
            bnd_local = (
                area_bnd_lg[ptrim, ctrim] if k == hp - 1
                else area_bnd_no[ptrim, ctrim]
            )
            a1, a2 = _poly_edges(to_world(bnd_local))
            if _segments_cross_np(a1, a2, bnd1, bnd2):
                return True
        return False

    while pq:
        _, _, cur = heapq.heappop(pq)
        if edge_collides(cur):
            continue
        x, y, yaw, trim, k, g = nodes[cur]
        if k == hp:
            # goal: backtrack
            trims = np.zeros(hp, dtype=np.int64)
            poses = np.zeros((hp, 3))
            node_id = cur
            while parents[node_id] >= 0:
                nx, ny, nyaw, ntrim, nk, _ = nodes[node_id]
                trims[nk - 1] = ntrim
                poses[nk - 1] = (nx, ny, nyaw)
                node_id = parents[node_id]
            return OraclePlan(trims, poses, g, False, n_expanded)

        # expand (expand_node.m)
        n_expanded += 1
        c, s = np.cos(yaw), np.sin(yaw)
        for j in np.nonzero(mpa.transition[k][trim])[0]:
            dx, dy, dyaw = mpa.dx[trim, j], mpa.dy[trim, j], mpa.dyaw[trim, j]
            nx2 = c * dx - s * dy + x
            ny2 = s * dx + c * dy + y
            nyaw2 = yaw + dyaw
            gg = g + float(
                (nx2 - ref_points[k, 0]) ** 2 + (ny2 - ref_points[k, 1]) ** 2
            )
            h = 0.0
            d_max = 0.0
            for i_t in range(k + 1, hp):
                d_max += dt * float(v_ref[i_t])
                dist = float(
                    np.hypot(nx2 - ref_points[i_t, 0], ny2 - ref_points[i_t, 1])
                )
                h += max(0.0, dist - d_max) ** 2
            nodes.append((nx2, ny2, nyaw2, int(j), k + 1, gg))
            parents.append(cur)
            checked.append(False)
            counter += 1
            heapq.heappush(pq, (gg + h, counter, len(nodes) - 1))

    return OraclePlan(
        np.zeros(hp, dtype=np.int64), np.zeros((hp, 3)), np.inf, True,
        n_expanded,
    )
