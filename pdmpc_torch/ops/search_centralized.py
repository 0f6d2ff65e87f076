"""Centralized joint trajectory search over the multi-vehicle trim product.

Torch twin of pdmpc_tpu/ops/search_centralized.py (the reference's
CentralizedController.m + expand_node.m:15-27 +
MotionPrimitiveAutomaton.trim_tuple): one beam search over the Cartesian
product of all vehicles' trim lattices. Each layer expands every beam node
by all ``n_trims^N`` joint successor tuples, masks them by each vehicle's
transition feasibility, by pairwise collisions between the vehicles of a
tuple, by the static obstacles and by each vehicle's lanelet boundary,
and keeps the ``beam_width`` cheapest. Exponential in N like the
reference: the small-fleet baseline.

The checks against the scenario go through ``ops.collision``'s kernels in
their (cx, cy) form, one planning row a vehicle and the beam's B * T
tuple candidates as its candidates: ``boundary_hits`` for the lanelet
boundary (the XLA form of ``candidate_boundary_violations``) and
``sat_hits`` for static obstacles. The pairwise checks within a tuple
stay torch ops in the XLA form (``_sat_separates_batch``): no kernel
computes that shape.

Multiply-adds and sums follow XLA:CPU's compilation of the reference
(tests/test_torch_numerics.py maps them): the child poses and the placed
areas fuse as the prioritized search's do, the squares under the
heuristic's square root fuse their first term, ``fma(dx, dx, dy * dy)``,
the step cost accumulates the vehicles' squares fused into one sum,
``acc = fma(z, z, acc)`` (dy before dx), and the heuristic adds its
rounded squares vehicle by vehicle, step by step.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pdmpc_torch.models.mpa import MpaTensors
from pdmpc_torch.ops.collision import (
    boundary_hits,
    precompute_obstacles,
    precompute_segments,
    sat_hits,
)
from pdmpc_torch.ops.geometry import fma
from pdmpc_torch.ops.search import (
    Obstacles,
    _sat_separates_batch,
    stable_top_k,
)

# Most (beam node, joint tuple) candidates a layer (the reference's guard).
MAX_JOINT_CANDIDATES = 8_000_000


class JointPlanResult(NamedTuple):
    trims: torch.Tensor         # [Hp, N] i64
    poses: torch.Tensor         # [Hp, N, 3] f32
    shapes: torch.Tensor        # [Hp, N, VA, 2] f32
    cost: torch.Tensor          # [] f32
    is_exhausted: torch.Tensor  # [] bool
    n_expanded: torch.Tensor    # [] i64


def _sum_of_squares(parts, fused: bool) -> torch.Tensor:
    """The sum of squares of the tensors ``parts`` in the order given, one
    accumulator: each square fused into it, ``acc = fma(z, z, acc)``, or
    rounded and then added (tests/test_torch_numerics.py maps which
    sum XLA:CPU compiles which way)."""
    acc = None
    for z in parts:
        acc = (z * z if acc is None else fma(z, z, acc) if fused
               else acc + z * z)
    return acc


def _gather_allowed(allowed_vt, decode):
    """allowed_vt [B, N, n], decode [T, N] -> [B, T, N] bool: whether
    vehicle v may take its trim of tuple t from beam node b."""
    veh = torch.arange(decode.shape[1], device=decode.device)
    return allowed_vt[:, veh, decode]


def _gather_maneuver(table, trim, decode):
    """table [n, n, ...] of maneuvers from a trim to its successor; trim
    [B, N]; decode [T, N] -> [B, T, N, ...]: each vehicle's entry from its
    node trim to its trim in tuple t (the areas too, as ``_gather_areas``
    does in the reference)."""
    return table[trim[:, None, :], decode[None]]


def _place(c, s, areas, pose):
    """Areas [B, T, N, VA, 2] placed at the parents' poses [B, N, 3] with
    yaw cosines and sines c, s [B, N], fused as the reference's XLA path
    is: x = fma(c, ax, -(s * ay)) + px, y = fma(s, ax, c * ay) + py.
    Returns x, y [B, T, N, VA]."""
    c4, s4 = c[:, None, :, None], s[:, None, :, None]
    ax, ay = areas[..., 0], areas[..., 1]
    x = fma(c4, ax, -(s4 * ay)) + pose[:, None, :, None, 0]
    y = fma(s4, ax, c4 * ay) + pose[:, None, :, None, 1]
    return x, y


def _vertex_major(x, y):
    """Placed areas x, y [B, T, N, VA] as the kernels' candidates
    cx, cy [N, VA, B * T]: a planning row a vehicle."""
    n, va = x.shape[2:]
    return tuple(z.permute(2, 3, 0, 1).reshape(n, va, -1).contiguous()
                 for z in (x, y))


def plan_centralized(
    mpa: MpaTensors,
    x0: torch.Tensor,            # [N, 3]
    trim0: torch.Tensor,         # [N] i64
    ref_points: torch.Tensor,    # [N, Hp, 2]
    v_ref: torch.Tensor,         # [N, Hp]
    dt: float,
    beam_width: int,
    obstacles: Obstacles | None = None,           # polys [O, Hp, VO, 2]
    boundary_segments: torch.Tensor | None = None,  # [N, S, 2, 2]
    boundary_mask: torch.Tensor | None = None,      # [N, S]
) -> JointPlanResult:
    """Joint plan for all vehicles (no coupling graph, no fallback).

    Reference: pdmpc_tpu/ops/search_centralized.py plan_centralized
    (:40-248). The joint search applies the prioritized one's edge
    evaluation (are_constraints_satisfied_sat.m:1-68): pairwise vehicle
    collisions within a candidate tuple, static obstacle polygons
    (``obstacles``, shared by all vehicles, mask [O, Hp]) and each
    vehicle's lanelet boundary segments, checked against its swept area
    without offset (the larger-offset area at the last step,
    GraphSearch.m:166-174). The beam keeps ``beam_width`` rows at every
    layer, invalid ones included, as the reference's does, so an
    exhausted search backtracks the same rows.
    """
    n_veh = x0.shape[0]
    n = mpa.n_trims
    hp = mpa.Hp
    b = beam_width
    t_total = n ** n_veh
    if t_total * beam_width > MAX_JOINT_CANDIDATES:
        raise ValueError(
            f"centralized product space too large: {n}^{n_veh} tuples x "
            f"beam {beam_width}"
        )
    dev = x0.device

    # joint tuple index -> per-vehicle trims [T, N]
    tuple_idx = torch.arange(t_total, device=dev)
    decode = torch.stack([(tuple_idx // (n ** v)) % n
                          for v in range(n_veh)], dim=-1)

    pose = x0[None].expand(b, n_veh, 3)
    trim = trim0[None].expand(b, n_veh)
    g = torch.zeros((b,), device=dev)
    valid = torch.zeros((b,), dtype=torch.bool, device=dev)
    valid[0] = True
    n_expanded = torch.zeros((), dtype=torch.int64, device=dev)

    seg_pre = None
    if boundary_segments is not None:
        # one segment bundle for every layer: a row a vehicle
        seg_pre = precompute_segments(boundary_segments, boundary_mask)
    steps = torch.arange(hp, device=dev)

    poses_l, trims_l, parents_l = [], [], []
    for k in range(hp):
        # per-vehicle successor feasibility of every tuple
        allowed_vt = mpa.transition[k][trim]                 # [B, N, n]
        allowed = _gather_allowed(allowed_vt, decode).all(dim=-1)  # [B, T]

        c = torch.cos(pose[..., 2])                          # [B, N]
        s = torch.sin(pose[..., 2])
        mdx = _gather_maneuver(mpa.dx, trim, decode)         # [B, T, N]
        mdy = _gather_maneuver(mpa.dy, trim, decode)
        child_x = (fma(c[:, None], mdx, -(s[:, None] * mdy))
                   + pose[:, None, :, 0])
        child_y = fma(s[:, None], mdx, c[:, None] * mdy) + pose[:, None, :, 1]
        child_yaw = pose[:, None, :, 2] + _gather_maneuver(mpa.dyaw, trim,
                                                           decode)

        # cost: sum over vehicles (expand_node.m:61-73)
        dxr = child_x - ref_points[None, None, :, k, 0]
        dyr = child_y - ref_points[None, None, :, k, 1]
        # the vehicles' squares accumulate as dy0, dx0, dy1, dx1, ...
        g_child = g[:, None] + _sum_of_squares(
            (z[..., i] for i in range(n_veh) for z in (dyr, dxr)), True)

        # the distance travelable until each future step (the heuristic)
        future = steps > k                                   # [Hp]
        dvmax = torch.where(future, dt * v_ref, torch.zeros_like(v_ref))
        d_max = torch.cumsum(dvmax, dim=-1)                  # [N, Hp]
        ex = child_x[..., None] - ref_points[:, :, 0]        # [B, T, N, Hp]
        ey = child_y[..., None] - ref_points[:, :, 1]
        dist = torch.sqrt(fma(ex, ex, ey * ey))
        short = torch.clamp_min(dist - d_max, 0.0)
        # the future steps' shortfalls, vehicle by vehicle, step by step
        # (a past step adds an exact zero in the reference)
        h_child = (_sum_of_squares((short[..., i, j] for i in range(n_veh)
                                    for j in range(k + 1, hp)), False)
                   if k + 1 < hp else torch.zeros_like(g_child))

        # pairwise collision among the vehicles' swept areas of a tuple
        ax, ay = _place(c, s, _gather_maneuver(mpa.area, trim, decode),
                        pose)                                # [B, T, N, VA]
        world = torch.stack([ax, ay], dim=-1)
        collide = torch.zeros_like(allowed)
        for i in range(n_veh):
            for j in range(i + 1, n_veh):
                collide |= ~_sat_separates_batch(world[:, :, i],
                                                 world[:, :, j])

        # the scenario's checks, through the kernels: each vehicle's row
        # scans the tuples whose parent is valid and whose trims are
        # allowed, so ``clear`` is that live mask minus every hit
        live = (valid[:, None] & allowed).reshape(1, -1).expand(n_veh, -1)
        clear = live
        if obstacles is not None:
            # every vehicle's swept area against the active static
            # obstacles of this step (are_constraints_satisfied_sat.m:15-35)
            obs_pre = precompute_obstacles(
                obstacles.polys[:, k][None].expand(n_veh, -1, -1, -1),
                obstacles.mask[:, k][None].expand(n_veh, -1))
            clear = sat_hits(*_vertex_major(ax, ay), obs_pre,
                             clear.contiguous())
        if seg_pre is not None:
            # without-offset swept areas, large offset at the final step
            table = (mpa.area_large_offset if k == hp - 1
                     else mpa.area_no_offset)
            areas_b = _gather_maneuver(table, trim, decode)
            clear = boundary_hits(*_vertex_major(*_place(c, s, areas_b,
                                                         pose)),
                                  seg_pre, clear.contiguous())
        feasible = clear.all(dim=0).reshape(b, t_total) & ~collide
        n_expanded = n_expanded + feasible.sum()

        score = torch.where(feasible, g_child + h_child,
                            torch.full_like(g_child, math.inf))
        neg_top, flat_idx = stable_top_k(-score.reshape(-1), b)
        parent = flat_idx // t_total
        new_valid = neg_top > -math.inf
        new_trim = decode[flat_idx % t_total]                # [B, N]
        new_pose = torch.stack([x.reshape(b * t_total, n_veh)[flat_idx]
                                for x in (child_x, child_y, child_yaw)],
                               dim=-1)
        g = g_child.reshape(-1)[flat_idx]
        poses_l.append(new_pose)
        trims_l.append(new_trim)
        parents_l.append(parent)
        pose, trim, valid = new_pose, new_trim, new_valid

    leaf_score = torch.where(valid, g, torch.full_like(g, math.inf))
    best = torch.argmin(leaf_score)                          # first minimum
    is_exhausted = ~valid.any()
    cost = leaf_score[best]

    idx = best
    trims_rev, poses_rev = [], []
    for k in range(hp - 1, -1, -1):
        trims_rev.append(trims_l[k][idx])
        poses_rev.append(poses_l[k][idx])
        idx = parents_l[k][idx]
    trims_path = torch.stack(trims_rev[::-1])                # [Hp, N]
    poses_path = torch.stack(poses_rev[::-1])                # [Hp, N, 3]

    parent_poses = torch.cat([x0[None], poses_path[:-1]], dim=0)
    parent_trims = torch.cat([trim0[None], trims_path[:-1]], dim=0)
    areas = mpa.area[parent_trims, trims_path]               # [Hp, N, VA, 2]
    cps = torch.cos(parent_poses[..., 2])[..., None]
    sps = torch.sin(parent_poses[..., 2])[..., None]
    sx = fma(cps, areas[..., 0], -(sps * areas[..., 1])) + parent_poses[
        ..., 0:1]
    sy = fma(sps, areas[..., 0], cps * areas[..., 1]) + parent_poses[..., 1:2]
    return JointPlanResult(
        trims=trims_path,
        poses=poses_path,
        shapes=torch.stack([sx, sy], dim=-1),
        cost=cost,
        is_exhausted=is_exhausted,
        n_expanded=n_expanded,
    )
