"""Batched trim-lattice trajectory search — the optimizer.

Torch twin of pdmpc_tpu/ops/search.py's two searches:

- ``plan_trajectory`` (the optimal path): the frontier is expanded layer
  by layer over the horizon; every (beam node x successor trim) candidate
  is cost-evaluated and collision-masked at once, then the best
  ``beam_width`` candidates survive;
- ``plan_trajectory_sampled`` (TpuSampled): R independent rollouts, each
  drawing its successor trim from a softmax over the negative one-step
  cost by the Gumbel-max trick, dead at its first infeasible edge; the
  cheapest surviving rollout wins. Its Gumbel noise comes in as an
  argument (``rollout_noise`` draws the reference's).

Every function takes a leading vehicle dim V, so one call plans a whole
planning chunk and each search layer launches each collision kernel once.

The collision checks go only through ``ops.collision``'s wrappers: the
CUDA kernels on the card, their plain versions on the CPU. Obstacles are
checked by outline crossing (road scenarios, ``non_convex``) or by SAT
(convex path); the lanelet boundary, where there is one, by crossing. Each
check takes the layer's lattice (area table, parent trims, poses, yaw
cosines and sines) and its live mask and returns the feasibility mask: the
kernels build the candidates in registers and scan only live ones, so a
layer's whole collision mask is one or two launches. The sampled search
has no lattice, one candidate a rollout: it places the R drawn areas and
checks them in the kernels' (cx, cy) form with the rollouts' live mask.

Multiply-adds that XLA:CPU contracts in the reference (the child pose
``fma(c, dx, -(s * dy)) + x`` and ``fma(s, dx, c * dy) + y``, the same
transform of the candidate areas, and the step cost ``fma(dy, dy,
dx * dx)``) are fused here too, so poses and costs equal the reference's
bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pdmpc_torch import prng
from pdmpc_torch.models.mpa import MpaTensors
from pdmpc_torch.ops.collision import (
    Lattice,
    SegmentsPre,
    boundary_hits,
    boundary_hits_lattice,
    outline_hits,
    outline_hits_lattice,
    precompute_obstacles,
    precompute_outline,
    precompute_segments,
    sat_hits,
    sat_hits_lattice,
)
from pdmpc_torch.ops.geometry import fma
from pdmpc_torch.scenarios.scenario import VO


class Obstacles(NamedTuple):
    """Dynamic obstacles per planning vehicle.

    ``polys``: [V, n_obs, Hp, VO, 2] — polygon of obstacle o at prediction
    step k (an expanded view when all vehicles share one obstacle set);
    ``mask``: [V, n_obs, Hp] — False entries are ignored.
    """

    polys: torch.Tensor
    mask: torch.Tensor


def pad_polys_to_vo(polys: torch.Tensor) -> torch.Tensor:
    """Pad polygons [..., V, 2] to [..., VO, 2] by repeating the last vertex."""
    v = polys.shape[-2]
    if v == VO:
        return polys
    assert v < VO, f"polygon vertex count {v} exceeds VO={VO}"
    last = polys[..., -1:, :].expand(*polys.shape[:-2], VO - v, 2)
    return torch.cat([polys, last], dim=-2)


def polys_to_edge_segments(polys, mask):
    """Polygon outlines [..., NO, VO, 2] (mask [..., NO]) as their edge
    segments [..., NO*VO, 2, 2] with segment mask [..., NO*VO]."""
    *lead, no, vo, _ = polys.shape
    segs = torch.stack([polys, torch.roll(polys, -1, dims=-2)], dim=-2)
    return (segs.reshape(*lead, no * vo, 2, 2),
            torch.repeat_interleave(mask, vo, dim=-1))


def _vertex_major(man_polys):
    """Candidates [C, VA, 2] -> cx, cy [1, VA, C] (the kernels' layout)."""
    cand = man_polys.permute(1, 2, 0)
    return cand[None, :, 0].contiguous(), cand[None, :, 1].contiguous()


def candidate_boundary_violations(man_polys, boundary_segments,
                                  boundary_mask):
    """[C] True where a candidate polygon [C, VA, 2] crosses an active
    boundary segment ([S, 2, 2], mask [S]) — the reference-layout entry
    (intersect_lanelet_boundary.m), through the boundary kernel's wrapper."""
    pre = precompute_segments(boundary_segments[None], boundary_mask[None])
    return boundary_hits(*_vertex_major(man_polys), pre)[0]


def candidate_outline_collisions(man_polys, obs_polys, obs_mask):
    """[C] True where a candidate outline [C, VA, 2] crosses the outline of
    an active obstacle ([n_obs, VO, 2], mask [n_obs]) — InterX semantics
    (OptimizerInterface.m:36-46), through the outline kernel's wrapper."""
    pre = precompute_outline(obs_polys[None], obs_mask[None])
    return outline_hits(*_vertex_major(man_polys), pre)[0]


def candidate_collisions(man_polys, obs_polys, obs_mask):
    """[C] True where a convex candidate [C, VA, 2] overlaps an active
    convex obstacle ([n_obs, VB, 2], mask [n_obs]) — the reference-layout
    entry of the SAT check (GraphSearch.m:111-196), through the SAT
    kernel's wrapper."""
    pre = precompute_obstacles(obs_polys[None], obs_mask[None])
    return sat_hits(*_vertex_major(man_polys), pre)[0]


class PlanResult(NamedTuple):
    trims: torch.Tensor         # [V, Hp] i64 — predicted trims
    poses: torch.Tensor         # [V, Hp, 3] f32 — predicted poses
    shapes: torch.Tensor        # [V, Hp, VA, 2] f32 — swept areas (offset)
    cost: torch.Tensor          # [V] f32 — accumulated g of the chosen leaf
    is_exhausted: torch.Tensor  # [V] bool — no feasible leaf found
    n_expanded: torch.Tensor    # [V] i64 — feasible candidates, all layers


def stable_top_k(x: torch.Tensor, k: int):
    """The ``k`` largest entries of ``x`` along its last dim and their
    indices, ties to the lower index first, as ``lax.top_k`` (a stable
    descending sort; ``torch.topk`` does not promise the tie order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _cost_to_go(pos, ref_points, v_ref, k_child: int, dt: float):
    """Admissible cost-to-go (expand_node.m:63-73) of positions
    ``pos`` [V, ..., 2] after step ``k_child``: sum over future steps i of
    max(0, |pos - ref_i| - d_max_i)^2, d_max_i the distance travelable
    until step i. ref_points [V, Hp, 2]; v_ref [V, Hp]."""
    hp = ref_points.shape[1]
    future = torch.arange(hp, device=pos.device) > k_child      # [Hp]
    dv = torch.where(future, dt * v_ref, torch.zeros_like(v_ref))
    d_max = torch.cumsum(dv, dim=-1)                             # [V, Hp]
    lead = (slice(None),) + (None,) * (pos.dim() - 2)
    diff = pos[..., None, :] - ref_points[lead]                  # [V,...,Hp,2]
    dist = torch.sqrt(diff[..., 0] * diff[..., 0]
                      + diff[..., 1] * diff[..., 1])
    short = torch.clamp_min(dist - d_max[lead], 0.0)
    sq = torch.where(future, short * short, torch.zeros_like(short))
    return torch.sum(sq, dim=-1)


def plan_trajectory(
    mpa: MpaTensors,
    x0: torch.Tensor,            # [V, 3] pose (x, y, yaw)
    trim0: torch.Tensor,         # [V] i64
    ref_points: torch.Tensor,    # [V, Hp, 2]
    v_ref: torch.Tensor,         # [V, Hp]
    obstacles: Obstacles,
    dt: float,
    beam_width: int,
    boundary_segments: torch.Tensor | None = None,   # [V, S, 2, 2]
    boundary_mask: torch.Tensor | None = None,       # [V, S]
    segments_pre: SegmentsPre | None = None,         # precomputed bundle
    non_convex: bool = False,
) -> PlanResult:
    """Plan V vehicles' Hp-step trajectories through the trim lattice.

    Reference: pdmpc_tpu/ops/search.py plan_trajectory (:286-655).
    Obstacles are checked by SAT (convex areas, the circle scenario) or,
    with ``non_convex``, by outline crossing (road scenarios,
    OptimizerInterface.m:36-46); ``mpa`` must carry the matching area
    family. When boundary segments are given, every candidate's swept area
    without offset (the larger-offset area at the last step) is checked
    against the lanelet boundary too (GraphSearch.m:166-174).
    """
    n = mpa.n_trims
    hp = mpa.Hp
    v = x0.shape[0]
    dev = x0.device
    rows = torch.arange(v, device=dev)

    # candidate-independent obstacle geometry, once per planning pass for
    # all Hp layers: [Hp, V, NO_pad, VO] so each layer's slice is contiguous
    precompute = precompute_outline if non_convex else precompute_obstacles
    obs_pre = precompute(obstacles.polys.permute(2, 0, 1, 3, 4),
                         obstacles.mask.permute(2, 0, 1))
    if segments_pre is None and boundary_segments is not None:
        segments_pre = precompute_segments(boundary_segments, boundary_mask)

    # beam widths per layer: layer k holds at most (prev width) * n nodes,
    # so early layers are exhaustive and skip the top-k
    widths = []
    w = 1
    for _ in range(hp):
        w = min(beam_width, w * n)
        widths.append(w)

    pose = x0[:, None, :]                                     # [V, 1, 3]
    trim = trim0[:, None]
    g = torch.zeros((v, 1), device=dev)
    valid = torch.ones((v, 1), dtype=torch.bool, device=dev)
    n_expanded = torch.zeros((v,), dtype=torch.int64, device=dev)
    poses_l, trims_l, parents_l = [], [], []
    b_in = 1
    for k in range(hp):
        b_out = widths[k]
        # --- expansion: every (beam node, successor trim) pair -----------
        allowed = mpa.transition[k][trim]                     # [V, B, n]
        c = torch.cos(pose[..., 2])[..., None]                # [V, B, 1]
        s = torch.sin(pose[..., 2])[..., None]
        mdx = mpa.dx[trim]
        mdy = mpa.dy[trim]
        child_x = fma(c, mdx, -(s * mdy)) + pose[..., 0:1]
        child_y = fma(s, mdx, c * mdy) + pose[..., 1:2]
        child_yaw = pose[..., 2:3] + mpa.dyaw[trim]
        child_pos = torch.stack([child_x, child_y], dim=-1)   # [V, B, n, 2]

        # --- costs (expand_node.m:61-73) ---------------------------------
        diff = child_pos - ref_points[:, k, None, None, :]
        g_child = g[..., None] + fma(diff[..., 1], diff[..., 1],
                                     diff[..., 0] * diff[..., 0])
        h_child = _cost_to_go(child_pos, ref_points, v_ref, k, dt)

        # --- collision mask (eval_edge_exact capability) ------------------
        # feasible = valid & allowed & ~(obstacle hit | boundary hit); the
        # kernels build the candidates themselves and scan only the ones
        # still live
        live = valid[..., None] & allowed                     # [V, B, n]
        obs_k = type(obs_pre)(*(x[k] for x in obs_pre))
        obstacle_check = (outline_hits_lattice if non_convex
                          else sat_hits_lattice)
        feasible = obstacle_check(Lattice(mpa.area, trim, pose, c, s), live,
                                  obs_k)
        if segments_pre is not None:
            # boundary areas: without offset; larger offset at final step
            table = (mpa.area_large_offset if k == hp - 1
                     else mpa.area_no_offset)
            feasible = boundary_hits_lattice(
                Lattice(table, trim, pose, c, s), feasible, segments_pre)

        n_expanded = n_expanded + feasible.sum(dim=(1, 2))
        if b_out >= b_in * n:
            # exhaustive layer: every candidate survives, no pruning
            child_trim = torch.arange(n, device=dev).repeat(b_in)
            parent = torch.arange(b_in, device=dev).repeat_interleave(n)
            child_trim = child_trim.expand(v, -1)
            parent = parent.expand(v, -1)
            new_valid = feasible.reshape(v, -1)
            new_pose = torch.stack([child_x, child_y, child_yaw],
                                   dim=-1).reshape(v, -1, 3)
            new_g = g_child.reshape(v, -1)
        else:
            score = torch.where(feasible, g_child + h_child,
                                torch.full_like(g_child, math.inf))
            neg, flat_idx = stable_top_k(-score.reshape(v, -1), b_out)
            parent = flat_idx // n
            child_trim = flat_idx % n
            new_valid = neg > -math.inf
            payload = torch.stack([child_x, child_y, child_yaw, g_child],
                                  dim=-1).reshape(v, -1, 4)
            sel = payload.gather(1, flat_idx[..., None].expand(-1, -1, 4))
            new_pose = sel[..., :3]
            new_g = sel[..., 3]
        poses_l.append(new_pose)
        trims_l.append(child_trim)
        parents_l.append(parent)
        pose, trim, g, valid = new_pose, child_trim, new_g, new_valid
        b_in = b_out

    # --- leaf selection: min g among valid leaves (h = 0 at depth Hp) ----
    leaf_score = torch.where(valid, g, torch.full_like(g, math.inf))
    best_leaf = torch.argmin(leaf_score, dim=-1)              # first minimum
    is_exhausted = ~valid.any(dim=-1)
    cost = leaf_score[rows, best_leaf]

    # --- backtracking over per-layer parent pointers ---------------------
    idx = best_leaf
    trims_rev, poses_rev = [], []
    for k in range(hp - 1, -1, -1):
        trims_rev.append(trims_l[k][rows, idx])
        poses_rev.append(poses_l[k][rows, idx])
        idx = parents_l[k][rows, idx]
    trims_path = torch.stack(trims_rev[::-1], dim=1)          # [V, Hp]
    poses_path = torch.stack(poses_rev[::-1], dim=1)          # [V, Hp, 3]

    # --- occupied swept areas along the chosen path ----------------------
    parent_poses = torch.cat([x0[:, None], poses_path[:, :-1]], dim=1)
    parent_trims = torch.cat([trim0[:, None], trims_path[:, :-1]], dim=1)
    areas = mpa.area[parent_trims, trims_path]                # [V,Hp,VA,2]
    c = torch.cos(parent_poses[..., 2])[..., None]
    s = torch.sin(parent_poses[..., 2])[..., None]
    sx = fma(c, areas[..., 0], -(s * areas[..., 1])) + parent_poses[..., 0:1]
    sy = fma(s, areas[..., 0], c * areas[..., 1]) + parent_poses[..., 1:2]
    return PlanResult(
        trims=trims_path,
        poses=poses_path,
        shapes=torch.stack([sx, sy], dim=-1),
        cost=cost,
        is_exhausted=is_exhausted,
        n_expanded=n_expanded,
    )


def rollout_noise(seed: int, k: int, n_vehicles: int, hp: int,
                  n_rollouts: int, n_trims: int, device) -> torch.Tensor:
    """The sampled search's Gumbel noise [N, Hp, R, n] of every vehicle at
    step ``k``: vehicle i's key is ``fold_in(fold_in(PRNGKey(seed), k),
    i)`` (pdmpc_tpu/controller.py, after MonteCarloTreeSearch.m:31), split
    into one key a layer, each drawing ``gumbel(key, (R, n))``, as the
    reference's ``jax.random.categorical`` does inside its search. The key
    does not depend on the search, so one threefry pass on ``device``
    draws a step's noise for every vehicle and every solve of the step."""
    step_key = prng.fold_in(prng.prng_key(seed, device), k)
    keys = prng.fold_in(step_key[None],
                        torch.arange(n_vehicles, device=device))  # [N, 2]
    return prng.gumbel(prng.split(keys, hp), (n_rollouts, n_trims))


def policy_logits(fan_d2: torch.Tensor, allowed: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    """Logits of the rollout policy: ``-fan_d2 / temperature`` where the
    trim is allowed, -inf elsewhere (0 where allowed at temperature <= 0).
    XLA:CPU compiles the reference's division by the constant as a
    product with the f32 reciprocal f32(1) / f32(temperature), which is
    what is computed here (tests/test_torch_sampled.py holds it)."""
    if temperature > 0.0:
        one = torch.tensor(1.0, dtype=torch.float32)
        inv_t = float(one / torch.tensor(temperature, dtype=torch.float32))
        scores = -fan_d2 * inv_t
    else:
        scores = torch.zeros_like(fan_d2)
    return torch.where(allowed, scores, torch.full_like(scores, -math.inf))


def _placed(areas, pose, c, s):
    """Areas [V, R, VA, 2] placed at poses [V, R, 3] with yaw cosines and
    sines c, s [V, R, 1], in the kernels' vertex-major layout cx, cy
    [V, VA, R]; fused as the reference's XLA path is."""
    ax = fma(c, areas[..., 0], -(s * areas[..., 1])) + pose[..., 0:1]
    ay = fma(s, areas[..., 0], c * areas[..., 1]) + pose[..., 1:2]
    return ax.transpose(1, 2).contiguous(), ay.transpose(1, 2).contiguous()


def plan_trajectory_sampled(
    mpa: MpaTensors,
    x0: torch.Tensor,            # [V, 3]
    trim0: torch.Tensor,         # [V] i64
    ref_points: torch.Tensor,    # [V, Hp, 2]
    v_ref: torch.Tensor,         # [V, Hp]
    obstacles: Obstacles,
    dt: float,
    noise: torch.Tensor,         # [V, Hp, R, n] Gumbel noise
    boundary_segments: torch.Tensor | None = None,   # [V, S, 2, 2]
    boundary_mask: torch.Tensor | None = None,       # [V, S]
    segments_pre: SegmentsPre | None = None,         # precomputed bundle
    temperature: float = 0.002,
    non_convex: bool = False,
) -> PlanResult:
    """Sampled anytime search of V vehicles: R = ``noise.shape[2]``
    rollouts each, root to Hp. Reference: pdmpc_tpu/ops/search.py
    plan_trajectory_sampled (:658-816), the TPU re-design of
    MonteCarloTreeSearch.m.

    At each layer every rollout scores its whole successor fan (squared
    distance to the layer's reference point), draws a trim as
    ``argmax(noise + logits)`` (the first maximum; a rollout with no
    allowed trim draws 0 and dies), moves, adds the drawn trim's step cost
    and dies if the move's swept area hits an active obstacle (outline
    crossing with ``non_convex``, else SAT) or, where boundary segments
    are given, crosses the lanelet boundary (area without offset, the
    larger-offset area at the last layer). The cheapest rollout alive at
    Hp wins (the first on a tie); with none alive the plan is rollout 0's
    and exhausted, at cost inf. ``n_expanded`` counts alive rollouts over
    the layers. The collision checks are the kernels' (cx, cy) forms with
    the live mask ``alive & any allowed``, so a dead rollout is not
    scanned; their result is the reference's ``alive & any allowed &
    ~collide``. SAT runs on the VA-vertex areas: the reference pads them
    to VO by repeating the last vertex, which adds zero axes and repeated
    projections only and changes no result. ``v_ref`` and ``dt`` are
    unused, as in the reference.
    """
    del v_ref, dt
    n = mpa.n_trims
    hp = mpa.Hp
    v, _, r = noise.shape[:3]
    dev = x0.device
    rows = torch.arange(v, device=dev)

    precompute = precompute_outline if non_convex else precompute_obstacles
    obs_pre = precompute(obstacles.polys.permute(2, 0, 1, 3, 4),
                         obstacles.mask.permute(2, 0, 1))
    if segments_pre is None and boundary_segments is not None:
        segments_pre = precompute_segments(boundary_segments, boundary_mask)
    obstacle_check = outline_hits if non_convex else sat_hits

    pose = x0[:, None, :].expand(v, r, 3)
    trim = trim0[:, None].expand(v, r)
    g = torch.zeros((v, r), device=dev)
    alive = torch.ones((v, r), dtype=torch.bool, device=dev)
    n_expanded = torch.zeros((v,), dtype=torch.int64, device=dev)
    poses_l, trims_l = [], []
    for k in range(hp):
        allowed = mpa.transition[k][trim]                     # [V, R, n]
        c = torch.cos(pose[..., 2])[..., None]                # [V, R, 1]
        s = torch.sin(pose[..., 2])[..., None]
        mdx, mdy = mpa.dx[trim], mpa.dy[trim]
        fan_x = fma(c, mdx, -(s * mdy)) + pose[..., 0:1]      # [V, R, n]
        fan_y = fma(s, mdx, c * mdy) + pose[..., 1:2]
        # the step cost of every trim of the fan: XLA:CPU fuses the x
        # term here, fma(ex, ex, ey * ey), for the logits and for g alike
        # (the beam search's step cost fuses the y term)
        ex = fan_x - ref_points[:, k, None, None, 0]
        ey = fan_y - ref_points[:, k, None, None, 1]
        fan_d2 = fma(ex, ex, ey * ey)
        logits = policy_logits(fan_d2, allowed, temperature)
        child = torch.argmax(noise[:, k] + logits, dim=-1)    # [V, R]
        pick = child[..., None]
        child_x = fan_x.gather(2, pick)[..., 0]
        child_y = fan_y.gather(2, pick)[..., 0]
        child_yaw = pose[..., 2] + mpa.dyaw[trim, child]
        g = g + fan_d2.gather(2, pick)[..., 0]

        live = alive & allowed.any(dim=-1)
        obs_k = type(obs_pre)(*(x[k] for x in obs_pre))
        feasible = obstacle_check(*_placed(mpa.area[trim, child], pose, c,
                                           s), obs_k, live)
        if segments_pre is not None:
            table = (mpa.area_large_offset if k == hp - 1
                     else mpa.area_no_offset)
            feasible = boundary_hits(*_placed(table[trim, child], pose, c,
                                              s), segments_pre, feasible)
        alive = feasible
        n_expanded = n_expanded + alive.sum(dim=1)
        pose = torch.stack([child_x, child_y, child_yaw], dim=-1)
        trim = child
        poses_l.append(pose)
        trims_l.append(trim)

    leaf_score = torch.where(alive, g, torch.full_like(g, math.inf))
    best = torch.argmin(leaf_score, dim=-1)                   # first minimum
    is_exhausted = ~alive.any(dim=-1)
    cost = leaf_score[rows, best]
    trims_path = torch.stack([t[rows, best] for t in trims_l], dim=1)
    poses_path = torch.stack([p[rows, best] for p in poses_l], dim=1)

    parent_poses = torch.cat([x0[:, None], poses_path[:, :-1]], dim=1)
    parent_trims = torch.cat([trim0[:, None], trims_path[:, :-1]], dim=1)
    areas = mpa.area[parent_trims, trims_path]                # [V,Hp,VA,2]
    c = torch.cos(parent_poses[..., 2])[..., None]
    s = torch.sin(parent_poses[..., 2])[..., None]
    sx = fma(c, areas[..., 0], -(s * areas[..., 1])) + parent_poses[..., 0:1]
    sy = fma(s, areas[..., 0], c * areas[..., 1]) + parent_poses[..., 1:2]
    return PlanResult(
        trims=trims_path,
        poses=poses_path,
        shapes=torch.stack([sx, sy], dim=-1),
        cost=cost,
        is_exhausted=is_exhausted,
        n_expanded=n_expanded,
    )
