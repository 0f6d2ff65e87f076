"""Prioritized multi-vehicle control step — the HLC layer (main path).

Torch twin of pdmpc_tpu/controller.py's prioritized step
(``make_prioritized_step``): on one program with ``LocalComm`` and the
compact chunk loop, or vehicle-sharded over a process group with
``MeshComm`` and the dense level loop. One control period:

measure -> traffic info (reference trajectory, occupied areas, reachable
sets; on a road also predicted lanelets and boundary segments, and the
reachable sets bounded to the lane corridor) -> couple (none, full,
distance or reachable-set overlap) -> prioritize (constant, random,
coloring or FCA) -> solve: weigh (constant, random or distance) -> greedy
cut -> Kahn levels -> dataflow chunk schedule -> plan each chunk of
vehicles as one batched search (the beam search, or the sampled rollouts
of ``Config.optimizer_type`` TpuSampled) against the obstacle families
(outline crossing or SAT, as ``Config.use_non_convex_obstacles`` says) ->
exhaustion and fallback handling -> apply. The optimal and explorative
priority modes solve several directed couplings a step and vote per
coupling subgraph. Road (commonroad), free-space (circle) and mixed
scenarios run, with static obstacles where the scenario has them. The
random strategies and the rollout policy draw with ``pdmpc_torch.prng``,
bit-equal to the reference's ``jax.random``.

The step plans a batch of B scenarios at once (state and records with a
leading scenario dim, the reference's ``jax.vmap`` over scenarios): the
per-vehicle traffic info runs on the B*N vehicles flattened, the graph
stage on [B, N, N], and one merged chunk loop plans every scenario's
chunks, a planning row being a (scenario, vehicle) pair with its own
scenario's obstacles. Each scenario's records equal those of planning it
alone; a single run is a batch of one.

Human-driven vehicles (``Config.manual_control_config``) do not plan:
each drives its reference path, stays outside the coupling graph, and
the CAVs avoid its lane-bounded reachable sets unless it is behind them
(a fourth obstacle family). The voting modes run at any B: candidate p of
every scenario is one solve, one merged chunk loop, and each scenario
votes on its own. ``make_centralized_step`` plans the whole fleet as one
joint search over the trim product (``ops.search_centralized``), and
``make_run`` takes it when ``Config.is_prioritized`` is off.

Under a ``MeshComm`` (the parallel computation modes, ``parallel.
sharded``) each rank holds its own vehicles' state [B, n_local, ...]:
traffic info runs on them, one collective exchanges it, the graph stage
runs replicated on the gathered tensors, and the dense level loop plans,
level by level, the local vehicles at that level, every rank joining
each level's exchange of the planned areas. Its records equal the single
program's bit for bit.
"""

from __future__ import annotations

import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from pdmpc_torch.config import (
    Config,
    ConstraintFromSuccessor,
    CouplingStrategies,
    PriorityStrategies,
    WeightStrategies,
)
from pdmpc_torch.models.bicycle import VEHICLE_LENGTH, VEHICLE_WIDTH
from pdmpc_torch.models.mpa import MpaTensors
from pdmpc_torch.ops import geometry as geo
from pdmpc_torch.ops.collision import SegmentsPre, precompute_segments
from pdmpc_torch.ops.search import (
    Obstacles,
    PlanResult,
    _sat_separates_batch,
    pad_polys_to_vo,
    plan_trajectory,
    plan_trajectory_sampled,
    rollout_noise,
)
from pdmpc_torch.ops.search_centralized import plan_centralized
from pdmpc_torch.parallel import graph as graph_ops
from pdmpc_torch.parallel.comm import LocalComm
from pdmpc_torch.scenarios.scenario import (
    VO,
    ScenarioTensors,
    map_position_to_closest_lanelets,
)

# Reference: PrioritizedController.consider_successors (:536)
STANDSTILL_SPEED = 0.01
# Reference: ReachableSetCoupler.m:45
COUPLING_AREA_THRESHOLD = 1e-3
# Cap on predicted lanelets per vehicle per step (see pdmpc_tpu); the ids
# compacted have Hp+1 entries, so long horizons widen it.
N_PREDICTED_LANELETS = 8


# Vehicles a pass of the corridor clip: its largest temporary, the
# support projection of [vehicles, Hp, ~3,000 points, K] candidate
# vertices, takes some 1.2 MB a vehicle at cr20's shapes (22 GiB at 1,024
# scenarios of 20), so a batch is clipped 1,024 vehicles at a time.
CLIP_ROWS = 1024


def _n_predicted_lanelets(hp: int) -> int:
    return max(N_PREDICTED_LANELETS, hp + 1)


def _bounded_to_corridor(reachable_sets, rings, segs, seg_mask):
    """``geo.bound_convex_to_corridor`` of reachable sets [V, Hp, K, 2]
    against each vehicle's corridor (rings [V, L, R, 2], boundary segments
    [V, S, 2, 2], mask [V, S]), CLIP_ROWS vehicles a pass: the clip works
    vehicle by vehicle, so the passes give what one pass would."""
    parts = [geo.bound_convex_to_corridor(rs, r[:, None], s[:, None],
                                          m[:, None])
             for rs, r, s, m in zip(*(x.split(CLIP_ROWS) for x in (
                 reachable_sets, rings, segs, seg_mask)))]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


class StepState(NamedTuple):
    """Carry of the receding-horizon loop; ``prev_*`` hold the previous
    step's chosen plan (fallback, PrioritizedController.m:678-718). The
    shapes are one scenario's; the step takes and returns them with a
    leading scenario dim B ([B, N, 3], ...)."""

    pose: torch.Tensor         # [N, 3]
    trim: torch.Tensor         # [N] i64
    prev_poses: torch.Tensor   # [N, Hp, 3]
    prev_trims: torch.Tensor   # [N, Hp] i64
    prev_shapes: torch.Tensor  # [N, Hp, VO, 2]
    prev_valid: torch.Tensor   # [N] bool
    priorities_prev: torch.Tensor  # [N] i64


class StepInfo(NamedTuple):
    """Per-step record (the ControlResultsInfo / IterationData capability),
    one scenario's shapes; the step's carry a leading scenario dim B."""

    poses: torch.Tensor          # [N, Hp, 3]
    trims: torch.Tensor          # [N, Hp]
    shapes: torch.Tensor         # [N, Hp, VO, 2]
    cost: torch.Tensor           # [N]
    needs_fallback: torch.Tensor  # [N] bool
    is_exhausted: torch.Tensor   # [N] bool
    n_expanded: torch.Tensor     # [N]
    adjacency: torch.Tensor      # [N, N] bool
    directed_coupling: torch.Tensor    # [N, N] bool
    directed_sequential: torch.Tensor  # [N, N] bool
    levels: torch.Tensor         # [N]
    priorities: torch.Tensor     # [N]
    reference_points: torch.Tensor  # [N, Hp, 2]
    priority_permutation: torch.Tensor  # [N] chosen candidate row (0 = base)


def initial_state(scenario: ScenarioTensors, hp: int) -> StepState:
    n = scenario.n_vehicles
    dev = scenario.start_poses.device
    return StepState(
        pose=scenario.start_poses,
        trim=scenario.start_trims,
        prev_poses=torch.zeros((n, hp, 3), device=dev),
        prev_trims=torch.zeros((n, hp), dtype=torch.int64, device=dev),
        prev_shapes=torch.zeros((n, hp, VO, 2), device=dev),
        prev_valid=torch.zeros((n,), dtype=torch.bool, device=dev),
        priorities_prev=torch.arange(1, n + 1, device=dev),
    )


VOTING = (PriorityStrategies.optimal_priority,
          PriorityStrategies.explorative_priority)


# ---------------------------------------------------------------------------
# Traffic info (HighLevelController.update_controlled_vehicles_traffic_info)
# ---------------------------------------------------------------------------


def _reference_trajectory(mpa: MpaTensors, scenario: ScenarioTensors, pose,
                          trim, dt: float):
    """Hp reference points + v_ref of every vehicle (pdmpc_tpu's
    ``_reference_trajectory_single`` over all vehicles; reference:
    get_reference_trajectory.m + sample_reference_trajectory.m, as
    arc-length sampling). Returns (ref_points [N, Hp, 2], v_ref [N, Hp],
    seg_idx [N, Hp], proj_seg [N])."""
    n, hp = pose.shape[0], mpa.Hp
    v_ref = scenario.reference_speed[:, None].expand(n, hp)
    v_current = mpa.trim_speed[trim]
    v_intermediate = (
        torch.cat([v_current[:, None], v_ref[:, :-1]], dim=1) + v_ref
    ) / 2.0
    step_distances = v_intermediate * dt
    s0, _, proj_seg = geo.project_to_polyline(
        pose[:, :2], scenario.reference_paths, scenario.path_cumlen
    )
    arcs = s0[:, None] + torch.cumsum(step_distances, dim=1)
    ref_points, seg_idx = geo.sample_path_at_arclength(
        scenario.reference_paths, arcs, scenario.path_cumlen,
        scenario.is_loop,
    )
    return ref_points, v_ref, seg_idx, proj_seg


def _unique_padded(ids: torch.Tensor, size: int) -> torch.Tensor:
    """Row-wise ``jnp.unique(ids, size=size, fill_value=0)``: each row's
    sorted distinct values, padded with 0 (extra values beyond ``size``
    are dropped, largest first)."""
    srt = torch.sort(ids, dim=1).values
    is_new = torch.ones_like(srt, dtype=torch.bool)
    is_new[:, 1:] = srt[:, 1:] != srt[:, :-1]
    pos = torch.cumsum(is_new.to(torch.int64), dim=1) - 1
    dump = size                                   # column of dropped values
    pos = torch.where(is_new & (pos < size), pos, dump)
    out = torch.zeros((ids.shape[0], size + 1), dtype=ids.dtype,
                      device=ids.device)
    out.scatter_(1, pos, srt)
    return out[:, :size]


def _occupied_area(pose, offset: float):
    """Vehicle rectangles [..., 4, 2] at poses [..., 3]. Reference:
    get_occupied_areas.m."""
    return _rotated_rectangle(pose, torch.cos(pose[..., 2]),
                              torch.sin(pose[..., 2]), offset)


def _rotated_rectangle(pose, c, s, offset: float):
    """``_occupied_area`` with the heading's cosine ``c`` and sine ``s``
    given, the rotation fused as XLA:CPU compiles the reference's
    ``_occupied_area`` in the step and in the HDV apply alike
    (tests/test_torch_numerics.py): x = fma(c, lx, -(s * ly)) + px,
    y = fma(s, lx, c * ly) + py."""
    hx = (VEHICLE_LENGTH + 2 * offset) / 2.0
    hy = (VEHICLE_WIDTH + 2 * offset) / 2.0
    local = torch.tensor([[-hx, -hy], [hx, -hy], [hx, hy], [-hx, hy]],
                         dtype=torch.float32, device=pose.device)
    lx, ly = local[:, 0], local[:, 1]
    c, s = c[..., None], s[..., None]
    return torch.stack([geo.fma(c, lx, -(s * ly)) + pose[..., 0:1],
                        geo.fma(s, lx, c * ly) + pose[..., 1:2]], dim=-1)


def _reachable_sets_at_pose(local_sets, pose, trim):
    """Offline local reachable sets ``local_sets`` [n, Hp, K, 2] (the
    MPA's, or the HDVs' non-recursive ones) moved to the vehicle poses:
    [N, Hp, K, 2]. Reference: MotionPrimitiveAutomaton.
    reachable_sets_at_pose (:649-687)."""
    local = local_sets[trim]                                 # [N, Hp, K, 2]
    return geo.transform_polygon(local, pose[:, 0, None], pose[:, 1, None],
                                 pose[:, 2, None])


# ---------------------------------------------------------------------------
# Graph stage
# ---------------------------------------------------------------------------


def _couple(cfg: Config, reachable_sets, poses, max_mpa_speed,
            pred_lanelets=None, adjacency_lanelets=None):
    """Adjacency [..., N, N] bool from the configured coupling strategy
    (leading dims: scenarios; vehicles pair only within their own).

    ``pred_lanelets`` [..., N, Lp] (1-based ids, 0 = none) and
    ``adjacency_lanelets`` [L+1, L+1] enable DistanceCoupler.m:28-31's
    lanelet-adjacency prefilter on road scenarios.
    """
    *lead, n = reachable_sets.shape[:-3]
    dev = reachable_sets.device
    if cfg.coupling == CouplingStrategies.no_coupling:
        return torch.zeros((*lead, n, n), dtype=torch.bool, device=dev)
    if cfg.coupling == CouplingStrategies.full_coupling:
        return ~torch.eye(n, dtype=torch.bool, device=dev).expand(*lead, n, n)
    if cfg.coupling == CouplingStrategies.distance_coupling:
        # DistanceCoupler.m: coupled iff distance <= 2 * v_max * dt * Hp
        d = graph_ops.pairwise_distances(poses[..., :2])
        max_distance = 2.0 * max_mpa_speed * cfg.dt_seconds * cfg.Hp
        coupled = (d <= max_distance) & ~torch.eye(n, dtype=torch.bool,
                                                    device=dev)
        if pred_lanelets is not None and adjacency_lanelets is not None:
            # is_any_lanelet_adjacent (DistanceCoupler.m:56-63): some pair
            # of (current + predicted) lanelets is adjacent; row and column
            # 0 of the matrix are all False, so padded id 0 is inert
            pair_adj = adjacency_lanelets[
                pred_lanelets[..., :, None, :, None],
                pred_lanelets[..., None, :, None, :]]
            coupled &= pair_adj.any(dim=-1).any(dim=-1)
        return coupled
    # reachable_set_coupling: overlap area of the last-step reachable sets
    # above the threshold (ReachableSetCoupler.m:39-48); each unordered
    # pair of a scenario is computed once and mirrored, so the adjacency
    # is symmetric
    last = reachable_sets[..., -1, :, :]                     # [..., N, K, 2]
    iu, ju = torch.triu_indices(n, n, 1, device=dev)
    pair_area = geo.convex_intersection_area_clip(last[..., iu, :, :],
                                                  last[..., ju, :, :])
    adj = torch.zeros((*lead, n, n), dtype=torch.bool, device=dev)
    adj[..., iu, ju] = pair_area > COUPLING_AREA_THRESHOLD
    return adj | adj.mT


def _calculate_yaw(points):
    """Yaw along point sequences [..., Hp, 2] -> [..., Hp]: forward
    difference at the first point, backward at the last, central between
    (utility/calculate_yaw.m)."""
    nxt = torch.roll(points, -1, dims=-2)
    prv = torch.roll(points, 1, dims=-2)
    d = nxt - prv
    d[..., -1, :] = (points - prv)[..., -1, :]
    d[..., 0, :] = (nxt - points)[..., 0, :]
    return torch.atan2(d[..., 1], d[..., 0])


def _fca_priorities(cfg: Config, adjacency, ref_points):
    """Future-Collision-Assessment priorities (FcaPrioritizer.m:24-93):
    vehicle rectangles (with offset) along each reference, yawed along it;
    a coupled pair's collisions are counted step by step with SAT; more
    collisions plan earlier, ties by index. Leading dims: scenarios."""
    yaws = _calculate_yaw(ref_points)                        # [..., N, Hp]
    shapes = geo.transformed_rectangle(
        ref_points[..., 0], ref_points[..., 1], yaws,
        VEHICLE_LENGTH + 2 * cfg.offset, VEHICLE_WIDTH + 2 * cfg.offset,
    )                                                    # [..., N, Hp, 4, 2]
    # SAT in the XLA form, as the reference's Precision.HIGHEST projection
    # matmul compiles on XLA:CPU; touching counts as a collision
    hits = ~_sat_separates_batch(shapes[..., :, None, :, :, :],
                                 shapes[..., None, :, :, :, :])  # [..,N,N,Hp]
    counts = torch.where(adjacency, hits.sum(dim=-1), 0)
    order = torch.sort(-counts.sum(dim=-1), dim=-1, stable=True).indices
    return graph_ops.ranks_of(order)


def _prioritize(cfg: Config, adjacency, ref_points, k: int):
    """Priorities [..., N] and the directed coupling they induce
    (Prioritizer.m) at step ``k`` (leading dims: scenarios; one random
    draw a step serves them all); optimal and explorative modes start
    from constant priorities (Prioritizer.m:26-29)."""
    n = adjacency.shape[-1]
    lead = adjacency.shape[:-1]
    if cfg.priority == PriorityStrategies.random_priority:
        priorities = graph_ops.random_priorities(
            n, k, cfg.seed, adjacency.device).expand(lead)
    elif cfg.priority == PriorityStrategies.FCA_priority:
        priorities = _fca_priorities(cfg, adjacency, ref_points)
    elif cfg.priority == PriorityStrategies.coloring_priority:
        priorities = graph_ops.coloring_priorities(adjacency)
    elif cfg.priority in (PriorityStrategies.constant_priority, *VOTING):
        priorities = graph_ops.constant_priorities(
            n, adjacency.device).expand(lead)
    else:
        raise NotImplementedError(f"priority strategy {cfg.priority.value}")
    directed = graph_ops.directed_coupling_from_priorities(adjacency,
                                                           priorities)
    return priorities, directed


def _weigh(cfg: Config, directed, poses, k: int, max_mpa_speed):
    """Constant (ConstantWeigher.m), random (RandomWeigher.m, seeded by
    step ``k``) or distance (DistanceWeigher.m) weights of the directed
    coupling [..., N, N]."""
    if cfg.weight == WeightStrategies.constant_weight:
        return graph_ops.constant_weights(directed)
    if cfg.weight == WeightStrategies.random_weight:
        return graph_ops.random_weights(directed, k, cfg.seed)
    if cfg.weight == WeightStrategies.distance_weight:
        return graph_ops.distance_weights(directed, poses[..., :2],
                                          max_mpa_speed, cfg.dt_seconds,
                                          cfg.Hp)
    raise NotImplementedError(f"weight strategy {cfg.weight.value}")


# ---------------------------------------------------------------------------
# Multi-permutation solvers (optimal / explorative priority modes)
# ---------------------------------------------------------------------------

# Cost charged per exhausted vehicle when voting between candidates
# (pdmpc_tpu controller._EXHAUSTED_PENALTY).
_EXHAUSTED_PENALTY = 1e9


def _solve_optimal(cfg: Config, comm, solve, adjacency):
    """optimal_priority (PrioritizedOptimalController.m +
    Prioritizer.unique_priorities) of every scenario of a batch
    (adjacency [B, N, N]): every unordered coupled pair gets a bit equal
    to its edge rank within its weakly-connected component, and candidate
    row p of the [P, B, N, N] stack orients each edge by that bit of p,
    P = 2^e_cap for every scenario. A component with up to e_cap edges has
    all its orientations in the stack; cyclic ones are masked out of its
    vote (row 0, all forward, is always acyclic). Each component then
    adopts its cost-minimal row (pdmpc_tpu controller._solve_optimal)."""
    n = adjacency.shape[-1]
    dev = adjacency.device
    e_cap = max(1, int(cfg.max_priority_permutations).bit_length() - 1)
    e_cap = max(1, min(e_cap, n * (n - 1) // 2))
    p_cnt = 1 << e_cap
    labels = torch.arange(n, device=dev)

    belonging = graph_ops.weak_components(adjacency)        # [B, N]
    iu, ju = torch.triu_indices(n, n, 1, device=dev)         # pair slots
    edge_present = adjacency[:, iu, ju]                      # [B, S]
    edge_comp = belonging[:, iu]
    s = iu.shape[0]
    # rank of each present edge within its component (earlier slots first)
    same_comp = edge_comp[:, None, :] == edge_comp[:, :, None]
    before = torch.ones((s, s), dtype=torch.bool, device=dev).tril(-1)
    rank = (same_comp & before & edge_present[:, None, :]).sum(dim=-1)
    bit = rank % e_cap
    p_idx = torch.arange(p_cnt, device=dev)[:, None, None]
    # bit clear = forward (i < j): row 0 is the all-forward orientation,
    # the reference's first enumerated candidate
    forward = ((p_idx >> bit[None]) & 1) == 0               # [P, B, S]
    directed_stack = torch.zeros((p_cnt, *adjacency.shape), dtype=torch.bool,
                                 device=dev)
    directed_stack[..., iu, ju] = forward & edge_present[None]
    directed_stack[..., ju, iu] = ~forward & edge_present[None]

    # a component is invalid in row p iff its orientation leaves a cycle
    # (Kahn keeps cycle members at level 0)
    stuck = graph_ops.kahn_levels(directed_stack)[0] == 0    # [P, B, N]
    onehot_b = belonging[..., None] == labels                # [B, N, labels]
    invalid_pc = (stuck[..., None] & onehot_b[None]).any(dim=-2)

    # a component with more than e_cap edges shares bit positions and is
    # explored only in part (the reference enumerates all 2^edges)
    edges_per_comp = (edge_present[..., None]
                      & (edge_comp[..., None] == labels)).sum(dim=-2)
    max_edges = int(edges_per_comp.max()) if s else 0
    if max_edges > e_cap:
        warnings.warn(
            f"optimal_priority: a coupling subgraph has {max_edges} edges "
            f"> e_cap={e_cap}; orientation enumeration is partial (raise "
            f"max_priority_permutations)", stacklevel=2)
    return _vote_per_subgraph(comm, solve, directed_stack, belonging,
                              invalid_pc)


# The vote's summation order, mapped against XLA:CPU by shape (candidate
# rows P, vehicles N; tests/test_torch_strategies.py sweeps them): the
# vehicle counts N that sum in four or in two lanes at P >= 64 (P = 128
# and 256 add N = 5 to the four). Optimal voting's P is a power of two,
# explorative's at most N.
_LANES4_P64 = frozenset([4, *range(6, 17), 19, 20, 23, 24, *range(33, 49)])
_LANES2_P64 = frozenset([17, 18, 21, 22, *range(25, 33)])


def vote_order_mapped(p_cnt: int, n: int) -> bool:
    """Whether the summation order of a vote over ``p_cnt`` candidates of
    ``n`` vehicles was mapped: N up to 64, P up to 64 and P in {128,
    256}."""
    return n <= 64 and (p_cnt <= 64 or p_cnt in (128, 256))


def _vote_lanes(p_cnt: int, n: int) -> int:
    """Lanes in which XLA:CPU sums the vote's one-hot contraction at this
    shape: 4, 2 or 1 (one vehicle after another)."""
    if p_cnt >= 64:
        if n in _LANES4_P64 or (p_cnt >= 128 and n == 5):
            return 4
        return 2 if n in _LANES2_P64 else 1
    if p_cnt >= 2 and (n in (8, 11, 12, 14, 15, 16)
                       or (p_cnt >= 8 and n in (4, 6, 7))):
        return 4
    return 1


def _subgraph_totals(cost_g, belonging):
    """Vote totals [..., P, N-labels]: each candidate row's costs
    ``cost_g`` [..., N, P] summed over the members of each subgraph label
    (``belonging`` [..., N]), rounded to 8 decimals
    (PrioritizedOptimalController.m:104); leading dims batch scenarios,
    each summed as alone.

    The reference contracts with a one-hot matmul on XLA:CPU, and which
    order that sums the vehicles in depends on the shape
    (``_vote_lanes``): below P = 64, P >= 2 and N in {8, 11, 12, 14, 15,
    16} (and N in {4, 6, 7} once P >= 8) take four lanes; at P >= 64 most
    N up to 48 take four lanes or two. With k lanes, lane j sums vehicles
    j, j + k, ... of the first k*(N//k), the lanes are added pairwise
    ((l0 + l1) + (l2 + l3)), and then the rest, summed in order, is
    added; every other shape sums the vehicles one after another. The
    orders are spelled out here so the totals equal the reference's bit
    for bit (tests/test_torch_strategies.py holds them); non-members add
    exact zeros in place. Under the reference's ``jax.vmap`` over
    scenarios the batched contraction sums each scenario in the same
    order as alone (tests/test_torch_voting_batch.py). The rounding is
    ``jnp.round``'s as XLA compiles it: round half to even of x * 1e8,
    times the f32 constant 1e-8 (XLA turns the division by 1e8 into that
    product).
    """
    n, p_cnt = cost_g.shape[-2:]
    onehot = (belonging[..., None] == torch.arange(n, device=cost_g.device)
              ).to(cost_g.dtype)                         # [..., N, labels]
    terms = cost_g.mT[..., None] * onehot[..., None, :, :]  # [.., P, N, L]
    k = _vote_lanes(p_cnt, n)
    full = k * (n // k) if k > 1 else 0
    total = None
    if full:
        lane = [terms[..., j, :] for j in range(k)]
        for i in range(k, full):
            lane[i % k] = lane[i % k] + terms[..., i, :]
        while len(lane) > 1:
            lane = [lane[j] + lane[j + 1] for j in range(0, len(lane), 2)]
        total = lane[0]
    rest = None
    for i in range(full, n):
        rest = terms[..., i, :] if rest is None else rest + terms[..., i, :]
    if total is None:
        total = rest
    elif rest is not None:
        total = total + rest
    return torch.round(total * 1e8) * 1e-8


def _vote_per_subgraph(comm, solve, directed_stack, belonging, invalid_pc,
                       taking_part=None):
    """Solve every candidate directed coupling of every scenario and
    adopt, per weakly-connected subgraph of each scenario, the
    cost-minimal candidate: the shared voting tail of the optimal and
    explorative modes (the SolutionCost exchange and
    PrioritizedExplorativeController.choose_solution:146-176; pdmpc_tpu
    controller._vote_per_subgraph, under ``jax.vmap`` for a batch).

    ``directed_stack`` [P, B, N, N]: candidate row p of every scenario,
    solved by one ``solve(directed [B, N, N], scenarios)`` call, one
    merged chunk loop. ``invalid_pc`` [P, B, N-labels]: candidate p may
    not win that label's subgraph. ``taking_part`` (default: all) lists
    per row p the scenarios whose candidate p is solved; a row left out
    of a scenario must be invalid for each of its labels, and never wins
    (rows no scenario takes are not solved at all).
    Returns (planned, planned_shapes, sequential, levels, priorities,
    directed, chosen row), each with the leading scenario dim."""
    p_cnt, bsz, n = directed_stack.shape[:3]
    if not vote_order_mapped(p_cnt, n):
        warnings.warn(
            f"vote totals over P={p_cnt} candidates of N={n} vehicles: "
            f"XLA:CPU's summation order is mapped for N <= 64 and P <= 64 "
            f"or P in (128, 256) only, so a total may part an ulp from the "
            f"reference's", stacklevel=3)
    dev = directed_stack.device
    rows = torch.arange(n, device=dev)
    scen = torch.arange(bsz, device=dev)[:, None]
    if taking_part is None:
        taking_part = [list(range(bsz))] * p_cnt
    solved = {p: solve(directed_stack[p], part)
              for p, part in enumerate(taking_part) if part}
    first = solved[min(solved)]
    stacked = [solved.get(p, first) for p in range(p_cnt)]
    planned_s = PlanResult(*(torch.stack(f) for f in
                             zip(*(s[0] for s in stacked))))  # [P, B, ...]
    shapes_s = torch.stack([s[1] for s in stacked])
    seq_s = torch.stack([s[2] for s in stacked])

    # exhausted plans carry cost = inf: clamp to the finite penalty before
    # the vote (inf * 0 in the sum would poison every other subgraph)
    cost_l = torch.where(planned_s.is_exhausted,
                         torch.full_like(planned_s.cost, _EXHAUSTED_PENALTY),
                         planned_s.cost)                     # [P, B, N]
    totals = _subgraph_totals(comm.gather_veh(cost_l.permute(1, 2, 0)),
                              belonging)                     # [B, P, L]
    totals = torch.where(invalid_pc.transpose(0, 1),
                         torch.full_like(totals, torch.inf), totals)
    # first minimum per label, as jnp.argmin
    best = totals.amin(dim=-2, keepdim=True)
    p_idx = torch.arange(p_cnt, device=dev)[:, None]
    chosen_per_label = torch.where(totals == best, p_idx,
                                   p_cnt).amin(dim=-2)       # [B, L]
    chosen_g = chosen_per_label.gather(-1, belonging)        # [B, N]
    chosen_l = comm.local_slice(chosen_g)

    local_rows = torch.arange(comm.n_local, device=dev)
    planned = PlanResult(*(x[chosen_l, scen, local_rows]
                           for x in planned_s))
    shapes_g = shapes_s[chosen_g, scen, rows]
    sequential = seq_s[chosen_g, scen, rows]
    directed_comb = directed_stack[chosen_g, scen, rows]
    levels, _ = graph_ops.kahn_levels(sequential)
    # winning priorities kept for the next step: vehicles ranked by
    # (subgraph label, level within it, index) (choose_solution, :165-172)
    key = belonging * (n * n) + levels * n + rows
    priorities = graph_ops.ranks_of(torch.argsort(key, dim=-1))
    return (planned, shapes_g, sequential, levels, priorities,
            directed_comb, chosen_l)


def _solve_explorative(cfg: Config, comm, solve, directed, sequential0,
                       levels0, max_num_cls: int):
    """explorative_priority (arXiv:2501.10781,
    PrioritizedExplorativeController.m) of every scenario of a batch
    (directed, sequential0 [B, N, N], levels0 [B, N]): one prioritization
    per computation level, from cyclic shifts of the levels (a Latin
    square, :241-309); coupling edges whose shifted levels invert are
    swapped (:311-319), and each weakly-connected subgraph of the cut
    sequential graph adopts its cost-minimal shift (:146-176).

    The reference solves all ``max_num_cls`` rows and masks the shifts
    beyond a scenario's level count out of its vote; those can never
    win, so a scenario takes part only in its own valid shifts,
    min(levels, max_num_cls) of them: rows 0 to the batch's largest count
    are solved, each in one merged chunk loop of the scenarios it has."""
    dev = directed.device
    l_max = max(max_num_cls, 1)
    n_levels = torch.clamp_min(levels0.amax(dim=-1), 1)      # [B]
    belonging = graph_ops.weak_components(sequential0)      # [B, N]
    coupled = directed | directed.mT
    p = torch.arange(l_max, device=dev)
    lv = ((levels0[None] - 1 + p[:, None, None])
          % n_levels[None, :, None]) + 1                     # [P, B, N]
    lower = lv[..., :, None] < lv[..., None, :]
    equal = lv[..., :, None] == lv[..., None, :]
    directed_stack = (coupled & lower) | (directed & equal)  # [P, B, N, N]
    invalid_pc = (p[:, None] >= n_levels)[..., None].expand(
        l_max, *levels0.shape)
    counts = n_levels.tolist()
    taking_part = [[b for b, c in enumerate(counts) if row < c]
                   for row in range(l_max)]
    return _vote_per_subgraph(comm, solve, directed_stack, belonging,
                              invalid_pc, taking_part)


def compact_schedule(levels: torch.Tensor, c_chunk: int,
                     sequential: torch.Tensor):
    """Dataflow list schedule: rows of up to ``c_chunk`` vehicle indices
    (-1 padding). Each vehicle, visited in (level, index) order, lands in
    the earliest chunk after all its sequential predecessors' chunks that
    has a free slot, so planning the rows in order respects the DAG and
    plans every vehicle once (pdmpc_tpu controller.compact_schedule with
    ``sequential``). Runs on the host: levels [N] and sequential [N, N].
    Returns (schedule [N, c_chunk] i64, n_chunks int).
    """
    schedule, n_chunks = _compact_rows(levels.tolist(), sequential.tolist(),
                                       c_chunk)
    return torch.tensor(schedule, dtype=torch.int64), n_chunks


def _compact_rows(lv: list, seq: list, c_chunk: int):
    """``compact_schedule`` of levels ``lv`` [N] and sequential ``seq``
    [N][N] given as lists: (schedule rows, n_chunks)."""
    n = len(lv)
    order = sorted(range(n), key=lambda i: (lv[i], i))
    chunk_of = [-1] * n
    slots_used = [0] * n
    schedule = [[-1] * c_chunk for _ in range(n)]
    for v in order:
        # sequential predecessors have strictly lower levels, hence are
        # already placed when v is visited
        earliest = max([chunk_of[u] + 1 for u in range(n) if seq[u][v]],
                       default=0)
        t = next(t for t in range(earliest, n) if slots_used[t] < c_chunk)
        chunk_of[v] = t
        schedule[t][slots_used[t]] = v
        slots_used[t] += 1
    return schedule, max(chunk_of) + 1


def merged_schedule(levels: torch.Tensor, c_chunk: int,
                    sequential: torch.Tensor,
                    scenarios: list[int] | None = None
                    ) -> list[torch.Tensor]:
    """The merged chunk loop of a batch of scenarios: each scenario's own
    ``compact_schedule`` (levels [B, N] and sequential [B, N, N], on the
    host), merged chunk t holding, scenario by scenario, the vehicles of
    each scenario's chunk t. A scenario past its last chunk adds none and
    padded slots (-1) are dropped, so the loop runs max_b n_chunks(b)
    times and plans every vehicle of every scenario once, after its own
    scenario's sequential predecessors. Only the ``scenarios`` listed
    (default: all) take part; the others add no rows. Returns the merged
    chunks as [3, V] i64 host tensors: each planning row's scenario b,
    vehicle v and flattened row b * N + v."""
    n = levels.shape[-1]
    lv_all, seq_all = levels.tolist(), sequential.tolist()
    if scenarios is None:
        scenarios = range(len(lv_all))
    own = [(b, *_compact_rows(lv_all[b], seq_all[b], c_chunk))
           for b in scenarios]
    chunks = []
    for t in range(max(count for _, _, count in own)):
        rows = [(b, v) for b, schedule, count in own
                if t < count for v in schedule[t] if v >= 0]
        chunks.append(torch.tensor([[b for b, _ in rows],
                                    [v for _, v in rows],
                                    [b * n + v for b, v in rows]],
                                   dtype=torch.int64))
    return chunks


# ---------------------------------------------------------------------------
# The prioritized step
# ---------------------------------------------------------------------------


def _del_first_rpt_last(arr: torch.Tensor, dim: int) -> torch.Tensor:
    """Shift along ``dim`` dropping the first entry and repeating the last
    (utility/del_first_rpt_last.m)."""
    n = arr.shape[dim]
    return torch.cat([arr.narrow(dim, 1, n - 1), arr.narrow(dim, n - 1, 1)],
                     dim=dim)


# the per-vehicle tensors of a scenario, which the traffic info reads
_PER_VEHICLE = ("reference_paths", "path_cumlen", "is_loop",
                "reference_speed", "segment_lanelet", "is_hdv")


def _tile_scenario(scenario: ScenarioTensors, b: int,
                   vehicles: torch.Tensor | None = None) -> ScenarioTensors:
    """``scenario`` with the per-vehicle tensors of ``vehicles`` (global
    indices; default: all) repeated for ``b`` scenarios: row b * n + i
    holds vehicle ``vehicles[i]``'s."""
    return scenario._replace(**{
        name: (x if vehicles is None else x[vehicles]).repeat(
            b, *(1,) * (x.dim() - 1))
        for name in _PER_VEHICLE
        if (x := getattr(scenario, name)) is not None})


def dense_level_rows(levels: torch.Tensor, first: int, n_local: int,
                     scenarios: list[int] | None = None
                     ) -> list[torch.Tensor]:
    """The dense level loop of a vehicle shard: for each computation level
    1 to the largest of ``levels`` (global, [B, N], on the host), the
    rows of the shard's vehicles ``first`` to ``first + n_local - 1`` at
    that level, of the ``scenarios`` listed (default: all), as [4, V] i64
    host tensors: scenario b, local vehicle v, local flattened row
    b * n_local + v and global vehicle first + v (V may be 0: the shard
    plans nothing at that level but joins its exchange)."""
    lv = levels[:, first:first + n_local]
    if scenarios is not None:
        taking = torch.zeros(lv.shape[0], dtype=torch.bool)
        taking[scenarios] = True
        lv = torch.where(taking[:, None], lv, 0)
    out = []
    for level in range(1, int(levels.max()) + 1):
        b, v = torch.nonzero(lv == level, as_tuple=True)
        out.append(torch.stack([b, v, b * n_local + v, first + v]))
    return out


def _hdv_trim(mpa: MpaTensors, reference_speed):
    """Each vehicle's HDV trim [N]: the straight trim (no steering) whose
    speed is closest to its reference speed, the first on a tie
    (pdmpc_tpu controller, HDV apply)."""
    speed_dist = torch.where(
        (torch.abs(mpa.trim_steering) < 1e-9)[None, :],
        torch.abs(mpa.trim_speed[None, :] - reference_speed[:, None]),
        torch.inf)
    return torch.argmin(speed_dist, dim=-1)


def _hdv_behind(road, current_lanelet, pose):
    """[B, N CAV, N HDV] bool: HDV j is behind CAV i (is_hdv_behind.m;
    update_hdv_traffic_info, HighLevelController.m:428-443): j's current
    lanelet precedes i's, or they share or overlap it and j's heading
    points away from i. An HDV behind would contain the CAV in its
    reachable sets and make the search infeasible, so a CAV avoids only
    HDVs not behind it. ``current_lanelet`` [B, N], ``pose`` [B, N, 3]."""
    cl_i, cl_j = current_lanelet[..., :, None], current_lanelet[..., None, :]
    pred_m = road.hdv_predecessor[cl_i, cl_j]
    over_m = road.hdv_overlap[cl_i, cl_j]
    same = cl_i == cl_j
    vec = pose[..., None, :, :2] - pose[..., :, None, :2]   # [B, N, N, 2]
    hx = torch.cos(pose[..., 2])[..., None, :]               # [B, 1, N]
    hy = torch.sin(pose[..., 2])[..., None, :]
    # the reference's d = 2 sum of products, as XLA:CPU fuses it
    # (tests/test_torch_numerics.py)
    scal = geo.fma(hy, vec[..., 1], hx * vec[..., 0])
    return pred_m | ((same | over_m) & (scal < 0.0))


def vehicles_at_intersection(time_step, times, positions,
                             intersection_center, threshold):
    """Which vehicles are inside the intersection, and since which step.

    Vehicles within ``threshold`` of ``intersection_center`` are at the
    intersection; ``times`` [N] holds each one's entry step (inf when
    outside). positions [N, 2]. Returns (at [N] bool, times [N]).
    Reference: hlc/controller/common/vehicles_at_intersection.m
    (pdmpc_tpu controller.vehicles_at_intersection)."""
    center = torch.as_tensor(intersection_center, dtype=positions.dtype,
                             device=positions.device)
    d = positions - center
    at = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) < threshold
    entering = at & ~torch.isfinite(times)
    times = torch.where(entering, torch.as_tensor(
        time_step, dtype=times.dtype, device=times.device), times)
    times = torch.where(at, times, torch.inf)
    return at, times


def make_prioritized_step(cfg: Config, mpa: MpaTensors,
                          scenario: ScenarioTensors, comm=None):
    """Build ``step(state, k) -> (state, info)`` for the prioritized
    path over a batch of scenarios: ``state`` carries a leading scenario
    dim B (``parallel.sharded.batched_initial_state``) and so does
    ``info``. Each of the B scenarios runs ``scenario`` from its own
    state, as the reference's ``jax.vmap`` of its step; B is read from
    the state.

    ``comm`` selects the communication backend (``parallel.comm``): the
    default ``LocalComm`` runs all vehicles in one program
    (PrioritizedSequentialController semantics) with the compact chunk
    loop; a ``MeshComm`` runs this rank's vehicles, the state [B,
    n_local, ...], with the dense level loop. Per-vehicle records are
    then the local vehicles' and the graph's records (adjacency, directed
    couplings, levels, priorities) every vehicle's."""
    n = scenario.n_vehicles
    hp = mpa.Hp
    dt = cfg.dt_seconds
    dev = scenario.start_poses.device
    max_mpa_speed = torch.amax(mpa.trim_speed)
    max_num_cls = min(cfg.max_num_CLs, n)
    # planning chunk width; results are identical at any value
    c_chunk = min(n, cfg.level_chunk or 2)
    comm = LocalComm(n) if comm is None else comm
    nl = comm.n_local
    # the global index of each local vehicle, under a MeshComm only: the
    # single program takes every per-vehicle tensor whole
    gidx = (None if isinstance(comm, LocalComm)
            else comm.global_indices(dev))
    first = 0 if gidx is None else int(gidx[0])

    def own(x):
        """The local vehicles' entries of a per-vehicle tensor [N, ...]."""
        return x if gidx is None else x[gidx]

    not_self = ~torch.eye(n, dtype=torch.bool, device=dev)
    road = scenario.road
    # obstacle-geometry dispatch (OptimizerInterface.m:36-46): outline
    # crossing for road scenarios, SAT for the circle (or as overridden)
    non_convex = cfg.use_non_convex_obstacles
    sampled = not cfg.optimizer_type.is_optimal
    use_reachability = cfg.isDealPredictionInconsistency
    successor_mode = cfg.constraint_from_successor
    # static scenario obstacles join every vehicle's obstacle set at every
    # step (get_all_obstacles.m:17)
    static = scenario.static_obstacles
    if static is not None:
        static_polys = static[:, None].expand(-1, hp, VO, 2)
        static_mask = scenario.static_obstacle_mask[None].expand(n, -1)
    # human-driven vehicles (HighLevelController.m:394-447): statically
    # gated, so a run without them launches what it did before HDVs ran
    use_hdv = cfg.manual_control_config.is_active
    if use_hdv:
        is_hdv = scenario.is_hdv                         # [N]
        # a CAV avoids an HDV's reachable sets (the HDV family)
        cav_avoids_hdv = is_hdv[None, :] & ~is_hdv[:, None] & not_self
        is_hdv_l = own(is_hdv)
        hdv_trim_l = own(_hdv_trim(mpa, scenario.reference_speed))
    tiles = {}                    # B -> the local vehicles B times

    def step(state: StepState, k: int):
        bsz = state.pose.shape[0]
        if bsz not in tiles:
            tiles[bsz] = _tile_scenario(scenario, bsz, gidx)
        sc_rows = tiles[bsz]
        rows = bsz * nl
        pose_r = state.pose.reshape(rows, 3)
        trim_r = state.trim.reshape(rows)

        # ---- local traffic info, on the B*nl vehicles flattened ---------
        ref_points, v_ref, seg_idx, proj_seg = _reference_trajectory(
            mpa, sc_rows, pose_r, trim_r, dt
        )
        reachable_sets = _reachable_sets_at_pose(
            mpa.local_reachable_sets, pose_r, trim_r)       # [B*N, Hp, K, 2]
        seg_pre = pred_lanelets = current_lanelet = None
        if road is not None:
            # predicted lanelets -> boundary segments and corridor rings
            # (get_predicted_lanelets.m + get_lanelets_boundary.m)
            lane_of = sc_rows.segment_lanelet                # [B*N, P-1]
            current_lanelet = lane_of.gather(1, proj_seg[:, None])
            if use_hdv:
                # an HDV's pose is measured, not planned, and may stray
                # from its path: its current lanelet is the one with the
                # closest centerline (HighLevelController.m:402,
                # map_position_to_closest_lanelets.m)
                closest, _ = map_position_to_closest_lanelets(
                    road, pose_r[:, :2])
                current_lanelet = torch.where(sc_rows.is_hdv[:, None],
                                              closest[:, None],
                                              current_lanelet)
            ids = torch.cat([current_lanelet, lane_of.gather(1, seg_idx)],
                            dim=1)                           # [B*N, Hp+1]
            pred_lanelets = _unique_padded(ids, _n_predicted_lanelets(hp))
            bnd_segs = road.boundary_segments[pred_lanelets].reshape(
                rows, -1, 2, 2)
            bnd_mask = road.boundary_seg_mask[pred_lanelets].reshape(rows, -1)
            corridor_rings = road.corridor_rings[pred_lanelets]  # [.,L,R,2]
            # segment geometry is layer- and chunk-invariant: one bundle
            # per step, its rows flattened as the planning rows index them
            seg_pre = precompute_segments(bnd_segs, bnd_mask)
            # reachable sets bounded by the drivable corridor before they
            # feed coupling and avoidance (bound_reachable_sets.m:1-50)
            reachable_sets = _bounded_to_corridor(
                reachable_sets, corridor_rings, bnd_segs, bnd_mask)
        if use_hdv:
            # the HDVs' non-recursive reachable sets, clipped to their own
            # corridors on a road (ManualVehicle.compute_reachable_lane,
            # ManualVehicle.m:30-49)
            hdv_rs = _reachable_sets_at_pose(mpa.local_reachable_sets_hdv,
                                             pose_r, trim_r)
            if road is not None:
                hdv_rs = _bounded_to_corridor(hdv_rs, corridor_rings,
                                              bnd_segs, bnd_mask)

        occupied_offset = _occupied_area(pose_r, cfg.offset)
        occupied_no_offset = _occupied_area(pose_r, 0.0)

        def per_scenario(x):
            """[B*nl, ...] -> [B, nl, ...]."""
            return None if x is None else x.reshape(bsz, nl, *x.shape[1:])

        (ref_points, v_ref, reachable_sets, pred_lanelets, occupied_offset,
         occupied_no_offset) = map(per_scenario, (
             ref_points, v_ref, reachable_sets, pred_lanelets,
             occupied_offset, occupied_no_offset))

        # ---- traffic exchange, coupling graph and priorities -------------
        # every per-vehicle field rides one collective, as the reference's
        # single Traffic message (InterHlcCommunication.m:140)
        (pose_g, trim_g, rs_g, ref_points_g, occupied_offset_g,
         prev_shapes_g, prev_valid_g, pred_lanelets_g, hdv_rs_g,
         current_lanelet_g) = comm.gather_tree((
             state.pose, state.trim, reachable_sets, ref_points,
             occupied_offset, state.prev_shapes, state.prev_valid,
             pred_lanelets,
             pad_polys_to_vo(per_scenario(hdv_rs)) if use_hdv else None,
             (per_scenario(current_lanelet)[..., 0]
              if use_hdv and road is not None else None)))
        adjacency = _couple(
            cfg, rs_g, pose_g, max_mpa_speed, pred_lanelets=pred_lanelets_g,
            adjacency_lanelets=(road.adjacency_lanelets
                                if road is not None else None),
        )                                                    # [B, N, N]
        if use_hdv:
            # HDVs stay outside the coupling graph; a CAV avoids an HDV's
            # reachable sets unless the HDV is behind it
            adjacency = adjacency & ~is_hdv[:, None] & ~is_hdv[None, :]
            hdv_family = cav_avoids_hdv
            if road is not None:
                hdv_family = hdv_family & ~_hdv_behind(
                    road, current_lanelet_g, pose_g)
        if sampled:
            # the rollouts' Gumbel noise depends on (seed, step, vehicle)
            # only: one draw a step serves every solve and every scenario
            # of the step
            noise = rollout_noise(cfg.seed, k, n, hp, cfg.mcts_n_rollouts,
                                  mpa.n_trims, dev)
        if cfg.priority == PriorityStrategies.explorative_priority:
            # explorative mode keeps the previous step's winning
            # prioritization (PrioritizedExplorativeController.m:146-176)
            priorities = comm.gather_veh(state.priorities_prev)
            directed = graph_ops.directed_coupling_from_priorities(
                adjacency, priorities)
        else:
            priorities, directed = _prioritize(cfg, adjacency, ref_points_g,
                                               k)

        # ---- obstacle families (per scenario, shared by its vehicles) ----
        # 0: this step's already-planned predicted areas; 1: parallel-
        # coupling avoidance by reachable sets or, without
        # isDealPredictionInconsistency, the previous plans shifted by a
        # step; 2: the successor constraint (standstill areas or previous
        # plans; none: no family); then the HDVs' reachable sets, then the
        # static obstacles, in the reference's order, which fixes the
        # obstacle slots and so the scan order. Masks are [B, N planning,
        # N obstacle] per family; a family the configuration never uses is
        # not in the tensors at all.
        if (not use_reachability or successor_mode
                == ConstraintFromSuccessor.area_of_previous_trajectory):
            prev_shifted = _del_first_rpt_last(prev_shapes_g, 2)
        parallel_polys = (pad_polys_to_vo(rs_g) if use_reachability
                          else prev_shifted)          # [B, N, Hp, VO, 2]

        def solve(directed_p, scenarios=None):
            """One prioritized solve of every scenario for its directed
            coupling [B, N, N]: weigh -> cut -> levels -> obstacle
            families -> merged compact chunk loop (``LocalComm``) or dense
            level loop (``MeshComm``), in which only the ``scenarios``
            listed (default: all) plan (the others' plans stay zero).
            Returns (planned, planned_shapes [B, N, Hp, VO, 2],
            sequential, levels); ``planned`` holds the local vehicles'
            plans, ``planned.shapes`` their padded areas."""
            weighted = _weigh(cfg, directed_p, pose_g, k, max_mpa_speed)
            sequential = graph_ops.greedy_cut(weighted, max_num_cls, n)
            levels, _ = graph_ops.kahn_levels(sequential)
            seq_t = sequential.mT
            seq_pred = seq_t & not_self
            par_pred = directed_p.mT & ~seq_t & not_self
            if not use_reachability:
                par_pred = par_pred & prev_valid_g[:, None, :]
            masks, polys = [seq_pred, par_pred], [parallel_polys]
            if successor_mode == ConstraintFromSuccessor.area_of_standstill:
                masks.append(directed_p & not_self & (
                    mpa.trim_speed[trim_g] < STANDSTILL_SPEED)[:, None, :])
                polys.append(pad_polys_to_vo(occupied_offset_g)[:, :, None]
                             .expand(bsz, n, hp, VO, 2))
            elif (successor_mode
                  == ConstraintFromSuccessor.area_of_previous_trajectory):
                masks.append(directed_p & prev_valid_g[:, None, :]
                             & not_self)
                polys.append(prev_shifted)
            if use_hdv:
                masks.append(hdv_family.expand(bsz, n, n))
                polys.append(hdv_rs_g)
            if static is not None:
                masks.append(static_mask.expand(bsz, n, -1))
                polys.append(static_polys.expand(bsz, *static_polys.shape))
            obs_mask = comm.local_slice(torch.cat(masks, dim=-1))
            n_obs = obs_mask.shape[-1]                  # [B, nl, n_obs]

            # the plans; their swept areas padded to VO vertices, as the
            # obstacle family they become
            planned = PlanResult(
                trims=torch.zeros((bsz, nl, hp), dtype=torch.int64,
                                  device=dev),
                poses=torch.zeros((bsz, nl, hp, 3), device=dev),
                shapes=torch.zeros((bsz, nl, hp, VO, 2), device=dev),
                cost=torch.zeros((bsz, nl), device=dev),
                is_exhausted=torch.zeros((bsz, nl), dtype=torch.bool,
                                         device=dev),
                n_expanded=torch.zeros((bsz, nl), dtype=torch.int64,
                                       device=dev),
            )

            def plan_rows(bi, vi, ri, gi, planned_shapes):
                """Plan the planning rows (scenario ``bi``, local vehicle
                ``vi``, local flattened row ``ri``, global vehicle
                ``gi``) in one search call against the planned areas
                ``planned_shapes`` [B, N, Hp, VO, 2], and write their
                plans into ``planned``."""
                nv = bi.shape[0]
                # each row's obstacles are its own scenario's families
                obs_polys = torch.cat([planned_shapes, *polys], dim=1)[bi]
                obstacles = Obstacles(
                    polys=obs_polys,
                    mask=obs_mask[bi, vi][:, :, None].expand(nv, n_obs, hp),
                )
                args = (mpa, state.pose[bi, vi], state.trim[bi, vi],
                        ref_points[bi, vi], v_ref[bi, vi], obstacles, dt)
                kw = dict(segments_pre=(None if seg_pre is None else
                                        SegmentsPre(*(x[ri]
                                                      for x in seg_pre))),
                          non_convex=non_convex)
                if sampled:
                    result = plan_trajectory_sampled(
                        *args, noise[gi], temperature=cfg.mcts_temperature,
                        **kw)
                else:
                    result = plan_trajectory(*args, cfg.beam_width, **kw)
                result = result._replace(
                    shapes=pad_polys_to_vo(result.shapes))
                for field, value in zip(planned, result):
                    field[bi, vi] = value

            if gidx is None:
                # ---- merged compact chunk loop: every vehicle planned
                # once; the schedule needs levels on the host: one sync a
                # solve for the whole batch
                for chunk in merged_schedule(levels.cpu(), c_chunk,
                                             sequential.cpu(), scenarios):
                    # a planning row is a (scenario, vehicle) pair; padded
                    # slots are not planned at all: no kernel work
                    bi, vi, ri = chunk.to(dev)           # one copy a chunk
                    plan_rows(bi, vi, ri, vi, planned.shapes)
                return planned, planned.shapes, sequential, levels

            # ---- dense level loop (pdmpc_tpu controller.py:1072-1130):
            # level by level, the local vehicles at that level are planned
            # in one call, and every rank joins the level's exchange of
            # the planned areas (PrioritizedController.plan's blocking
            # reads), whether or not it planned a vehicle at that level;
            # the level count comes from the replicated levels, so it is
            # the same on every rank
            planned_shapes = torch.zeros((bsz, n, hp, VO, 2), device=dev)
            for level in dense_level_rows(levels.cpu(), first, nl,
                                          scenarios):
                if level.shape[1]:
                    plan_rows(*level.to(dev), planned_shapes)
                planned_shapes = comm.gather_veh(planned.shapes)
            return planned, planned_shapes, sequential, levels

        if cfg.priority == PriorityStrategies.optimal_priority:
            (planned, planned_shapes, sequential, levels, priorities,
             directed, perm_chosen) = _solve_optimal(cfg, comm, solve,
                                                     adjacency)
        elif cfg.priority == PriorityStrategies.explorative_priority:
            weighted0 = _weigh(cfg, directed, pose_g, k, max_mpa_speed)
            sequential0 = graph_ops.greedy_cut(weighted0, max_num_cls, n)
            levels0, _ = graph_ops.kahn_levels(sequential0)
            (planned, planned_shapes, sequential, levels, priorities,
             directed, perm_chosen) = _solve_explorative(
                 cfg, comm, solve, directed, sequential0, levels0,
                 max_num_cls)
        else:
            planned, planned_shapes, sequential, levels = solve(directed)
            perm_chosen = torch.zeros((bsz, nl), dtype=torch.int64,
                                      device=dev)
        is_exhausted = planned.is_exhausted

        # ---- exhaustion handling (PrioritizedController.m:568-621) -------
        # a standstill vehicle whose search exhausts stays put, unless no
        # successor constraint holds its standstill area free
        if successor_mode == ConstraintFromSuccessor.none:
            stay_still_ok = torch.zeros_like(is_exhausted)
        else:
            stay_still_ok = is_exhausted & (mpa.trim_speed[state.trim] == 0.0)
        ss_poses = state.pose[:, :, None, :].expand(bsz, nl, hp, 3)
        ss_trims = state.trim[:, :, None].expand(bsz, nl, hp)
        ss_shapes = pad_polys_to_vo(occupied_no_offset)[:, :, None].expand(
            bsz, nl, hp, VO, 2)
        ss_cost = _tracking_cost(ss_poses, ref_points)

        # fallback propagation over the coupling graph, on every
        # vehicle's flags (the Predictions' needs_fallback field); an HDV
        # never falls back
        needs_fallback = is_exhausted & ~stay_still_ok
        if use_hdv:
            needs_fallback = needs_fallback & ~is_hdv_l
        fallbacks = comm.local_slice(graph_ops.fallback_closure(
            comm.gather_veh(needs_fallback), adjacency, sequential))

        # fallback plan: previous plan shifted by one, last repeated
        # (plan_fallback, :678-718); without a previous plan: stand still
        use_prev = state.prev_valid
        fb_poses = torch.where(use_prev[..., None, None],
                               _del_first_rpt_last(state.prev_poses, 2),
                               ss_poses)
        fb_trims = torch.where(use_prev[..., None],
                               _del_first_rpt_last(state.prev_trims, 2),
                               ss_trims)
        fb_shapes = torch.where(use_prev[..., None, None, None],
                                _del_first_rpt_last(state.prev_shapes, 2),
                                ss_shapes)
        fb_cost = torch.where(
            use_prev,
            _tracking_cost(_del_first_rpt_last(state.prev_poses, 2),
                           ref_points),
            ss_cost,
        )

        use_ss = stay_still_ok & ~fallbacks

        def choose(planned_v, ss_v, fb_v):
            shape = (bsz, nl) + (1,) * (planned_v.dim() - 2)
            return torch.where(
                fallbacks.reshape(shape), fb_v,
                torch.where(use_ss.reshape(shape), ss_v, planned_v),
            )

        final_poses = choose(planned.poses, ss_poses, fb_poses)
        final_trims = choose(planned.trims, ss_trims, fb_trims)
        final_shapes = choose(comm.local_slice(planned_shapes), ss_shapes,
                              fb_shapes)
        final_cost = choose(planned.cost, ss_cost, fb_cost)
        if use_hdv:
            # HDVs drive their reference path (the lab's human input; in
            # simulation the path stands in, ManualVehicle.m)
            hdv_poses = torch.cat([ref_points,
                                   _calculate_yaw(ref_points)[..., None]],
                                  dim=-1)                    # [B, N, Hp, 3]
            hdv_shapes = pad_polys_to_vo(_occupied_area(hdv_poses,
                                                        cfg.offset))
            final_poses = torch.where(is_hdv_l[:, None, None], hdv_poses,
                                      final_poses)
            final_trims = torch.where(is_hdv_l[:, None], hdv_trim_l[:, None],
                                      final_trims)
            final_shapes = torch.where(is_hdv_l[:, None, None, None],
                                       hdv_shapes, final_shapes)
            fallbacks = fallbacks & ~is_hdv_l

        # ---- apply (Simulation.apply, plant/Simulation.m:86-117) ----------
        new_state = StepState(
            pose=final_poses[:, :, 0],
            trim=final_trims[:, :, 0],
            prev_poses=final_poses,
            prev_trims=final_trims,
            prev_shapes=final_shapes,
            prev_valid=torch.ones((bsz, nl), dtype=torch.bool, device=dev),
            priorities_prev=comm.local_slice(priorities),
        )
        info = StepInfo(
            poses=final_poses,
            trims=final_trims,
            shapes=final_shapes,
            cost=final_cost,
            needs_fallback=fallbacks,
            is_exhausted=is_exhausted,
            n_expanded=planned.n_expanded,
            adjacency=adjacency,
            directed_coupling=directed,
            directed_sequential=sequential,
            levels=levels,
            priorities=priorities,
            reference_points=ref_points,
            priority_permutation=perm_chosen,
        )
        return new_state, info

    return step


def _tracking_cost(poses, ref_points):
    """Sum over Hp of the squared distance to the reference: [..., N]."""
    d = poses[..., :2] - ref_points
    return torch.sum(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1], dim=-1)


def make_centralized_step(cfg: Config, mpa: MpaTensors,
                          scenario: ScenarioTensors):
    """Build ``step(state, k) -> (state, info)`` for centralized control
    (CentralizedController.m; pdmpc_tpu controller.make_centralized_step):
    one joint search over all vehicles' trims a scenario, with no coupling
    graph and no fallback. The reference errors out on an infeasible
    joint search (:61-70); here the fleet holds its poses and the step is
    flagged exhausted. ``state`` and ``info`` carry a leading scenario dim
    B, and each scenario is planned on its own, as under the reference's
    ``jax.vmap``."""
    n = scenario.n_vehicles
    hp = mpa.Hp
    dt = cfg.dt_seconds
    dev = scenario.start_poses.device
    road = scenario.road
    obstacles = None
    if scenario.static_obstacles is not None:
        n_static = scenario.static_obstacles.shape[0]
        obstacles = Obstacles(
            polys=scenario.static_obstacles[:, None].expand(n_static, hp,
                                                            VO, 2),
            mask=scenario.static_obstacle_mask[:, None].expand(n_static, hp))
    tiles = {}
    eye = torch.eye(n, dtype=torch.bool, device=dev)

    def step(state: StepState, k: int):
        del k
        bsz = state.pose.shape[0]
        if bsz not in tiles:
            tiles[bsz] = _tile_scenario(scenario, bsz)
        sc_rows = tiles[bsz]
        rows = bsz * n
        ref_points, v_ref, seg_idx, proj_seg = _reference_trajectory(
            mpa, sc_rows, state.pose.reshape(rows, 3),
            state.trim.reshape(rows), dt)
        ref_points = ref_points.reshape(bsz, n, hp, 2)
        v_ref = v_ref.reshape(bsz, n, hp)
        # the joint search checks the prioritized one's constraints,
        # lanelet boundaries included (are_constraints_satisfied_sat.m)
        bnd_segs = bnd_mask = None
        if road is not None:
            lane_of = sc_rows.segment_lanelet
            ids = torch.cat([lane_of.gather(1, proj_seg[:, None]),
                             lane_of.gather(1, seg_idx)], dim=1)
            pred_lanelets = _unique_padded(ids, _n_predicted_lanelets(hp))
            bnd_segs = road.boundary_segments[pred_lanelets].reshape(
                bsz, n, -1, 2, 2)
            bnd_mask = road.boundary_seg_mask[pred_lanelets].reshape(
                bsz, n, -1)

        res = [plan_centralized(
            mpa, state.pose[b], state.trim[b], ref_points[b], v_ref[b], dt,
            cfg.beam_width, obstacles=obstacles,
            boundary_segments=None if bnd_segs is None else bnd_segs[b],
            boundary_mask=None if bnd_mask is None else bnd_mask[b])
            for b in range(bsz)]
        poses = torch.stack([r.poses.transpose(0, 1) for r in res])
        trims = torch.stack([r.trims.transpose(0, 1) for r in res])
        shapes = pad_polys_to_vo(torch.stack([r.shapes.transpose(0, 1)
                                              for r in res]))
        exhausted = torch.stack([r.is_exhausted for r in res])  # [B]
        keep = exhausted[:, None]
        new_state = StepState(
            pose=torch.where(keep[..., None], state.pose, poses[:, :, 0]),
            trim=torch.where(keep, state.trim, trims[:, :, 0]),
            prev_poses=poses,
            prev_trims=trims,
            prev_shapes=shapes,
            prev_valid=torch.ones((bsz, n), dtype=torch.bool, device=dev),
            priorities_prev=state.priorities_prev,
        )
        per_vehicle = (bsz, n)
        no_edges = torch.zeros((bsz, n, n), dtype=torch.bool, device=dev)
        info = StepInfo(
            poses=poses,
            trims=trims,
            shapes=shapes,
            cost=torch.stack([r.cost / n for r in res])[:, None].expand(
                per_vehicle),
            needs_fallback=keep.expand(per_vehicle),
            is_exhausted=keep.expand(per_vehicle),
            n_expanded=torch.stack([r.n_expanded for r in res])[
                :, None].expand(per_vehicle),
            adjacency=(~eye).expand(bsz, n, n),
            directed_coupling=no_edges,
            directed_sequential=no_edges,
            levels=torch.ones(per_vehicle, dtype=torch.int64, device=dev),
            priorities=torch.arange(1, n + 1, device=dev).expand(
                per_vehicle),
            reference_points=ref_points,
            priority_permutation=torch.zeros(per_vehicle, dtype=torch.int64,
                                             device=dev),
        )
        return new_state, info

    return step


def make_run(cfg: Config, comm=None, n_steps: int | None = None):
    """Receding-horizon experiment (HighLevelController.m:334-373) of a
    batch of scenarios, prioritized or, where ``Config.is_prioritized`` is
    off, centralized: ``run(states0, mpa, scenario, step_seconds=None)
    -> (final_states, infos)``, the states with a leading scenario dim B
    and the infos [B, k_end, ...] (``n_steps`` steps where given), as the
    reference's ``jax.vmap`` of its run returns them. When a list is
    given as ``step_seconds``, each batched step's wall-clock time (device
    work included) is appended to it. A ``comm`` (``parallel.comm``)
    makes the prioritized step run its vehicles, as
    ``make_prioritized_step`` says."""
    if comm is not None and not cfg.is_prioritized:
        raise ValueError("centralized planning plans the whole fleet as one "
                         "search; it runs on one program")
    steps = cfg.k_end if n_steps is None else n_steps

    def run(state: StepState, mpa: MpaTensors, scenario: ScenarioTensors,
            step_seconds: list | None = None):
        step = (make_prioritized_step(cfg, mpa, scenario, comm)
                if cfg.is_prioritized
                else make_centralized_step(cfg, mpa, scenario))
        sync = (torch.cuda.synchronize
                if state.pose.device.type == "cuda" else (lambda: None))
        infos = []
        for k in range(steps):
            t0 = time.perf_counter()
            state, info = step(state, k)
            sync()
            if step_seconds is not None:
                step_seconds.append(time.perf_counter() - t0)
            infos.append(info)
        stacked = StepInfo(*(torch.stack(f, dim=1) for f in zip(*infos)))
        return state, stacked

    return run


def infos_to_numpy(infos: StepInfo) -> StepInfo:
    return StepInfo(*(np.asarray(x.cpu()) for x in infos))
