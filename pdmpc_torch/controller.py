"""Prioritized multi-vehicle control step — the HLC layer (main path).

Torch twin of pdmpc_tpu/controller.py's single-program prioritized step
(``make_prioritized_step`` with ``LocalComm`` and the compact chunk loop).
One control period:

measure -> traffic info (reference trajectory, occupied areas, reachable
sets; on a road also predicted lanelets and boundary segments, and the
reachable sets bounded to the lane corridor) -> couple (reachable-set
overlap) -> prioritize (constant) -> weigh (distance) -> greedy cut ->
Kahn levels -> dataflow chunk schedule -> plan each chunk of vehicles as
one batched beam search against the obstacle families (outline crossing
or SAT, as ``Config.use_non_convex_obstacles`` says) -> exhaustion and
fallback handling -> apply. Road (commonroad) and free-space (circle)
scenarios both run.

Configurations outside this path (other coupling, priority or weight
strategies, HDVs, static obstacles, sampled or centralized search, the
dense level loop) are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from pdmpc_torch.config import (
    ComputationMode,
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
from pdmpc_torch.ops.search import Obstacles, pad_polys_to_vo, plan_trajectory
from pdmpc_torch.parallel import graph as graph_ops
from pdmpc_torch.parallel.comm import LocalComm
from pdmpc_torch.scenarios.scenario import VO, ScenarioTensors

# Reference: PrioritizedController.consider_successors (:536)
STANDSTILL_SPEED = 0.01
# Reference: ReachableSetCoupler.m:45
COUPLING_AREA_THRESHOLD = 1e-3
# Cap on predicted lanelets per vehicle per step (see pdmpc_tpu); the ids
# compacted have Hp+1 entries, so long horizons widen it.
N_PREDICTED_LANELETS = 8


def _n_predicted_lanelets(hp: int) -> int:
    return max(N_PREDICTED_LANELETS, hp + 1)


class StepState(NamedTuple):
    """Carry of the receding-horizon loop (one scenario); ``prev_*`` hold
    the previous step's chosen plan (fallback, PrioritizedController.m:
    678-718)."""

    pose: torch.Tensor         # [N, 3]
    trim: torch.Tensor         # [N] i64
    prev_poses: torch.Tensor   # [N, Hp, 3]
    prev_trims: torch.Tensor   # [N, Hp] i64
    prev_shapes: torch.Tensor  # [N, Hp, VO, 2]
    prev_valid: torch.Tensor   # [N] bool
    priorities_prev: torch.Tensor  # [N] i64


class StepInfo(NamedTuple):
    """Per-step record (the ControlResultsInfo / IterationData capability)."""

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
    priority_permutation: torch.Tensor  # [N] (always 0 on this path)


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


def check_main_path(cfg: Config, scenario: ScenarioTensors) -> None:
    """Raise NotImplementedError for anything outside the ported path."""
    wanted = [
        (scenario.static_obstacles is None, "no static obstacles"),
        (cfg.is_prioritized, "prioritized planning"),
        (cfg.computation_mode == ComputationMode.sequential,
         "computation_mode=sequential"),
        (cfg.coupling == CouplingStrategies.reachable_set_coupling,
         "reachable_set_coupling"),
        (cfg.priority == PriorityStrategies.constant_priority,
         "constant_priority"),
        (cfg.weight == WeightStrategies.distance_weight, "distance_weight"),
        (cfg.optimizer_type.is_optimal, "the optimal (beam) optimizer"),
        (cfg.isDealPredictionInconsistency, "reachable-set avoidance"),
        (cfg.constraint_from_successor
         == ConstraintFromSuccessor.area_of_standstill,
         "constraint_from_successor=area_of_standstill"),
        (not cfg.manual_control_config.is_active, "no human-driven vehicles"),
    ]
    missing = [what for ok, what in wanted if not ok]
    if missing:
        raise NotImplementedError(
            "pdmpc_torch ports only the main path so far; this run needs "
            + ", ".join(missing)
        )


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
    """Vehicle rectangles [N, 4, 2] at poses [N, 3]. Reference:
    get_occupied_areas.m."""
    return geo.transformed_rectangle(
        pose[:, 0], pose[:, 1], pose[:, 2],
        VEHICLE_LENGTH + 2 * offset, VEHICLE_WIDTH + 2 * offset,
    )


def _reachable_sets_at_pose(mpa: MpaTensors, pose, trim):
    """Offline local reachable sets moved to the vehicle poses: [N, Hp, K, 2].
    Reference: MotionPrimitiveAutomaton.reachable_sets_at_pose (:649-687)."""
    local = mpa.local_reachable_sets[trim]                   # [N, Hp, K, 2]
    return geo.transform_polygon(local, pose[:, 0, None], pose[:, 1, None],
                                 pose[:, 2, None])


# ---------------------------------------------------------------------------
# Graph stage
# ---------------------------------------------------------------------------


def _couple(reachable_sets):
    """Adjacency [N, N] bool: overlap area of the last-step reachable sets
    above COUPLING_AREA_THRESHOLD (ReachableSetCoupler.m:39-48). Each
    unordered pair is computed once and mirrored, so the adjacency is
    exactly symmetric."""
    n = reachable_sets.shape[0]
    last = reachable_sets[:, -1]                             # [N, K, 2]
    iu, ju = torch.triu_indices(n, n, 1, device=last.device)
    pair_area = geo.convex_intersection_area_clip(last[iu], last[ju])
    adj = torch.zeros((n, n), dtype=torch.bool, device=last.device)
    adj[iu, ju] = pair_area > COUPLING_AREA_THRESHOLD
    return adj | adj.T


def _prioritize(adjacency):
    """Constant priorities (ConstantPrioritizer.m) and the directed
    coupling they induce."""
    priorities = graph_ops.constant_priorities(adjacency.shape[0],
                                               adjacency.device)
    directed = graph_ops.directed_coupling_from_priorities(adjacency,
                                                           priorities)
    return priorities, directed


def _weigh(cfg: Config, directed, poses, max_mpa_speed):
    """Distance weights (DistanceWeigher.m)."""
    return graph_ops.distance_weights(directed, poses[:, :2], max_mpa_speed,
                                      cfg.dt_seconds, cfg.Hp)


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
    n = levels.shape[0]
    lv = levels.tolist()
    seq = sequential.tolist()
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
    return torch.tensor(schedule, dtype=torch.int64), max(chunk_of) + 1


# ---------------------------------------------------------------------------
# The prioritized step
# ---------------------------------------------------------------------------


def _del_first_rpt_last(arr: torch.Tensor, dim: int) -> torch.Tensor:
    """Shift along ``dim`` dropping the first entry and repeating the last
    (utility/del_first_rpt_last.m)."""
    n = arr.shape[dim]
    return torch.cat([arr.narrow(dim, 1, n - 1), arr.narrow(dim, n - 1, 1)],
                     dim=dim)


def make_prioritized_step(cfg: Config, mpa: MpaTensors,
                          scenario: ScenarioTensors):
    """Build ``step(state, k) -> (state, info)`` for the prioritized
    single-program path (PrioritizedSequentialController semantics)."""
    check_main_path(cfg, scenario)
    n = scenario.n_vehicles
    hp = mpa.Hp
    dt = cfg.dt_seconds
    dev = scenario.start_poses.device
    max_mpa_speed = torch.amax(mpa.trim_speed)
    max_num_cls = min(cfg.max_num_CLs, n)
    # planning chunk width; results are identical at any value
    c_chunk = min(n, cfg.level_chunk or 2)
    comm = LocalComm(n)
    not_self = ~torch.eye(n, dtype=torch.bool, device=dev)
    road = scenario.road
    # obstacle-geometry dispatch (OptimizerInterface.m:36-46): outline
    # crossing for road scenarios, SAT for the circle (or as overridden)
    non_convex = cfg.use_non_convex_obstacles

    def step(state: StepState, k: int):
        # ---- local traffic info ------------------------------------------
        ref_points, v_ref, seg_idx, proj_seg = _reference_trajectory(
            mpa, scenario, state.pose, state.trim, dt
        )
        reachable_sets = _reachable_sets_at_pose(mpa, state.pose,
                                                 state.trim)  # [N, Hp, K, 2]
        seg_pre = None
        if road is not None:
            # predicted lanelets -> boundary segments and corridor rings
            # (get_predicted_lanelets.m + get_lanelets_boundary.m)
            lane_of = scenario.segment_lanelet               # [N, P-1]
            ids = torch.cat([lane_of.gather(1, proj_seg[:, None]),
                             lane_of.gather(1, seg_idx)], dim=1)  # [N, Hp+1]
            uids = _unique_padded(ids, _n_predicted_lanelets(hp))
            bnd_segs = road.boundary_segments[uids].reshape(n, -1, 2, 2)
            bnd_mask = road.boundary_seg_mask[uids].reshape(n, -1)
            corridor_rings = road.corridor_rings[uids]       # [N, L, R, 2]
            # segment geometry is layer- and chunk-invariant: one bundle
            # per step
            seg_pre = precompute_segments(bnd_segs, bnd_mask)
            # reachable sets bounded by the drivable corridor before they
            # feed coupling and avoidance (bound_reachable_sets.m:1-50)
            reachable_sets = geo.bound_convex_to_corridor(
                reachable_sets, corridor_rings[:, None], bnd_segs[:, None],
                bnd_mask[:, None],
            )

        occupied_offset = _occupied_area(state.pose, cfg.offset)
        occupied_no_offset = _occupied_area(state.pose, 0.0)

        # ---- coupling graph, priorities, weights, cut, levels ------------
        pose_g, trim_g, rs_g, occupied_offset_g = comm.gather_tree(
            (state.pose, state.trim, reachable_sets, occupied_offset)
        )
        adjacency = _couple(rs_g)
        priorities, directed = _prioritize(adjacency)
        weighted = _weigh(cfg, directed, pose_g, max_mpa_speed)
        sequential = graph_ops.greedy_cut(weighted, max_num_cls, n)
        levels, _ = graph_ops.kahn_levels(sequential)

        # ---- obstacle families (global, shared across vehicles) ----------
        # 0: this step's already-planned predicted areas; 1: parallel-
        # coupling avoidance by reachable sets; 2: successors' standstill
        # areas. Masks [N planning, N obstacle] per family.
        rs_padded = pad_polys_to_vo(rs_g)                    # [N, Hp, VO, 2]
        standstill = pad_polys_to_vo(occupied_offset_g)[:, None].expand(
            n, hp, VO, 2)
        seq_pred = sequential.T & not_self
        par_pred = directed.T & ~sequential.T & not_self
        standstill_mask = (directed
                           & (mpa.trim_speed[trim_g] < STANDSTILL_SPEED)[None]
                           & not_self)
        obs_mask = torch.cat([seq_pred, par_pred, standstill_mask], dim=1)
        n_obs = obs_mask.shape[1]

        # ---- compact chunk loop: every vehicle planned exactly once ------
        # the schedule needs levels on the host: the step's one sync
        schedule, n_chunks = compact_schedule(levels.cpu(), c_chunk,
                                              sequential.cpu())
        trims = torch.zeros((n, hp), dtype=torch.int64, device=dev)
        poses = torch.zeros((n, hp, 3), device=dev)
        cost = torch.zeros((n,), device=dev)
        is_exhausted = torch.zeros((n,), dtype=torch.bool, device=dev)
        n_expanded = torch.zeros((n,), dtype=torch.int64, device=dev)
        planned_shapes = torch.zeros((n, hp, VO, 2), device=dev)
        for row in schedule[:n_chunks].tolist():
            # padded slots (-1) are not planned at all: no kernel work
            idx = torch.tensor([i for i in row if i >= 0], device=dev)
            nv = idx.shape[0]
            obs_polys = torch.cat([planned_shapes, rs_padded, standstill])
            obstacles = Obstacles(
                polys=obs_polys.expand(nv, *obs_polys.shape),
                mask=obs_mask[idx][:, :, None].expand(nv, n_obs, hp),
            )
            result = plan_trajectory(
                mpa, state.pose[idx], state.trim[idx], ref_points[idx],
                v_ref[idx], obstacles, dt, cfg.beam_width,
                segments_pre=(None if seg_pre is None else
                              SegmentsPre(*(x[idx] for x in seg_pre))),
                non_convex=non_convex,
            )
            trims[idx] = result.trims
            poses[idx] = result.poses
            cost[idx] = result.cost
            is_exhausted[idx] = result.is_exhausted
            n_expanded[idx] = result.n_expanded
            planned_shapes[idx] = pad_polys_to_vo(result.shapes)

        # ---- exhaustion handling (PrioritizedController.m:568-621) -------
        # a standstill vehicle whose search exhausts stays put
        stay_still_ok = is_exhausted & (mpa.trim_speed[state.trim] == 0.0)
        ss_poses = state.pose[:, None, :].expand(n, hp, 3)
        ss_trims = state.trim[:, None].expand(n, hp)
        ss_shapes = pad_polys_to_vo(occupied_no_offset)[:, None].expand(
            n, hp, VO, 2)
        ss_cost = _tracking_cost(ss_poses, ref_points)

        # fallback propagation over the coupling graph
        fallbacks = graph_ops.fallback_closure(
            is_exhausted & ~stay_still_ok, adjacency, sequential
        )

        # fallback plan: previous plan shifted by one, last repeated
        # (plan_fallback, :678-718); without a previous plan: stand still
        use_prev = state.prev_valid
        fb_poses = torch.where(use_prev[:, None, None],
                               _del_first_rpt_last(state.prev_poses, 1),
                               ss_poses)
        fb_trims = torch.where(use_prev[:, None],
                               _del_first_rpt_last(state.prev_trims, 1),
                               ss_trims)
        fb_shapes = torch.where(use_prev[:, None, None, None],
                                _del_first_rpt_last(state.prev_shapes, 1),
                                ss_shapes)
        fb_cost = torch.where(
            use_prev,
            _tracking_cost(_del_first_rpt_last(state.prev_poses, 1),
                           ref_points),
            ss_cost,
        )

        use_ss = stay_still_ok & ~fallbacks

        def choose(planned_v, ss_v, fb_v):
            shape = (n,) + (1,) * (planned_v.dim() - 1)
            return torch.where(
                fallbacks.reshape(shape), fb_v,
                torch.where(use_ss.reshape(shape), ss_v, planned_v),
            )

        final_poses = choose(poses, ss_poses, fb_poses)
        final_trims = choose(trims, ss_trims, fb_trims)
        final_shapes = choose(planned_shapes, ss_shapes, fb_shapes)
        final_cost = choose(cost, ss_cost, fb_cost)

        # ---- apply (Simulation.apply, plant/Simulation.m:86-117) ----------
        new_state = StepState(
            pose=final_poses[:, 0],
            trim=final_trims[:, 0],
            prev_poses=final_poses,
            prev_trims=final_trims,
            prev_shapes=final_shapes,
            prev_valid=torch.ones((n,), dtype=torch.bool, device=dev),
            priorities_prev=priorities,
        )
        info = StepInfo(
            poses=final_poses,
            trims=final_trims,
            shapes=final_shapes,
            cost=final_cost,
            needs_fallback=fallbacks,
            is_exhausted=is_exhausted,
            n_expanded=n_expanded,
            adjacency=adjacency,
            directed_coupling=directed,
            directed_sequential=sequential,
            levels=levels,
            priorities=priorities,
            reference_points=ref_points,
            priority_permutation=torch.zeros((n,), dtype=torch.int64,
                                             device=dev),
        )
        return new_state, info

    return step


def _tracking_cost(poses, ref_points):
    """Sum over Hp of the squared distance to the reference: [N]."""
    d = poses[..., :2] - ref_points
    return torch.sum(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1], dim=-1)


def make_run(cfg: Config):
    """Receding-horizon experiment (HighLevelController.m:334-373):
    ``run(state0, mpa, scenario, step_seconds=None) -> (final_state,
    infos)`` with infos stacked over the k_end steps. When a list is
    given as ``step_seconds``, each step's wall-clock time (device work
    included) is appended to it."""

    def run(state: StepState, mpa: MpaTensors, scenario: ScenarioTensors,
            step_seconds: list | None = None):
        step = make_prioritized_step(cfg, mpa, scenario)
        sync = (torch.cuda.synchronize
                if state.pose.device.type == "cuda" else (lambda: None))
        infos = []
        for k in range(cfg.k_end):
            t0 = time.perf_counter()
            state, info = step(state, k)
            sync()
            if step_seconds is not None:
                step_seconds.append(time.perf_counter() - t0)
            infos.append(info)
        stacked = StepInfo(*(torch.stack(f) for f in zip(*infos)))
        return state, stacked

    return run


def infos_to_numpy(infos: StepInfo) -> StepInfo:
    return StepInfo(*(np.asarray(x.cpu()) for x in infos))
