"""Sharded execution: the distributed run modes.

Torch twin of pdmpc_tpu/parallel/sharded.py. Maps the reference's
computation modes (config/enums/ComputationMode.m) onto a grid of
``torch.distributed`` ranks:

- ``sequential``          -> the single-program run (``controller.make_run``);
- ``parallel_threads``    -> vehicles sharded over the ranks of a vehicle
  group; the per-vehicle MATLAB processes and DDS topics become ranks and
  collectives (``comm.MeshComm``, the dense level loop);
- ``parallel_physically`` -> the same program over ranks on several hosts
  (``parallel.multihost``); the network replaces the lab's LAN;

plus scenario-batch data parallelism (each rank runs whole scenarios).

A mesh of S x V ranks is row-major, rank = s * V + v: the V ranks of a row
share a scenario block and split its vehicles (the vehicle group), the S
ranks of a column hold the same vehicles of different scenarios (the
scenario group).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from pdmpc_torch.config import Config
from pdmpc_torch.controller import StepInfo, StepState, initial_state, make_run
from pdmpc_torch.models.mpa import MpaTensors
from pdmpc_torch.parallel.comm import TIMEOUT, MeshComm, all_gather_dim
from pdmpc_torch.scenarios.scenario import ScenarioTensors

# the records that are one vehicle's each (sharded over the vehicle
# group); the others are the coupling graph's, replicated in the group
PER_VEHICLE_INFO = ("poses", "trims", "shapes", "cost", "needs_fallback",
                    "is_exhausted", "n_expanded", "reference_points",
                    "priority_permutation")


@dataclass(frozen=True)
class Mesh:
    """This rank's place in an S x V grid of the default group's ranks."""

    shape: tuple[int, int]          # (S scenario shards, V vehicle shards)
    scenario_index: int             # s, the row
    vehicle_index: int              # v, the column
    vehicle_group: dist.ProcessGroup    # the ranks of row s
    scenario_group: dist.ProcessGroup   # the ranks of column v


def make_mesh(n_scenario_shards: int, n_vehicle_shards: int) -> Mesh:
    """The S x V mesh over all ranks of the initialized default group
    (S * V of them). Every rank creates every row's and column's group,
    in the same order, as ``torch.distributed.new_group`` requires."""
    s_count, v_count = n_scenario_shards, n_vehicle_shards
    world = dist.get_world_size()
    if s_count * v_count != world:
        raise ValueError(f"a {s_count} x {v_count} mesh needs "
                         f"{s_count * v_count} ranks, the group has {world}")
    rows = [dist.new_group([s * v_count + v for v in range(v_count)],
                           timeout=TIMEOUT) for s in range(s_count)]
    cols = [dist.new_group([s * v_count + v for s in range(s_count)],
                           timeout=TIMEOUT) for v in range(v_count)]
    s, v = divmod(dist.get_rank(), v_count)
    return Mesh((s_count, v_count), s, v, rows[s], cols[v])


def _assemble(infos: StepInfo, final: StepState, mesh: Mesh,
              vehicle_sharded: bool):
    """The global records [B, k, N, ...] and final state [B, N, ...] from
    this rank's blocks: per-vehicle fields gathered over the row (where
    the vehicles are sharded), then every field over the column."""
    def full(x, vehicle_dim):
        if vehicle_sharded and vehicle_dim is not None:
            x = all_gather_dim(x, vehicle_dim, mesh.vehicle_group)
        return all_gather_dim(x, 0, mesh.scenario_group)

    infos = StepInfo(*(full(x, 2 if name in PER_VEHICLE_INFO else None)
                       for name, x in zip(StepInfo._fields, infos)))
    return StepState(*(full(x, 1) for x in final)), infos


def make_sharded_run(cfg: Config, mpa: MpaTensors, scenario: ScenarioTensors,
                     mesh: Mesh, n_steps: int | None = None):
    """Batched, fully sharded receding-horizon run: ``run(states, mpa,
    scenario, step_seconds=None) -> (final_states, infos)``. ``states``
    is this rank's block [B/S, N/V, ...] of the batch
    (``place_batched_state``); the step plans the block's vehicles and
    exchanges traffic and per-level predictions over the row
    (``MeshComm``). Every rank returns the whole batch: the final states
    [B, N, ...] and the records [B, n_steps, N, ...]."""
    del mpa                             # the step is built at each call
    run_block = make_run(cfg, MeshComm(scenario.n_vehicles,
                                       mesh.vehicle_group), n_steps)

    def run(states: StepState, mpa_t: MpaTensors, sc_t: ScenarioTensors,
            step_seconds: list | None = None):
        final, infos = run_block(states, mpa_t, sc_t, step_seconds)
        return _assemble(infos, final, mesh, vehicle_sharded=True)

    return run


def batched_initial_state(scenario: ScenarioTensors, hp: int,
                          batch: int) -> StepState:
    """``initial_state`` of ``scenario`` for ``batch`` identical scenarios:
    every field [batch, ...] (a copy, so a caller may overwrite one
    scenario's start)."""
    state0 = initial_state(scenario, hp)
    return StepState(*(x[None].expand(batch, *x.shape).clone()
                       for x in state0))


def place_batched_state(states: StepState, mesh: Mesh) -> StepState:
    """This rank's block of a batch of states [B, N, ...]: scenarios
    s * B/S to (s + 1) * B/S - 1 and vehicles v * N/V to
    (v + 1) * N/V - 1."""
    (s_count, v_count), s, v = (mesh.shape, mesh.scenario_index,
                                mesh.vehicle_index)
    b_all, n_all = states.pose.shape[:2]
    if b_all % s_count or n_all % v_count:
        raise ValueError(f"a batch of {b_all} scenarios of {n_all} vehicles "
                         f"does not divide over a {s_count} x {v_count} mesh")
    b, n = b_all // s_count, n_all // v_count
    return StepState(*(x[s * b:(s + 1) * b, v * n:(v + 1) * n].contiguous()
                       for x in states))


def make_data_parallel_run(cfg: Config, mpa: MpaTensors,
                           scenario: ScenarioTensors, mesh: Mesh,
                           n_steps: int | None = None):
    """Scenario-only data parallelism on an S x 1 mesh: each rank runs its
    block of whole scenarios (``place_batched_state``) in one merged chunk
    loop a step (``LocalComm``), and every rank returns the whole batch,
    the entries in scenario order, as ``make_sharded_run``'s run does."""
    del mpa, scenario
    if mesh.shape[1] != 1:
        raise ValueError(f"data parallelism runs whole scenarios on each "
                         f"rank: an S x 1 mesh, not {mesh.shape}")
    run_block = make_run(cfg, n_steps=n_steps)

    def run(states: StepState, mpa_t: MpaTensors, sc_t: ScenarioTensors,
            step_seconds: list | None = None):
        final, infos = run_block(states, mpa_t, sc_t, step_seconds)
        return _assemble(infos, final, mesh, vehicle_sharded=False)

    return run
