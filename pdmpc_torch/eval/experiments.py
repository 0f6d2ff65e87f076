"""Experiment sweeps — the eval/1-experiment capability — and batched
Monte-Carlo rollouts.

Torch twin of pdmpc_tpu/eval/experiments.py. Reference:
eval/1-experiment/eval_experiments.m: sweep seeds x n_vehicles x
(priority strategies | max_num_CLs), skip infeasible optimal-priority
sizes, reuse cached results (FileNameConstructor.load_latest
memoization; ``utils.filenames.load_latest`` serves only this package's
results). ``monte_carlo_sweep`` plans one batch of rollouts of the same
scenario, each rollout's vehicles shifted along their reference paths by
a uniform arc, in one merged chunk loop a step.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from pdmpc_torch import prng
from pdmpc_torch.config import Config, PriorityStrategies, ScenarioType
from pdmpc_torch.controller import StepState
from pdmpc_torch.eval.processing import summarize
from pdmpc_torch.experiment import (
    ExperimentResult,
    run_batch_from,
    run_experiment,
)
from pdmpc_torch.ops import geometry as geo
from pdmpc_torch.parallel.sharded import batched_initial_state
from pdmpc_torch.scenarios.scenario import ScenarioTensors
from pdmpc_torch.utils.filenames import load_latest, results_directory

# Reference sweep defaults (eval_experiments.m:29-34)
DEFAULT_COMMONROAD_SIZES = tuple(range(5, 21))
DEFAULT_CIRCLE_SIZES = tuple(range(2, 11))
DEFAULT_SEEDS = (1, 2, 3)
# optimal priority is skipped beyond this size in sweeps
# (eval_experiments.m:60-66)
OPTIMAL_PRIORITY_MAX_VEHICLES = 8


def eval_experiments(
    base: Config | None = None,
    n_vehicles_list: Iterable[int] | None = None,
    priorities: Iterable[PriorityStrategies] = (
        PriorityStrategies.constant_priority,
        PriorityStrategies.random_priority,
        PriorityStrategies.FCA_priority,
        PriorityStrategies.coloring_priority,
    ),
    seeds: Iterable[int] = DEFAULT_SEEDS,
    max_num_cls_list: Iterable[int] | None = None,
    use_cache: bool = True,
    save: bool = True,
    root: str | None = None,
    device=None,
) -> dict:
    """Sweep experiments on ``device`` (default CUDA; raises without it),
    each cell one ``run_experiment``; returns {(n, strategy, max_num_CLs,
    seed): summary dict}. Cached results and saves live under ``root``
    (default ``utils.filenames.RESULTS_ROOT``)."""
    base = base or Config(scenario_type=ScenarioType.circle, T_end=8.0)
    if n_vehicles_list is None:
        n_vehicles_list = (
            DEFAULT_CIRCLE_SIZES
            if base.scenario_type == ScenarioType.circle
            else DEFAULT_COMMONROAD_SIZES
        )

    cells: list[Config] = []
    for n in n_vehicles_list:
        if max_num_cls_list is not None:
            # bounding study (eval_bounding.m:12): cost vs max_num_CLs
            for cls_bound in max_num_cls_list:
                for seed in seeds:
                    cells.append(dataclasses.replace(
                        base, amount=n, max_num_CLs=cls_bound, seed=seed,
                        path_ids=()))
        else:
            for strategy in priorities:
                if (strategy == PriorityStrategies.optimal_priority
                        and n > OPTIMAL_PRIORITY_MAX_VEHICLES):
                    continue  # eval_experiments.m:60-66
                for seed in seeds:
                    cells.append(dataclasses.replace(
                        base, amount=n, priority=strategy, seed=seed,
                        path_ids=()))

    results: dict = {}
    for cfg in cells:
        cfg = cfg.validate()
        result = load_latest(cfg, root) if use_cache else None
        if result is None:
            result = run_experiment(cfg, device)
            if save:
                result.save(results_directory(cfg, root))
        key = (cfg.amount, cfg.priority.value, cfg.max_num_CLs, cfg.seed)
        results[key] = summarize(result)
    return results


def eval_bounding(base: Config | None = None,
                  bounds: Iterable[int] = (1, 2, 4, 6, 99),
                  **kw) -> dict:
    """Computation-level bounding study: solution cost vs max_num_CLs.

    Reference: eval/eval_phd/eval_bounding.m:12 (ECC 2024).
    """
    return eval_experiments(base=base, max_num_cls_list=bounds, **kw)


def eval_prioritization(base: Config | None = None, **kw) -> dict:
    """Prioritization-strategy study. Reference:
    eval_phd/eval_prioritization.m."""
    return eval_experiments(
        base=base,
        priorities=(
            PriorityStrategies.constant_priority,
            PriorityStrategies.random_priority,
            PriorityStrategies.FCA_priority,
            PriorityStrategies.coloring_priority,
            PriorityStrategies.explorative_priority,
        ),
        **kw,
    )


def start_shifts(seed: int, n_scenarios: int, n_vehicles: int,
                 perturb_start_arc: float, device=None) -> torch.Tensor:
    """Each rollout's arc shift of each vehicle [B, N]:
    ``uniform(PRNGKey(seed), (B, N), maxval=perturb_start_arc)``, bit for
    bit the reference's ``jax.random.uniform``."""
    return prng.uniform(prng.prng_key(seed, device),
                        (n_scenarios, n_vehicles), maxval=perturb_start_arc)


def shifted_poses(scenario: ScenarioTensors,
                  shifts: torch.Tensor) -> torch.Tensor:
    """Start poses [B, N, 3] moved ``shifts`` [B, N] along the reference
    paths: the point at the start's projected arc plus the shift, yawed
    along the path 1 mm further (pdmpc_tpu monte_carlo_sweep's
    ``shift_pose``, which runs op by op, unjitted)."""
    b, n = shifts.shape
    paths = scenario.reference_paths.repeat(b, 1, 1)
    cumlen = scenario.path_cumlen.repeat(b, 1)
    s0, _, _ = geo.project_to_polyline(scenario.start_poses[:, :2],
                                       scenario.reference_paths,
                                       scenario.path_cumlen)
    arc = s0.repeat(b) + shifts.reshape(-1)
    pts, _ = geo.sample_path_at_arclength(
        paths, torch.stack([arc, arc + 1e-3], dim=-1), cumlen,
        scenario.is_loop.repeat(b))                          # [B*N, 2, 2]
    d = pts[:, 1] - pts[:, 0]
    yaw = torch.atan2(d[:, 1], d[:, 0])
    return torch.stack([pts[:, 0, 0], pts[:, 0, 1], yaw],
                       dim=-1).reshape(b, n, 3)


def perturbed_states(scenario: ScenarioTensors, cfg: Config,
                     n_scenarios: int,
                     perturb_start_arc: float = 0.0) -> StepState:
    """The initial states of ``monte_carlo_sweep``'s batch: every rollout
    starts as the scenario does, its vehicles shifted along their paths
    where ``perturb_start_arc`` > 0."""
    states = batched_initial_state(scenario, cfg.Hp, n_scenarios)
    if perturb_start_arc > 0.0:
        shifts = start_shifts(cfg.seed, n_scenarios, scenario.n_vehicles,
                              perturb_start_arc, states.pose.device)
        states = states._replace(pose=shifted_poses(scenario, shifts))
    return states


def monte_carlo_sweep(base: Config, n_scenarios: int,
                      perturb_start_arc: float = 0.0,
                      device=None) -> ExperimentResult:
    """Batched Monte-Carlo rollouts in one merged chunk loop a step
    (pdmpc_tpu eval.experiments.monte_carlo_sweep): every rollout runs the
    same scenario; ``perturb_start_arc`` shifts each rollout's vehicles
    along their reference paths to decorrelate them. Infos [B, k_end,
    ...]; timings as ``run_experiment_batch``'s."""
    return run_batch_from(base, lambda sc_t, cfg: perturbed_states(
        sc_t, cfg, n_scenarios, perturb_start_arc), device)
