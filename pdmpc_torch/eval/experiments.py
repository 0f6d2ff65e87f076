"""Evaluation runs: batched Monte-Carlo rollouts.

Torch twin of pdmpc_tpu/eval/experiments.py's ``monte_carlo_sweep``: one
batch of rollouts of the same scenario, each rollout's vehicles shifted
along their reference paths by a uniform arc, all planned in one merged
chunk loop a step. The parameter sweeps of that module come with the
result store (``ExperimentResult.save`` and ``load``).
"""

from __future__ import annotations

import torch

from pdmpc_torch import prng
from pdmpc_torch.config import Config
from pdmpc_torch.controller import StepState
from pdmpc_torch.experiment import ExperimentResult, run_batch_from
from pdmpc_torch.ops import geometry as geo
from pdmpc_torch.parallel.sharded import batched_initial_state
from pdmpc_torch.scenarios.scenario import ScenarioTensors


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
