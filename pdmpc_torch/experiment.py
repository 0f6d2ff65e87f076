"""Experiment orchestration — the ``main(options)`` capability.

Torch twin of pdmpc_tpu/experiment.py (main.m + HlcFactory.m): builds the
MPA and scenario, moves their tensors to the device, runs the
receding-horizon loop and returns an :class:`ExperimentResult` whose
``infos`` have the reference's fields, stacked over steps as numpy arrays.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from pdmpc_torch import resolve_device
from pdmpc_torch.config import Config, ScenarioType
from pdmpc_torch.controller import (
    StepInfo,
    infos_to_numpy,
    initial_state,
    make_run,
)
from pdmpc_torch.models.mpa import Mpa, build_mpa
from pdmpc_torch.scenarios.circle import create_circle_scenario
from pdmpc_torch.scenarios.commonroad import create_commonroad_scenario
from pdmpc_torch.scenarios.mixed import create_mixed_scenario
from pdmpc_torch.scenarios.scenario import Scenario


def create_scenario(options: Config, mpa: Mpa) -> Scenario:
    """Scenario factory (scenarios/Scenario.m:75-88): circle, mixed and
    commonroad."""
    if options.scenario_type == ScenarioType.circle:
        return create_circle_scenario(options, mpa)
    if options.scenario_type == ScenarioType.mixed:
        return create_mixed_scenario(options, mpa)
    return create_commonroad_scenario(options, mpa)


@dataclass
class ExperimentResult:
    """Result object (hlc/controller/common/ExperimentResult.m): options,
    per-step infos [k_end, ...] (numpy), final state, timings."""

    options: Config
    infos: StepInfo
    final_state: Any
    timings: dict[str, Any] = field(default_factory=dict)

    @property
    def n_steps(self) -> int:
        return int(self.infos.cost.shape[0])

    @property
    def n_vehicles(self) -> int:
        return int(self.infos.cost.shape[-1])

    @property
    def max_number_of_computation_levels(self) -> int:
        return int(self.infos.levels.max())


def run_experiment(options: Config, device=None) -> ExperimentResult:
    """Run one experiment end to end (main.m sequential mode) on ``device``
    (default CUDA; raises if CUDA is absent)."""
    device = resolve_device(device)
    options = options.validate()
    timings: dict[str, Any] = {}

    t0 = time.perf_counter()
    mpa = build_mpa(options)
    scenario = create_scenario(options, mpa)
    mpa_t = mpa.to_tensors_for(options, device)
    sc_t = scenario.to_tensors(device)
    timings["hlc_init_all"] = time.perf_counter() - t0

    run = make_run(options)
    step_seconds: list[float] = []
    t0 = time.perf_counter()
    final_state, infos = run(initial_state(sc_t, options.Hp), mpa_t, sc_t,
                             step_seconds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings["control_loop"] = time.perf_counter() - t0
    timings["steps_per_second"] = options.k_end / timings["control_loop"]
    timings["step_seconds"] = step_seconds
    return ExperimentResult(
        options=options,
        infos=infos_to_numpy(infos),
        final_state=type(final_state)(*(x.cpu() for x in final_state)),
        timings=timings,
    )


def is_deadlock(infos: StepInfo, options: Config) -> np.ndarray:
    """Deadlock metric: a vehicle stopped for more than 3*Hp consecutive
    steps. Reference: eval/2-processing/is_deadlock.m:22-34. Returns [N]
    bool."""
    poses = np.asarray(infos.poses)[:, :, 0, :2]     # [k_end, N, 2]
    moved = np.linalg.norm(np.diff(poses, axis=0), axis=-1) > 1e-6
    n = moved.shape[1]
    threshold = 3 * options.Hp
    deadlocked = np.zeros(n, dtype=bool)
    for v in range(n):
        run = 0
        for k in range(moved.shape[0]):
            run = 0 if moved[k, v] else run + 1
            if run >= threshold:
                deadlocked[v] = True
                break
    return deadlocked
