"""Experiment orchestration — the ``main(options)`` capability.

Torch twin of pdmpc_tpu/experiment.py (main.m + HlcFactory.m): builds the
MPA and scenario, moves their tensors to the device, runs the
receding-horizon loop and returns an :class:`ExperimentResult` whose
``infos`` have the reference's fields, stacked over steps as numpy arrays.
``run_experiment`` runs one scenario; ``run_experiment_batch`` plans a
batch of scenario rollouts in one merged chunk loop a step, each entry
equal to its run alone. ``ExperimentResult.save`` and ``load`` keep a
result as the reference's package does (the same ``.npz`` and ``.json``
files), so a result saved by either package loads in the other.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from pdmpc_torch import resolve_device
from pdmpc_torch.config import Config, ScenarioType
from pdmpc_torch.controller import (
    StepInfo,
    StepState,
    infos_to_numpy,
    make_run,
)
from pdmpc_torch.models.mpa import Mpa, build_mpa
from pdmpc_torch.parallel.sharded import batched_initial_state
from pdmpc_torch.scenarios.circle import create_circle_scenario
from pdmpc_torch.scenarios.commonroad import create_commonroad_scenario
from pdmpc_torch.scenarios.mixed import create_mixed_scenario
from pdmpc_torch.scenarios.scenario import Scenario


# ``package`` of a saved result's metadata (``ExperimentResult.save``)
PACKAGE = "pdmpc_torch"


def create_scenario(options: Config, mpa: Mpa) -> Scenario:
    """Scenario factory (scenarios/Scenario.m:75-88): circle, mixed and
    commonroad, with the human-driven vehicles of
    ``options.manual_control_config`` marked."""
    if options.scenario_type == ScenarioType.circle:
        scenario = create_circle_scenario(options, mpa)
    elif options.scenario_type == ScenarioType.mixed:
        scenario = create_mixed_scenario(options, mpa)
    else:
        scenario = create_commonroad_scenario(options, mpa)
    # hdv_ids are 0-based indices into the fleet
    mcc = options.manual_control_config
    if mcc.is_active and mcc.hdv_ids:
        is_hdv = np.zeros(scenario.n_vehicles, dtype=bool)
        is_hdv[[int(i) for i in mcc.hdv_ids]] = True
        scenario.is_hdv = is_hdv
    return scenario


@dataclass
class ExperimentResult:
    """Result object (hlc/controller/common/ExperimentResult.m): options,
    per-step infos [k_end, ...] (numpy; [B, k_end, ...] for a batch of B
    scenarios), final state, timings and the code revision."""

    options: Config
    infos: StepInfo
    final_state: Any
    timings: dict[str, Any] = field(default_factory=dict)
    git_hash: str = ""

    @property
    def n_steps(self) -> int:
        return int(self.infos.cost.shape[-2])

    @property
    def t_total(self) -> float:
        return self.n_steps * self.options.dt_seconds

    @property
    def n_vehicles(self) -> int:
        return int(self.infos.cost.shape[-1])

    @property
    def max_number_of_computation_levels(self) -> int:
        return int(self.infos.levels.max())

    def save(self, directory: str, partial: bool = False) -> str:
        """Write ``<directory>/<yymmdd-HHMMSS>.npz`` (``info_<field>``
        arrays) and ``.json`` (``config``, ``timings``, ``git_hash``;
        ``package``, which marks the result as this package's, so that
        ``utils.filenames.load_latest`` serves no result of pdmpc_tpu;
        and ``partial``, for a truncated save that ``load_latest`` never
        serves), as pdmpc_tpu's ``save``. A second save within the same
        second takes the name ``<yymmdd-HHMMSS>_001`` (then ``_002``, ...),
        which sorts after the first, so no result overwrites another (the
        sweeps save a run a second and more into one directory). Returns
        the path without suffix."""
        os.makedirs(directory, exist_ok=True)
        stamp = os.path.join(directory, time.strftime("%y%m%d-%H%M%S"))
        base, i = stamp, 0
        while os.path.exists(base + ".json") or os.path.exists(base + ".npz"):
            i += 1
            base = f"{stamp}_{i:03d}"
        np.savez_compressed(base + ".npz", **{
            f"info_{k}": np.asarray(v)
            for k, v in self.infos._asdict().items()})
        meta = {"config": self.options.to_json_dict(),
                "timings": self.timings, "git_hash": self.git_hash,
                "package": PACKAGE}
        if partial:
            meta["partial"] = True
        with open(base + ".json", "w") as f:
            json.dump(meta, f, indent=2)
        return base

    @staticmethod
    def load(base: str) -> "ExperimentResult":
        """The result ``save`` wrote at ``base`` (no final state)."""
        with open(base + ".json") as f:
            meta = json.load(f)
        with np.load(base + ".npz") as data:
            infos = StepInfo(**{k[len("info_"):]: data[k]
                                for k in data.files
                                if k.startswith("info_")})
        return ExperimentResult(
            options=Config.from_json_dict(meta["config"]), infos=infos,
            final_state=None, timings=meta["timings"],
            git_hash=meta["git_hash"])


def git_hash() -> str:
    """The checkout's commit, or "" where it is not a git checkout."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def run_experiment(options: Config, device=None) -> ExperimentResult:
    """Run one experiment end to end (main.m sequential mode) on ``device``
    (default CUDA; raises if CUDA is absent): a batch of one scenario, its
    records without the scenario dim."""
    res = run_batch_from(options, identical_starts(1), device)
    res.infos = StepInfo(*(x[0] for x in res.infos))
    res.final_state = type(res.final_state)(*(x[0] for x in res.final_state))
    res.timings["steps_per_second"] = (res.options.k_end
                                       / res.timings["control_loop"])
    return res


def run_experiment_batch(options: Config, n_scenarios: int | None = None,
                         device=None) -> ExperimentResult:
    """Run a batch of scenario rollouts in one merged chunk loop a step
    (pdmpc_tpu experiment.run_experiment_batch, a vmap over scenarios):
    ``n_scenarios`` (default ``options.n_scenarios``) identical starts.
    Infos [B, k_end, ...], final state [B, N, ...]; timings
    ``control_loop``, ``vehicle_solves_per_second`` and the batched
    steps' ``step_seconds``."""
    b = n_scenarios if n_scenarios is not None else options.n_scenarios
    return run_batch_from(options, identical_starts(b), device)


def identical_starts(n_scenarios: int):
    """``run_batch_from``'s initial states: ``n_scenarios`` copies of the
    scenario's own."""
    return lambda sc_t, cfg: batched_initial_state(sc_t, cfg.Hp, n_scenarios)


def run_batch_from(options: Config, states0, device=None) -> ExperimentResult:
    """Build the MPA and scenario of ``options`` on ``device`` and run the
    batch whose initial states ``states0(scenario_tensors, options)``
    gives (options validated)."""
    device = resolve_device(device)
    options = options.validate()
    timings: dict[str, Any] = {}

    t0 = time.perf_counter()
    mpa = build_mpa(options)
    scenario = create_scenario(options, mpa)
    mpa_t = mpa.to_tensors_for(options, device)
    sc_t = scenario.to_tensors(device)
    state0 = states0(sc_t, options)
    timings["hlc_init_all"] = time.perf_counter() - t0

    run = make_run(options)
    step_seconds: list[float] = []
    t0 = time.perf_counter()
    final_state, infos = run(state0, mpa_t, sc_t, step_seconds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings["control_loop"] = time.perf_counter() - t0
    timings["n_scenarios"] = b = state0.pose.shape[0]
    timings["vehicle_solves_per_second"] = (
        b * options.amount * options.k_end / timings["control_loop"])
    timings["step_seconds"] = step_seconds
    return ExperimentResult(
        options=options,
        infos=infos_to_numpy(infos),
        final_state=StepState(*(x.cpu() for x in final_state)),
        timings=timings,
        git_hash=git_hash(),
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
