"""One short rollout per distinctive configuration axis, on the card.

    python -m pdmpc_torch.tools.axis_sweep [--cases a,b] [--device cpu]

Torch twin of the repository root's ``tools/tpu_axis_sweep.py``: the same
13 cases (the sampled search, HDVs, distance coupling with random
priorities and weights, FCA with the previous trajectory as successor
constraint, optimal priorities at 4 and 8 vehicles, the scan-tail chunk,
explorative priorities, Hp 10, the triple-speed and realistic MPAs,
centralized planning, the mixed fleet), each through
``experiment.run_experiment`` on CUDA unless ``--device`` names another.

A test suite on the CPU can pass while a path never ran on the card; this
sweep runs every axis there and reports each case as ok or as an error
instead of stopping at the first: one JSON line a case (ok, fallback
rate, steps, seconds, the kernels' launches and their lattice forms', the
warnings the run gave, or the error), then a summary line. The exit code
is 1 when any case failed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import warnings

import numpy as np
import torch

from pdmpc_torch import (
    Config,
    ConstraintFromSuccessor,
    CouplingStrategies,
    ManualControlConfig,
    MpaType,
    OptimizerType,
    PriorityStrategies,
    ScenarioType,
    WeightStrategies,
    resolve_device,
)
from pdmpc_torch.experiment import run_experiment
from pdmpc_torch.ops import collision as coll

KERNELS = ("outline_hits", "boundary_hits", "sat_hits")
# the lattice forms, counted also on their own
FORMS = tuple(name + "_lattice" for name in KERNELS)


def sweep_cases() -> dict[str, Config]:
    """The sweep's cases, name -> configuration (tools/tpu_axis_sweep.py's
    13)."""
    road, circle = ScenarioType.commonroad, ScenarioType.circle
    return {
        "sampled_cr3": Config(
            scenario_type=road, amount=3, T_end=1.0,
            optimizer_type=OptimizerType.TpuSampled, mcts_n_rollouts=128),
        "hdv_cr4": Config(
            scenario_type=road, amount=4, T_end=1.0, beam_width=64,
            manual_control_config=ManualControlConfig(
                is_active=True, amount=1, hdv_ids=(3,))),
        "distance_random_cr3": Config(
            scenario_type=road, amount=3, T_end=1.0, beam_width=64,
            coupling=CouplingStrategies.distance_coupling,
            priority=PriorityStrategies.random_priority,
            weight=WeightStrategies.random_weight),
        "fca_prevtraj_cr3": Config(
            scenario_type=road, amount=3, T_end=1.0, beam_width=64,
            priority=PriorityStrategies.FCA_priority,
            constraint_from_successor=(
                ConstraintFromSuccessor.area_of_previous_trajectory)),
        "optimal_priority_cr4": Config(
            scenario_type=road, amount=4, T_end=1.0, beam_width=64,
            priority=PriorityStrategies.optimal_priority),
        "optimal_priority_cr8": Config(
            scenario_type=road, amount=8, T_end=1.0, beam_width=64,
            priority=PriorityStrategies.optimal_priority),
        "scan_tail_cr4": Config(
            scenario_type=road, amount=4, T_end=1.0, beam_width=64,
            level_chunk=3, unroll_layers=False),
        "explorative_priority_cr4": Config(
            scenario_type=road, amount=4, T_end=1.0, beam_width=64,
            priority=PriorityStrategies.explorative_priority),
        "hp10_circle3": Config(
            scenario_type=circle, amount=3, T_end=1.0, Hp=10,
            beam_width=128),
        "triple_cr3": Config(
            scenario_type=road, amount=3, T_end=1.0, beam_width=128,
            mpa_type=MpaType.triple_speed),
        "realistic_circle3": Config(
            scenario_type=circle, amount=3, T_end=1.0, beam_width=128,
            mpa_type=MpaType.realistic),
        "centralized_circle3": Config(
            scenario_type=circle, amount=3, T_end=1.0, is_prioritized=False,
            beam_width=64),
        "mixed8": Config(
            scenario_type=ScenarioType.mixed, amount=8, T_end=1.0,
            beam_width=64),
    }


def run_case(cfg: Config, device) -> dict:
    """One case on ``device``: its record line (without the name). The
    kernels' counters are zeroed just before the run and read just
    after; an exception of the run becomes the record's error."""
    for name in KERNELS + FORMS:
        getattr(coll, name).launches = 0
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = run_experiment(cfg, device=device)
    except Exception as err:  # noqa: BLE001 -- reported, the sweep goes on
        return {"ok": False, "error": type(err).__name__,
                "detail": str(err)[:300],
                "traceback": traceback.format_exc()[-1200:]}
    return {
        "ok": True,
        "fallback_rate": float(np.asarray(res.infos.needs_fallback).mean()),
        "steps": res.n_steps,
        "seconds": time.perf_counter() - t0,
        "launches": {name: getattr(coll, name).launches
                     for name in KERNELS},
        "lattice_launches": {name: getattr(coll, name).launches
                             for name in FORMS},
        "warnings": sorted({str(w.message) for w in caught}),
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="pdmpc_torch.tools.axis_sweep")
    parser.add_argument("--cases", default=None,
                        help="comma-separated subset of the case names")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cases = sweep_cases()
    if args.cases:
        names = args.cases.split(",")
        unknown = sorted(set(names) - set(cases))
        if unknown:
            parser.error(f"unknown cases {unknown}; known: {sorted(cases)}")
        cases = {name: cases[name] for name in names}
    failures = 0
    for name, cfg in cases.items():
        record = run_case(cfg, device)
        failures += not record["ok"]
        print(json.dumps({name: record}), flush=True)
    print(json.dumps({"summary": {
        "cases": len(cases), "failures": failures,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device))}}),
        flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
