"""The conservatism of convex against non-convex obstacle geometry on the
20-vehicle CommonRoad scenario, on the card.

    python -m pdmpc_torch.tools.nonconvex_delta [--amount 20]
        [--t-end 2.0] [--beam-width 64] [--device cpu]

Torch twin of the repository root's ``tools/nonconvex_delta.py``: runs
the CommonRoad scenario under ``obstacle_geometry`` "convex" (convex
maneuver areas, the SAT kernel) and "non_convex" (the outline kernel),
both with the lanelet boundary kernel, through ``run_experiment`` on
CUDA unless ``--device`` names another, and prints one JSON object: per
geometry the couplings a step, the fallback and exhausted rates, the mean
cost, the mean distance the vehicles travel, the wall seconds (the
run's set-up included) and the launches of each kernel and of its
lattice form (counters zeroed just before the run and read just after).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from pdmpc_torch import Config, ScenarioType, resolve_device
from pdmpc_torch.experiment import run_experiment
from pdmpc_torch.ops import collision as coll
from pdmpc_torch.tools.axis_sweep import FORMS, KERNELS

GEOMETRIES = ("convex", "non_convex")


def summarize(res, seconds: float, launches: dict) -> dict:
    """The record of one geometry's run."""
    infos = res.infos
    poses = np.asarray(infos.poses)[:, :, 0, :2]          # applied centers
    distance = np.linalg.norm(np.diff(poses, axis=0), axis=-1).sum(axis=0)
    return {
        "couplings_mean_per_step": float(
            np.asarray(infos.adjacency).sum(axis=(1, 2)).mean()),
        "fallback_rate": float(np.asarray(infos.needs_fallback).mean()),
        "exhausted_rate": float(np.asarray(infos.is_exhausted).mean()),
        "mean_cost": float(np.asarray(infos.cost).mean()),
        "mean_distance_traveled_m": float(distance.mean()),
        "wall_s_incl_setup": seconds,
        "steps": res.n_steps,
        "launches": launches,
    }


def measure(amount: int = 20, t_end: float = 2.0, beam_width: int = 64,
            device=None) -> tuple[dict, dict]:
    """Run both geometries on ``device`` (default CUDA; raises without
    it). Returns (record, {geometry: ExperimentResult})."""
    device = resolve_device(device)
    record, results = {}, {}
    for geometry in GEOMETRIES:
        cfg = Config(scenario_type=ScenarioType.commonroad, amount=amount,
                     T_end=t_end, beam_width=beam_width,
                     obstacle_geometry=geometry)
        for name in KERNELS + FORMS:
            getattr(coll, name).launches = 0
        t0 = time.perf_counter()
        res = run_experiment(cfg, device=device)
        seconds = time.perf_counter() - t0
        launches = {name: getattr(coll, name).launches
                    for name in KERNELS + FORMS}
        record[geometry] = summarize(res, seconds, launches)
        results[geometry] = res
    record["device"] = (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else str(device))
    return record, results


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="pdmpc_torch.tools.nonconvex_delta")
    parser.add_argument("--amount", type=int, default=20)
    parser.add_argument("--t-end", type=float, default=2.0)
    parser.add_argument("--beam-width", type=int, default=64)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    record, _ = measure(args.amount, args.t_end, args.beam_width,
                        args.device)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
