"""Top-level experiment runner and CLI.

Torch twin of pdmpc_tpu/main.py. Reference: main.m (build the scenario,
save the Config, dispatch on computation_mode, save the results),
main_distributed.m and repeat.m:

    python -m pdmpc_torch.main --scenario circle --amount 4 --t-end 2.0
    python -m pdmpc_torch.main --computation-mode parallel_threads \\
        --device cpu --ranks 2 --no-save
    python -m pdmpc_torch.main --gui   # the config wizard (config_gui.py)
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from pdmpc_torch import resolve_device
from pdmpc_torch.config import (
    ComputationMode,
    Config,
    MpaType,
    OptimizerType,
    PriorityStrategies,
    ScenarioType,
)
from pdmpc_torch.experiment import (
    ExperimentResult,
    create_scenario,
    git_hash,
    run_experiment,
    run_experiment_batch,
)
from pdmpc_torch.utils.filenames import load_latest, results_directory

CONFIG_FILE = "Config.json"


def _is_lead() -> bool:
    """Whether this process writes files: it runs alone, or is rank 0."""
    return not dist.is_initialized() or dist.get_rank() == 0


def main(options: Config | None = None, save: bool = True,
         use_cached: bool = False, device=None,
         n_ranks: int | None = None) -> ExperimentResult:
    """Run one experiment on ``device`` (default CUDA; raises without it).
    Reference: main.m:1-81.

    computation_mode dispatch, as pdmpc_tpu's: ``sequential``, or a batch
    of ``n_scenarios`` > 1, runs the single program; the parallel modes
    run vehicle-sharded over the ranks of the initialized process group
    (``parallel.multihost``). ``parallel_threads`` without one spawns a
    rank per CUDA card (NCCL), or on the CPU ``n_ranks`` ranks (gloo, the
    counterpart of jax_num_cpu_devices). Over one rank the parallel modes
    run the single program, and the result's timings say so
    (``n_devices``, ``mesh``). With ``save``, rank 0 writes Config.json
    to the working directory and the result under
    ``utils.filenames.results_directory``."""
    if options is None:
        options = (Config.load_from_file(CONFIG_FILE)
                   if os.path.isfile(CONFIG_FILE) else Config())
    options = options.validate()
    device = resolve_device(device)

    if use_cached:
        cached = load_latest(options)
        if cached is not None:
            return cached

    # persist the config for reproducibility and repeat() (main.m:16)
    if save and _is_lead():
        options.save_to_file(CONFIG_FILE)

    if (options.computation_mode == ComputationMode.sequential
            or options.n_scenarios > 1):
        result = (run_experiment(options, device)
                  if options.n_scenarios <= 1
                  else run_experiment_batch(options, device=device))
    else:
        result = _run_sharded(options, device, n_ranks)

    if save and _is_lead():
        result.save(results_directory(options))
    return result


def _run_sharded(options: Config, device: torch.device,
                 n_ranks: int | None) -> ExperimentResult:
    """A parallel mode's run over the process group's ranks (spawned
    first where none is initialized, see ``main``, with no wall-clock
    limit: a mismatch of collectives fails after ``comm.TIMEOUT``); over
    one rank, the single program."""
    from pdmpc_torch.parallel import multihost

    if dist.is_initialized():
        world = dist.get_world_size()
    elif options.computation_mode == ComputationMode.parallel_threads:
        world = (torch.cuda.device_count() if device.type == "cuda"
                 else n_ranks or 1)
        if world > 1:
            return multihost.spawn(
                _sharded_rank, world, (options,),
                backend="nccl" if device.type == "cuda" else "gloo",
                device=device.type)[0]
    else:
        world = 1
    if world == 1:
        result = run_experiment(options, device)
        result.timings.update(n_devices=1, mesh=[1, 1], device=str(device),
                              program="sequential")
        return result
    return _sharded_rank(device, options)


def _sharded_rank(device: torch.device, options: Config) -> ExperimentResult:
    """This rank's part of a vehicle-sharded run over the initialized
    process group (pdmpc_tpu main._run_sharded): the mesh takes the most
    vehicle shards that divide both the fleet and the ranks, the other
    factor of the ranks in scenario shards (identical rollouts); the
    result is scenario 0's, the same on every rank."""
    from pdmpc_torch.models.mpa import build_mpa
    from pdmpc_torch.ops import collision
    from pdmpc_torch.parallel import sharded
    from pdmpc_torch.utils.timing import ControllerTiming

    world = dist.get_world_size()
    vehicle_shards = max(c for c in range(1, min(world, options.amount) + 1)
                         if options.amount % c == 0 and world % c == 0)
    scenario_shards = world // vehicle_shards
    timing = ControllerTiming()
    with timing.span("hlc_init_all"):
        mpa = build_mpa(options)
        scenario = create_scenario(options, mpa)
        mpa_t = mpa.to_tensors_for(options, device)
        sc_t = scenario.to_tensors(device)
        mesh = sharded.make_mesh(scenario_shards, vehicle_shards)
        run = sharded.make_sharded_run(options, mpa_t, sc_t, mesh)
        states0 = sharded.place_batched_state(sharded.batched_initial_state(
            sc_t, options.Hp, scenario_shards), mesh)
    kernels = [k + form for k in ("outline_hits", "boundary_hits", "sat_hits")
               for form in ("", "_lattice")]
    before = [getattr(collision, k).launches for k in kernels]
    step_seconds: list[float] = []
    with timing.span("control_loop"):
        final_state, infos = run(states0, mpa_t, sc_t, step_seconds)
    launches = {k: getattr(collision, k).launches - b
                for k, b in zip(kernels, before)}
    launches_by_rank = [None] * world
    dist.all_gather_object(launches_by_rank, launches)
    spans = timing.get_all_timings()
    return ExperimentResult(
        options=options,
        infos=type(infos)(*(x[0].cpu().numpy() for x in infos)),
        final_state=type(final_state)(*(x[0].cpu() for x in final_state)),
        timings={"hlc_init_all": float(spans["hlc_init_all"][1, 0]),
                 "control_loop": float(spans["control_loop"][1, 0]),
                 "step_seconds": step_seconds, "n_devices": world,
                 "mesh": [scenario_shards, vehicle_shards],
                 "backend": dist.get_backend(), "device": str(device),
                 "launches_by_rank": launches_by_rank},
        git_hash=git_hash())


def repeat(device=None) -> ExperimentResult:
    """Re-run the last experiment from Config.json. Reference: repeat.m."""
    return main(Config.load_from_file(CONFIG_FILE), device=device)


def cli(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="pdmpc_torch",
        description="prioritized distributed MPC on PyTorch and CUDA")
    p.add_argument("--config", help="path to a Config.json")
    p.add_argument("--scenario", choices=[s.value for s in ScenarioType])
    p.add_argument("--amount", type=int)
    p.add_argument("--t-end", type=float, dest="t_end")
    p.add_argument("--hp", type=int)
    p.add_argument("--priority",
                   choices=[s.value for s in PriorityStrategies])
    p.add_argument("--optimizer", choices=[s.value for s in OptimizerType])
    p.add_argument("--mpa-type", choices=[s.value for s in MpaType])
    p.add_argument("--max-num-cls", type=int)
    p.add_argument("--beam-width", type=int)
    p.add_argument("--n-scenarios", type=int)
    p.add_argument("--computation-mode",
                   choices=[s.value for s in ComputationMode])
    p.add_argument("--device", help="cuda (the default) or cpu")
    p.add_argument("--ranks", type=int,
                   help="CPU ranks of a parallel_threads run")
    p.add_argument("--repeat", action="store_true",
                   help="re-run the last experiment (repeat.m)")
    p.add_argument("--gui", action="store_true",
                   help="interactive config wizard (ui/config_gui.m)")
    p.add_argument("--no-save", action="store_true")
    args = p.parse_args(argv)

    if args.repeat:
        result = repeat(args.device)
    else:
        if args.gui:
            from pdmpc_torch.config_gui import config_gui

            cfg = config_gui()
        elif args.config:
            cfg = Config.load_from_file(args.config)
        else:
            cfg = Config()
        overrides = {
            "scenario_type": ("scenario", ScenarioType),
            "amount": ("amount", int),
            "T_end": ("t_end", float),
            "Hp": ("hp", int),
            "priority": ("priority", PriorityStrategies),
            "optimizer_type": ("optimizer", OptimizerType),
            "mpa_type": ("mpa_type", MpaType),
            "max_num_CLs": ("max_num_cls", int),
            "beam_width": ("beam_width", int),
            "n_scenarios": ("n_scenarios", int),
            "computation_mode": ("computation_mode", ComputationMode),
        }
        cfg = dataclasses.replace(cfg, **{
            field: typ(v) for field, (arg, typ) in overrides.items()
            if (v := getattr(args, arg)) is not None})
        result = main(cfg, save=not args.no_save, device=args.device,
                      n_ranks=args.ranks)

    n_fallbacks = int(result.infos.needs_fallback.sum())
    print(f"steps={result.n_steps} vehicles={result.n_vehicles} "
          f"fallbacks={n_fallbacks} "
          f"control_loop={result.timings.get('control_loop', 0):.3f}s")
    t = result.timings
    if "mesh" in t:
        rank = dist.get_rank() if dist.is_initialized() else 0
        pose_sum = float(np.sum(result.infos.poses, dtype=np.float64))
        print(f"rank={rank} n_devices={t['n_devices']} mesh={t['mesh']} "
              f"backend={t.get('backend')} device={t.get('device')} "
              f"pose_sum={pose_sum!r}")
    return 0


if __name__ == "__main__":
    sys.exit(cli())
