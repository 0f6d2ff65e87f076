"""Scaling measurements over ranks of a process group.

Torch twin of pdmpc_tpu/parallel/scaling.py, over ``torch.distributed``
ranks (``multihost.spawn``) instead of a virtual device mesh. Two axes,
as parallel/sharded.py's mesh:

- data-parallel (scenario axis): weak scaling, each rank carries the same
  batch of rollouts; efficiency = t(1 rank) / t(R ranks) at R times the
  work;
- vehicle axis (``make_sharded_run``): strong scaling, one fleet split
  over the ranks; efficiency = t(1) / (R * t(R)).

    python -m pdmpc_torch.parallel.scaling [--device {cuda,cpu}] --ranks R \
        [--backend {gloo,nccl}] [--scenario commonroad --amount 20 \
        --t-end 4.0 --beam-width 512] [--reps 5]

prints one JSON line; the device is CUDA unless ``--device cpu`` is
given. Each time is the median over ``reps`` runs of the slowest rank
(``*_reps_s`` lists every run). The defaults (circle-4 and circle-8 at
beam 64, 1 s) are JAX's smoke sizes: windows of a few tenths of a second,
too short to read scaling from; a figure worth reading takes the real
configuration. Ranks on the CPU share its cores; ranks on a machine with
fewer cards than ranks share a card (``ranks_share_one_card`` in the
line), through gloo. Such a line says what sharing costs, not how the
run scales over cards of their own.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from pdmpc_torch import resolve_device


def _time_run(run, states, mpa_t, sc_t, reps: int) -> list[float]:
    """Seconds each of ``reps`` runs takes, the slowest rank's, after one
    run that warms the caches (the kernels' build, the scenario tiles)."""
    run(states, mpa_t, sc_t)
    seconds = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        out = run(states, mpa_t, sc_t)
        float(out[0].pose.sum())                   # the work is done
        # on the ranks' device: NCCL reduces CUDA tensors only
        elapsed = torch.tensor([time.perf_counter() - t0],
                               dtype=torch.float64,
                               device=states.pose.device)
        dist.all_reduce(elapsed, op=dist.ReduceOp.MAX)
        seconds.append(float(elapsed))
    return seconds


def _axis_times(device: torch.device, axes: dict, reps: int) -> dict:
    """One rank's part: the seconds of each run of each axis over every
    rank of the group. ``axes``: axis name -> (Config keywords, rollouts a
    rank)."""
    from pdmpc_torch.config import Config
    from pdmpc_torch.experiment import create_scenario
    from pdmpc_torch.models.mpa import build_mpa
    from pdmpc_torch.parallel import sharded

    world = dist.get_world_size()
    times = {}
    for axis, (kw, per_rank) in axes.items():
        cfg = Config(**kw).validate()
        mpa = build_mpa(cfg)
        mpa_t = mpa.to_tensors_for(cfg, device)
        sc_t = create_scenario(cfg, mpa).to_tensors(device)
        if axis == "data_parallel":
            mesh = sharded.make_mesh(world, 1)
            make = sharded.make_data_parallel_run
        else:
            mesh = sharded.make_mesh(1, world)
            make = sharded.make_sharded_run
        states = sharded.place_batched_state(sharded.batched_initial_state(
            sc_t, cfg.Hp, per_rank * mesh.shape[0]), mesh)
        times[axis] = _time_run(make(cfg, mpa_t, sc_t, mesh), states,
                                mpa_t, sc_t, reps)
    return times


def _times(n_ranks: int, axes: dict, device: torch.device, backend: str,
           reps: int, timeout: float | None) -> dict:
    """axis -> (each run's seconds over 1 rank, over ``n_ranks``)."""
    from pdmpc_torch.parallel.multihost import spawn

    one, many = (spawn(_axis_times, r, (axes, reps), backend, device,
                       timeout)[0] for r in (1, n_ranks))
    return {axis: (one[axis], many[axis]) for axis in axes}


def _common(n_ranks: int, device: torch.device, backend: str) -> dict:
    common = {"n_devices": n_ranks, "n_physical_cores": os.cpu_count() or 1,
              "device": device.type, "backend": backend,
              "ranks_share_one_card": (device.type == "cuda" and
                                       torch.cuda.device_count() < n_ranks)}
    if device.type == "cuda":
        common["card"] = torch.cuda.get_device_name(device)
    return common


def _runs(t1s, tns) -> tuple[float, float, dict]:
    """The median of each side's runs, and every run, for a record."""
    return (float(np.median(t1s)), float(np.median(tns)),
            {"t_1dev_reps_s": [round(t, 4) for t in t1s],
             "t_ndev_reps_s": [round(t, 4) for t in tns]})


def _data_parallel_record(n_ranks, batch_per_rank, t1s, tns,
                          common) -> dict:
    # weak scaling: the same work a rank, so equal times are ideal. Ranks
    # on the CPU share its cores, so the slowdown is bounded below by
    # n_ranks / n_cores even for a perfect program; efficiency_vs_physical
    # normalizes by that bound
    t1, tn, reps = _runs(t1s, tns)
    n_cores = common["n_physical_cores"]
    ideal_slowdown = max(n_ranks / min(n_ranks, n_cores), 1.0)
    return {"axis": "scenario(data_parallel)", "mode": "weak", **common,
            "batch_per_device": batch_per_rank,
            "t_1dev_s": round(t1, 4), "t_ndev_s": round(tn, 4), **reps,
            "efficiency": round(min(t1 / tn, 1.5), 4),
            "efficiency_vs_physical": round(
                min(t1 * ideal_slowdown / tn, 1.5), 4),
            "rollouts_per_s_1dev": round(batch_per_rank / t1, 2),
            "rollouts_per_s_ndev": round(batch_per_rank * n_ranks / tn, 2)}


def _vehicle_axis_record(n_ranks, amount, t1s, tns, common) -> dict:
    t1, tn, reps = _runs(t1s, tns)
    speedup = t1 / tn
    max_speedup = min(n_ranks, common["n_physical_cores"])
    return {"axis": "vehicle(MeshComm)", "mode": "strong", **common,
            "amount": amount,
            "t_1dev_s": round(t1, 4), "t_ndev_s": round(tn, 4), **reps,
            "speedup": round(speedup, 3),
            "efficiency": round(speedup / n_ranks, 4),
            "efficiency_vs_physical": round(speedup / max_speedup, 4)}


def _config(scenario_type, amount, t_end, beam) -> dict:
    from pdmpc_torch.config import ScenarioType

    return {"scenario_type": ScenarioType(scenario_type), "amount": amount,
            "T_end": t_end, "beam_width": beam}


def measure_data_parallel(n_ranks: int = 8, amount: int = 4,
                          t_end: float = 1.0, beam: int = 64,
                          batch_per_rank: int = 8,
                          scenario_type: str = "circle", device=None,
                          backend: str = "gloo", reps: int = 2,
                          timeout: float | None = None) -> dict:
    """Weak-scaling efficiency on the scenario (data-parallel) axis, on
    ``device`` (default CUDA; raises without it)."""
    device = resolve_device(device)
    kw = _config(scenario_type, amount, t_end, beam)
    (t1s, tns), = _times(n_ranks, {"data_parallel": (kw, batch_per_rank)},
                         device, backend, reps, timeout).values()
    return _data_parallel_record(n_ranks, batch_per_rank, t1s, tns,
                                 _common(n_ranks, device, backend))


def measure_vehicle_axis(n_ranks: int = 8, amount: int = 8,
                         t_end: float = 1.0, beam: int = 64,
                         scenario_type: str = "circle", device=None,
                         backend: str = "gloo", reps: int = 2,
                         timeout: float | None = None) -> dict:
    """Strong-scaling efficiency on the vehicle (MeshComm) axis, on
    ``device`` (default CUDA; raises without it)."""
    device = resolve_device(device)
    kw = _config(scenario_type, amount, t_end, beam)
    (t1s, tns), = _times(n_ranks, {"vehicle_axis": (kw, 1)}, device,
                         backend, reps, timeout).values()
    return _vehicle_axis_record(n_ranks, amount, t1s, tns,
                                _common(n_ranks, device, backend))


def main(argv: list[str] | None = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(prog="pdmpc_torch.parallel.scaling")
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--device", choices=["cpu", "cuda"],
                        help="cuda (the default) or cpu")
    parser.add_argument("--backend", choices=["gloo", "nccl"],
                        default="gloo")
    parser.add_argument("--scenario", default="circle",
                        choices=["circle", "commonroad"], help="scenario of both axes (default circle-4 for "
                        "the data-parallel axis and circle-8 for the "
                        "vehicle axis)")
    parser.add_argument("--amount", type=int,
                        help="vehicles of both axes' fleet")
    parser.add_argument("--t-end", type=float, default=1.0, dest="t_end")
    parser.add_argument("--beam-width", type=int, default=64)
    parser.add_argument("--batch-per-rank", type=int, default=8)
    parser.add_argument("--reps", type=int, default=2,
                        help="timed runs of each world")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    # both axes' runs share the spawned ranks: one world of 1 rank, one
    # of R ranks
    dp_amount, va_amount = ((args.amount, args.amount) if args.amount
                            else (4, 8))
    dp = _config(args.scenario, dp_amount, args.t_end, args.beam_width)
    va = _config(args.scenario, va_amount, args.t_end, args.beam_width)
    times = _times(args.ranks, {"data_parallel": (dp, args.batch_per_rank),
                                "vehicle_axis": (va, 1)},
                   device, args.backend, args.reps, None)
    common = _common(args.ranks, device, args.backend)
    common["scenario"] = args.scenario
    print(json.dumps({
        "data_parallel": _data_parallel_record(
            args.ranks, args.batch_per_rank, *times["data_parallel"],
            common),
        "vehicle_axis": _vehicle_axis_record(
            args.ranks, va_amount, *times["vehicle_axis"], common)}))


if __name__ == "__main__":
    main()
