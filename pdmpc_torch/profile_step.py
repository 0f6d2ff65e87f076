"""Where a control step's time goes on the card.

    python -m pdmpc_torch.profile_step [--scenario commonroad|circle]
                                       [--amount N] [--sampled]
                                       [--batch B] [--beam W]
                                       [--priority P] [--level-chunk C]

Builds the default configuration of the scenario (CommonRoad: 20 vehicles
by default, outline and boundary kernels; circle: 10 vehicles by default,
the SAT kernel; beam 512, Hp 6; with ``--sampled`` the sampled search,
256 rollouts, whose collision checks are the kernels' (cx, cy) forms) on
CUDA, for a batch of ``--batch`` identical scenarios (default 1) planned
in one merged chunk loop a step, runs WARMUP steps, times TIMED
steps with the host clock (each ending in ``torch.cuda.synchronize()``),
traces PROFILED more steps with ``torch.profiler``, then times HOSTED
more steps with the host clock around every call of the collision
kernels' wrappers. Prints the device operations that took the most
device time and, as the last line, one JSON object: the card's name and
power limit, the median step time, the device time of a step (kernels,
copies and fills on the card) and of the collision kernels, the idle
share (one minus device time over the untraced median step time), the
launches, copies and stream synchronisations per step, and per collision
kernel its launches per step (the wrappers' counters over the timed
steps), its device ms per step and µs per launch (profiler) and its
wrapper's host µs per call (HOSTED steps), and the host ms a step of the
step's host loops over scenarios (coloring, the merged schedule; HOSTED
steps).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pdmpc_torch import resolve_device
from pdmpc_torch import controller as ctl
from pdmpc_torch.config import (
    Config,
    OptimizerType,
    PriorityStrategies,
    ScenarioType,
)
from pdmpc_torch.controller import make_prioritized_step
from pdmpc_torch.experiment import create_scenario
from pdmpc_torch.models.mpa import build_mpa
from pdmpc_torch.ops import collision as coll
from pdmpc_torch.ops import search
from pdmpc_torch.parallel import graph
from pdmpc_torch.parallel.sharded import batched_initial_state

WARMUP, TIMED, HOSTED, PROFILED = 3, 8, 3, 4
TOP = 15
# collision kernel -> a fragment of its device kernels' names (templates of
# csrc/collision.cu); the beam search calls its lattice-form wrapper
# ("<kernel>_lattice"), the sampled search its (cx, cy) form ("<kernel>")
KERNELS = {
    "outline_hits": "OutlineSegs",
    "boundary_hits": "BoundarySegs",
    "sat_hits": "sat_hits_kernel",
}


def wrapper_of(kernel: str, sampled: bool) -> str:
    return kernel if sampled else kernel + "_lattice"


# host loops over a batch's scenarios: (module, function name)
HOST_LOOPS = {"coloring": (graph, "coloring_priorities"),
              "schedule": (ctl, "merged_schedule")}


class host_clocks:
    """Context manager: the host clock around every call of each
    ``(module, name)`` of ``targets`` {label: (module, name)};
    ``spent[label]`` holds [calls, seconds]."""

    def __init__(self, targets):
        self.targets = targets
        self.spent = {label: [0, 0.0] for label in targets}

    def __enter__(self):
        self.originals = {}
        for label, (module, name) in self.targets.items():
            fn = self.originals[label] = getattr(module, name)

            def timed(*args, _fn=fn, _acc=self.spent[label], **kwargs):
                t0 = time.perf_counter()
                out = _fn(*args, **kwargs)
                _acc[1] += time.perf_counter() - t0
                _acc[0] += 1
                return out

            setattr(module, name, timed)
        return self.spent

    def __exit__(self, *exc):
        for label, (module, name) in self.targets.items():
            setattr(module, name, self.originals[label])


# host calls that launch a kernel
LAUNCHES = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx"}


def traced(step, state, k, n):
    """Run ``n`` steps under torch.profiler; returns the state, the next
    step index, the profiler's ``key_averages()`` and the traced host ms
    a step."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, k)
            k += 1
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / n
    return state, k, prof.key_averages(), traced_ms


def device_events(events):
    """The events on the card itself (kernels, copies, fills), not the
    host ops that launched them, which carry the same device time
    again."""
    return [e for e in events if e.device_type == DeviceType.CUDA]


def host_timed(step, state, k, n, sampled):
    """Run ``n`` steps with the host clock around each call of the
    search's collision wrappers and of the host loops over scenarios;
    returns the state, the next step index and {wrapper or loop: [calls,
    seconds]}."""
    targets = {name: (search, name)
               for name in (wrapper_of(kernel, sampled)
                            for kernel in KERNELS)}
    with host_clocks({**targets, **HOST_LOOPS}) as spent:
        for _ in range(n):
            state, _ = step(state, k)
            k += 1
        torch.cuda.synchronize()
    return state, k, spent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scenario", default="commonroad",
                        choices=[t.value for t in ScenarioType
                                 if t != ScenarioType.mixed])
    parser.add_argument("--amount", type=int, default=None,
                        help="vehicles (default: 20 commonroad, 10 circle)")
    parser.add_argument("--sampled", action="store_true",
                        help="the sampled search instead of the beam search")
    parser.add_argument("--batch", type=int, default=1,
                        help="scenarios planned at once (default 1)")
    parser.add_argument("--beam", type=int, default=512,
                        help="beam width (default 512)")
    parser.add_argument("--priority", default="constant_priority",
                        choices=[p.value for p in PriorityStrategies
                                 if p.value not in ("optimal_priority",
                                                    "explorative_priority")])
    parser.add_argument("--level-chunk", type=int, default=None,
                        help="planning chunk width (default 2)")
    args = parser.parse_args(argv)
    scenario = ScenarioType(args.scenario)
    amount = args.amount or (10 if scenario == ScenarioType.circle else 20)
    device = resolve_device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cfg = Config(scenario_type=scenario, amount=amount,
                 T_end=0.2 * (WARMUP + TIMED + HOSTED + PROFILED),
                 beam_width=args.beam,
                 priority=PriorityStrategies(args.priority),
                 level_chunk=args.level_chunk,
                 optimizer_type=(OptimizerType.TpuSampled if args.sampled
                                 else OptimizerType.TpuOptimal))
    cfg = cfg.validate()
    mpa = build_mpa(cfg)
    mpa_t = mpa.to_tensors_for(cfg, device)
    sc_t = create_scenario(cfg, mpa).to_tensors(device)
    step = make_prioritized_step(cfg, mpa_t, sc_t)
    state = batched_initial_state(sc_t, cfg.Hp, args.batch)

    k = 0
    for _ in range(WARMUP):
        state, _ = step(state, k)
        k += 1
    torch.cuda.synchronize()
    for name in KERNELS:
        getattr(coll, name).launches = 0
    wall = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        state, _ = step(state, k)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        k += 1
    launches = {name: getattr(coll, name).launches / TIMED
                for name in KERNELS}

    state, k, events, traced_ms = traced(step, state, k, PROFILED)
    # last, so the timed and traced steps stay those of earlier versions
    state, k, spent = host_timed(step, state, k, HOSTED, args.sampled)

    def per_step(names):
        return sum(e.count for e in events if e.key in names) / PROFILED

    device_ops = device_events(events)

    def device_ms(ops):
        return sum(e.self_device_time_total for e in ops) / 1e3 / PROFILED

    busy_ms = device_ms(device_ops)
    median_ms = statistics.median(wall)
    device_ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(f"{'device op':80s} {'calls/step':>10s} {'ms/step':>9s}")
    for e in device_ops[:TOP]:
        print(f"{e.key[:80]:80s} {e.count / PROFILED:10.1f} "
              f"{device_ms([e]):9.3f}")
    summary = {
        "card": card,
        "config": {"scenario": cfg.scenario_type.value,
                   "amount": cfg.amount, "beam_width": cfg.beam_width,
                   "Hp": cfg.Hp, "sampled": args.sampled,
                   "rollouts": cfg.mcts_n_rollouts, "batch": args.batch,
                   "priority": cfg.priority.value,
                   "level_chunk": cfg.level_chunk},
        "step_ms_median": median_ms,
        "step_ms_traced": traced_ms,
        "device_ms_per_step": busy_ms if device_ops else None,
        "collision_kernels_ms_per_step": device_ms(
            [e for e in device_ops if "hits_kernel" in e.key]),
        "device_idle_share": (1.0 - busy_ms / median_ms
                              if device_ops else None),
        "launches_per_step": per_step(LAUNCHES),
        "memcpy_per_step": per_step({"cudaMemcpyAsync", "cudaMemcpy"}),
        "syncs_per_step": per_step({"cudaStreamSynchronize",
                                    "cudaDeviceSynchronize"}),
        "host_ms_per_step": {label: spent[label][1] * 1e3 / HOSTED
                             for label in HOST_LOOPS},
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "kernels": {},
    }
    for name, fragment in KERNELS.items():
        ops = [e for e in device_ops if fragment in e.key]
        count = sum(e.count for e in ops) / PROFILED
        calls, seconds = spent[wrapper_of(name, args.sampled)]
        summary["kernels"][name] = {
            "launches_per_step": launches[name],
            "device_ms_per_step": device_ms(ops),
            "device_us_per_launch": (device_ms(ops) * 1e3 / count
                                     if count else None),
            "host_us_per_call": seconds * 1e6 / calls if calls else None,
        }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
