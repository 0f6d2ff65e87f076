"""Run the dissertation evaluation at a feasible scale and write its
artifacts.

Torch twin of tools/run_eval_phd.py. Reference: eval/eval_phd/
eval_phd.m:9-66 — eval_prioritization + eval_bounding sweeps followed by
the values.txt med/max step-time block. The reference ran 20 vehicles on
the 20-NUC lab; here the sweeps run a 10-vehicle commonroad fleet, 3
seeds, on one CUDA card (or the CPU with ``--device cpu``), and the
values block comes from the headline cr20 coloring host loop
(``hlc.run_with_plant``, the deployment-shaped execution):

    python -m pdmpc_torch.eval.run_phd [--device cpu] [--t-end 4.0] \\
        [--amount 10] [--out results/phd_torch]
    python -m pdmpc_torch.eval.run_phd --figures [--out results/phd_torch]

The first writes the runs' artifacts, the second draws the figures from
``<out>/sweeps.json`` with matplotlib, which the card's hosts lack: run
it where matplotlib is installed. Artifacts, under ``--out`` (default
``<RESULTS_ROOT>/phd_torch``; ``results/phd/`` holds the JAX package's
and is never written here):
  values.txt                 med/max per-step time (eval_phd.m:54-66),
                             labelled with the device's name
  sweeps.json                per-cell summaries of both sweeps, each
                             sweep's seconds, the device
  prioritization_time.png    mean step time and cost per strategy
  bounding_cost.png          cost + levels vs max_num_CLs
The sweeps' results are saved and reused under ``<out>/runs``, a results
root of their own.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
import time

import numpy as np
import torch

from pdmpc_torch import resolve_device
from pdmpc_torch.utils.filenames import RESULTS_ROOT


def draw_figures(out: str) -> list[str]:
    """Draw the two figures from ``<out>/sweeps.json`` (eval/plotting.py's
    idiom); returns their paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(os.path.join(out, "sweeps.json")) as f:
        sweeps = json.load(f)
    device, amount = sweeps["device"], sweeps["base"]["amount"]
    # keys (n, strategy, max_num_CLs, seed), as eval_experiments gives them
    prio = {ast.literal_eval(k): v
            for k, v in sweeps["prioritization"].items()}
    bounding = {ast.literal_eval(k): v for k, v in sweeps["bounding"].items()}

    # mean step time + total cost per prioritization strategy (the
    # eval_phd computation-time figure, aggregated over seeds)
    strategies, times, costs = [], [], []
    for key, summ in prio.items():
        strat = key[1].replace("_priority", "")
        if strat not in strategies:
            strategies.append(strat)
            times.append([])
            costs.append([])
        i = strategies.index(strat)
        times[i].append(summ["step_time_mean_ms"])
        costs[i].append(summ["total_cost"])
    fig, ax = plt.subplots(figsize=(6, 3.2))
    ax2 = ax.twinx()
    x = np.arange(len(strategies))
    ax.bar(x, [np.mean(t) for t in times], width=0.55,
           label="mean step time")
    ax2.plot(x, [np.mean(c) for c in costs], "o--", color="tab:orange",
             label="mean total cost")
    ax.set_xticks(x, strategies, rotation=15)
    ax.set_ylabel("mean step time [ms]")
    ax2.set_ylabel("mean total cost")
    ax.set_title(f"Prioritization strategies (cr{amount}, "
                 f"{len(sweeps['base']['seeds'])} seeds, {device})",
                 fontsize=9)
    fig.tight_layout()
    prio_fig = os.path.join(out, "prioritization_time.png")
    fig.savefig(prio_fig, dpi=150)
    plt.close(fig)

    # cost + achieved levels vs max_num_CLs (eval_bounding.m:12 study)
    fig, ax = plt.subplots(figsize=(6, 3.2))
    ax2 = ax.twinx()
    bound_vals = sorted({k[2] for k in bounding})
    cost_by_bound = [
        np.mean([v["total_cost"] for k, v in bounding.items() if k[2] == b])
        for b in bound_vals
    ]
    labels = [("inf" if b >= amount else str(b)) for b in bound_vals]
    ax.plot(range(len(bound_vals)), cost_by_bound, "o-", label="cost")
    ax.set_xticks(range(len(bound_vals)), labels)
    ax.set_xlabel("max_num_CLs")
    ax.set_ylabel("mean total cost")
    levels = [np.mean([v["max_levels"] for k, v in bounding.items()
                       if k[2] == b]) for b in bound_vals]
    ax2.plot(range(len(bound_vals)), levels, "s--", color="tab:orange",
             label="max_levels")
    ax2.set_ylabel("max_levels")
    ax.set_title(f"Computation-level bounding (cr{amount}, {device})",
                 fontsize=9)
    fig.tight_layout()
    bound_fig = os.path.join(out, "bounding_cost.png")
    fig.savefig(bound_fig, dpi=150)
    plt.close(fig)
    return [prio_fig, bound_fig]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m pdmpc_torch.eval.run_phd")
    parser.add_argument("--device", help="cuda (the default) or cpu")
    parser.add_argument("--out", default=os.path.join(RESULTS_ROOT,
                                                      "phd_torch"))
    parser.add_argument("--amount", type=int, default=10)
    parser.add_argument("--t-end", type=float, default=4.0)
    parser.add_argument("--beam", type=int, default=128)
    parser.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    parser.add_argument("--bounds", type=int, nargs="+",
                        default=[1, 2, 4, 99])
    parser.add_argument("--skip-values", action="store_true",
                        help="skip the cr20 host-loop values.txt block "
                             "(smoke runs)")
    parser.add_argument("--figures", action="store_true",
                        help="draw the figures from <out>/sweeps.json "
                             "(needs matplotlib) and run nothing")
    args = parser.parse_args(argv)

    if args.figures:
        for path in draw_figures(args.out):
            print(f"  -> {path}")
        return 0

    from pdmpc_torch import hlc
    from pdmpc_torch.config import Config, PriorityStrategies, ScenarioType
    from pdmpc_torch.eval.experiments import (
        eval_bounding,
        eval_prioritization,
    )
    from pdmpc_torch.eval.phd import write_values_txt

    dev = resolve_device(args.device)
    device = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu")
    os.makedirs(args.out, exist_ok=True)
    runs = os.path.join(args.out, "runs")
    base = Config(
        scenario_type=ScenarioType.commonroad, amount=args.amount,
        T_end=args.t_end, beam_width=args.beam,
    )
    sweep_kw = dict(n_vehicles_list=(args.amount,), seeds=tuple(args.seeds),
                    use_cache=True, save=True, root=runs, device=dev)
    seconds = {}

    print(f"[eval_phd] prioritization sweep on {device} ...", flush=True)
    t0 = time.perf_counter()
    prio = eval_prioritization(base, **sweep_kw)
    seconds["prioritization"] = time.perf_counter() - t0
    print(f"[eval_phd] bounding sweep ({args.bounds}) ...", flush=True)
    t0 = time.perf_counter()
    bounding = eval_bounding(base, bounds=tuple(args.bounds), **sweep_kw)
    seconds["bounding"] = time.perf_counter() - t0

    # ---- values.txt from the headline deployment-shaped host loop -------
    if not args.skip_values:
        print("[eval_phd] cr20 coloring host loop for values.txt ...",
              flush=True)
        cr20 = Config(
            scenario_type=ScenarioType.commonroad, amount=20, T_end=4.0,
            beam_width=256, priority=PriorityStrategies.coloring_priority,
        )
        t0 = time.perf_counter()
        res20 = hlc.run_with_plant(cr20, device=dev)
        seconds["values_host_loop"] = time.perf_counter() - t0
        # 20 steps at T_end=4 s: skip only the first step (the reference
        # skips a 20-step warm-up of a 1000+-step lab run, eval_phd.m:41)
        values_path = write_values_txt(
            res20, path=os.path.join(args.out, "values.txt"),
            i_step_start=1, label=f"{device} cr20 coloring (host loop)",
        )
        with open(values_path) as f:
            print(f"  -> {values_path}: {f.read().strip()}")

    # ---- sweep summaries -------------------------------------------------
    sweeps = {
        "device": device,
        "base": {"scenario": "commonroad", "amount": args.amount,
                 "T_end": args.t_end, "beam_width": args.beam,
                 "seeds": args.seeds},
        "seconds": seconds,
        "prioritization": {str(k): v for k, v in prio.items()},
        "bounding": {str(k): v for k, v in bounding.items()},
        "command": " ".join(sys.argv),
    }
    sweeps_path = os.path.join(args.out, "sweeps.json")

    def _np_safe(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        raise TypeError(f"not JSON-serializable: {type(o)}")

    with open(sweeps_path, "w") as f:
        json.dump(sweeps, f, indent=1, default=_np_safe)
    print(f"  -> {sweeps_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
