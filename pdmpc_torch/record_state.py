"""Save what a run on the card did, for replaying it through the reference
on the CPU.

    python -m pdmpc_torch.record_state fork --out FILE.npz
                                       [--step K] [--after A]
    python -m pdmpc_torch.record_state sweep --out FILE.npz
                                       [--entries E ...] [--steps S]

``fork`` runs the 20-vehicle CommonRoad configuration with random
priorities and weights (beam 512, the default; ``chip_smoke.py`` phase
14's run) for K + A steps (default 17 + 3) and writes the state before
step K (poses, trims, previous plans, their shapes and validity,
priorities: one scenario, numpy arrays named as ``StepState``'s fields)
and the step index.

``sweep`` runs ``monte_carlo_sweep`` of the headline configuration (cr20,
coloring priorities, beam 256; 32 starts shifted up to 1 m along their
paths; ``chip_smoke.py`` phase 16b) for S steps (default 20) and writes
the start poses [E, N, 3] of the entries E (default 24 and 30, whose
vehicles leave the map) and their applied poses [E, steps, N, 3] and
trims [E, steps, N].

``fork`` writes every step's applied poses [steps, N, 3] and trims
[steps, N]; both write the card's name and power limit. CUDA only.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np

from pdmpc_torch import resolve_device
from pdmpc_torch.config import Config, PriorityStrategies, WeightStrategies
from pdmpc_torch.controller import make_prioritized_step
from pdmpc_torch.eval.experiments import (
    monte_carlo_sweep,
    shifted_poses,
    start_shifts,
)
from pdmpc_torch.experiment import create_scenario
from pdmpc_torch.models.mpa import build_mpa
from pdmpc_torch.parallel.sharded import batched_initial_state

SWEEP_SCENARIOS, SWEEP_ARC = 32, 1.0


def fork_config() -> Config:
    """The run whose vehicle 10 leaves its route at a fork at steps 18
    and 19 on the H100."""
    return Config(amount=20, T_end=4.0,
                  priority=PriorityStrategies.random_priority,
                  weight=WeightStrategies.random_weight).validate()


def sweep_config(steps: int = 20) -> Config:
    """The headline configuration of ``chip_smoke.py`` phase 16b."""
    return Config(amount=20, T_end=0.2 * steps, beam_width=256,
                  priority=PriorityStrategies.coloring_priority).validate()


def fork(args, device) -> dict:
    cfg = fork_config()
    mpa = build_mpa(cfg)
    sc_t = create_scenario(cfg, mpa).to_tensors(device)
    step = make_prioritized_step(cfg, mpa.to_tensors_for(cfg, device), sc_t)
    state = batched_initial_state(sc_t, cfg.Hp, 1)
    applied, trims = [], []
    for k in range(args.step + args.after):
        if k == args.step:
            saved = {name: x[0].cpu().numpy()
                     for name, x in state._asdict().items()}
        state, info = step(state, k)
        applied.append(info.poses[0, :, 0].cpu().numpy())
        trims.append(info.trims[0, :, 0].cpu().numpy())
    return dict(step=args.step, applied_poses=np.stack(applied),
                applied_trims=np.stack(trims), **saved)


def sweep(args, device) -> dict:
    cfg = sweep_config(args.steps)
    res = monte_carlo_sweep(cfg, SWEEP_SCENARIOS, SWEEP_ARC, device=device)
    sc_t = create_scenario(cfg, build_mpa(cfg)).to_tensors(device)
    starts = shifted_poses(sc_t, start_shifts(
        cfg.seed, SWEEP_SCENARIOS, cfg.amount, SWEEP_ARC, device))
    entries = list(args.entries)
    return dict(entries=entries, start_pose=starts[entries].cpu().numpy(),
                applied_poses=res.infos.poses[entries, :, :, 0],
                applied_trims=res.infos.trims[entries, :, :, 0])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="run", required=True)
    p_fork = sub.add_parser("fork")
    p_fork.add_argument("--step", type=int, default=17)
    p_fork.add_argument("--after", type=int, default=3)
    p_sweep = sub.add_parser("sweep")
    p_sweep.add_argument("--entries", type=int, nargs="+",
                         default=[24, 30])
    p_sweep.add_argument("--steps", type=int, default=20)
    for p in (p_fork, p_sweep):
        p.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    device = resolve_device()
    record = {"fork": fork, "sweep": sweep}[args.run](args, device)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    np.savez_compressed(args.out, card=card, **record)
    print(f"{args.run} record written to {args.out} ({card})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
