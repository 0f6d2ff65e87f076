"""Entry points of the port for an outside harness: one step of the
flagship program as a function with example arguments, and a dry run of
the sharded run over ``n`` ranks.

Torch twin of the repository root's ``__graft_entry__.py``.

    python -m pdmpc_torch.graft_entry        # entry() once on the card

Both run on CUDA unless the caller names the CPU, and neither moves to
the CPU on its own: ``dryrun_multichip`` uses NCCL where the machine has
a card for every rank, and gloo ranks (sharing the cards, or on the CPU)
only where the caller asks for them.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pdmpc_torch import Config, ScenarioType, resolve_device
from pdmpc_torch.controller import make_prioritized_step
from pdmpc_torch.experiment import create_scenario
from pdmpc_torch.models.mpa import build_mpa
from pdmpc_torch.parallel.sharded import batched_initial_state

# a dry run that takes longer has hung (a rank that dies fails at once)
DRYRUN_TIMEOUT_S = 900.0


def _build(amount: int, beam_width: int, t_end: float, device):
    """(configuration, MPA tensors, scenario tensors) of the circle of
    ``amount`` vehicles on ``device``."""
    cfg = Config(scenario_type=ScenarioType.circle, amount=amount,
                 T_end=t_end, beam_width=beam_width).validate()
    mpa = build_mpa(cfg)
    scenario = create_scenario(cfg, mpa)
    return (cfg, mpa.to_tensors_for(cfg, device),
            scenario.to_tensors(device))


def entry(device=None):
    """(fn, example_args): one prioritized multi-vehicle control step
    (traffic info -> coupling graph -> prioritization -> level-by-level
    trim-lattice planning -> fallback -> apply) of the 8-vehicle circle at
    beam 256, batched over 4 scenario rollouts, on ``device`` (default
    CUDA; raises without it). ``fn(states, k, mpa, scenario)`` returns
    the states after step ``k`` and the step's records, each [4, ...]."""
    device = resolve_device(device)
    cfg, mpa_t, sc_t = _build(amount=8, beam_width=256, t_end=2.0,
                              device=device)

    def fn(states, k, mpa, scenario):
        return make_prioritized_step(cfg, mpa, scenario)(states, k)

    states = batched_initial_state(sc_t, cfg.Hp, 4)
    return fn, (states, 0, mpa_t, sc_t)


def _mesh_shape(n_ranks: int, n_vehicles: int) -> tuple[int, int]:
    """(scenario shards, vehicle shards): the vehicle axis the largest of
    4, 2, 1 that divides both the ranks and the vehicles."""
    for v in (4, 2):
        if n_ranks % v == 0 and n_vehicles % v == 0:
            return n_ranks // v, v
    return n_ranks, 1


def _dryrun_rank(device: torch.device, n_ranks: int) -> list[int]:
    """One rank of ``dryrun_multichip``: one step of the sharded run of
    the 4-vehicle circle (beam 32); raises unless every rank holds the
    whole batch's final poses [S, 4, 3], all finite. Returns their
    shape."""
    from pdmpc_torch.parallel import sharded

    n_vehicles = 4
    s_count, v_count = _mesh_shape(n_ranks, n_vehicles)
    cfg, mpa_t, sc_t = _build(amount=n_vehicles, beam_width=32, t_end=0.2,
                              device=device)
    mesh = sharded.make_mesh(s_count, v_count)
    run = sharded.make_sharded_run(cfg, mpa_t, sc_t, mesh, n_steps=1)
    states0 = sharded.place_batched_state(
        batched_initial_state(sc_t, cfg.Hp, s_count), mesh)
    final, _ = run(states0, mpa_t, sc_t)
    pose = final.pose.cpu().numpy()
    if pose.shape != (s_count, n_vehicles, 3) or not np.isfinite(pose).all():
        raise RuntimeError(f"dry run on {n_ranks} ranks: final poses of "
                           f"shape {pose.shape}, finite "
                           f"{bool(np.isfinite(pose).all())}")
    return list(pose.shape)


def dryrun_multichip(n_devices: int, backend: str | None = None,
                     device=None) -> None:
    """Run ONE step of ``make_sharded_run`` on a mesh of ``n_devices``
    ranks (scenario shards x vehicle shards; inside the step, computation
    levels pipeline over the vehicle group's all-gathers) and check the
    final poses' shape and finiteness on every rank.

    The ranks are processes of one ``torch.distributed`` group
    (``parallel.multihost.spawn``) on ``device`` (default CUDA; raises
    without it). ``backend`` None picks NCCL, one card a rank, and raises
    where the machine has fewer cards than ranks: gloo ranks that share
    the cards (``backend="gloo"``) or run on the CPU (``device="cpu"``)
    are the caller's choice, never a silent one."""
    from pdmpc_torch.parallel.multihost import spawn

    device = resolve_device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if backend is None:
        if device.type == "cpu":
            backend = "gloo"
        elif cards >= n_devices:
            backend = "nccl"
        else:
            raise RuntimeError(
                f"{n_devices} NCCL ranks need {n_devices} cards, this "
                f"machine has {cards}: pass backend='gloo' for ranks that "
                f"share the cards, or device='cpu'")
    if backend == "nccl" and cards < n_devices:
        raise RuntimeError(f"NCCL needs a card a rank: {n_devices} ranks, "
                           f"{cards} cards")
    spawn(_dryrun_rank, n_devices, (n_devices,), backend, device,
          DRYRUN_TIMEOUT_S)


if __name__ == "__main__":
    fn, args = entry()
    states, _ = fn(*args)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(states.pose).all()):
        sys.exit("entry(): non-finite poses")
    print("entry() ok")
