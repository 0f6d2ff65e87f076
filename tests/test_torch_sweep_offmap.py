"""Perturbed Monte-Carlo starts that the reference drives off the map.

``chip_smoke.py`` phase 16b runs ``monte_carlo_sweep`` of the headline
configuration (cr20, coloring priorities, beam 256) over 32 starts
shifted up to 1 m along their paths. In two entries vehicles leave the
map's lanelets: entry 24's vehicle 9 (started 0.82 m further along its
path, already turning) at step 8, entry 30's vehicle 14 at step 15 and
vehicle 10 at step 18. Each takes a branch off its route that ends open
at the map's edge: the boundary constraint checks a lanelet's left and
right boundaries only.

``tests/torch_fixtures/cr20_sweep_entries.npz`` holds the card's start
poses of those entries and their applied poses and trims (``python -m
pdmpc_torch.record_state sweep --out FILE``). The port's start shifts on
the CPU are within two ulps of the card's (CUDA's arithmetic is not
XLA:CPU's). The reference's step, run on the CPU from each entry's start
on the card, leaves the map with the same vehicles at the same steps; in
entry 30 it takes the card's trims at every step, while entry 24's runs
part through those ulps in 5 of 180 trims.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdmpc_torch.eval.experiments import shifted_poses, start_shifts
from pdmpc_torch.experiment import create_scenario
from pdmpc_torch.models.mpa import build_mpa
from pdmpc_torch.ops.geometry import point_in_ring
from pdmpc_torch.record_state import SWEEP_ARC, SWEEP_SCENARIOS, sweep_config
from pdmpc_torch.scenarios.scenario import road_to_tensors

# One intra-op thread per process, as the other port files.
torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                       "cr20_sweep_entries.npz")
# entry -> steps replayed, and (step, vehicle) where a vehicle leaves the
# map's lanelets
DEPARTURES = {24: (9, [(8, 9)]), 30: (19, [(15, 14), (18, 10)])}


@functools.cache
def fixture():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def slot(entry):
    return fixture()["entries"].tolist().index(entry)


@functools.cache
def scenario():
    cfg = sweep_config()
    return cfg, create_scenario(cfg, build_mpa(cfg))


@functools.cache
def reference_step():
    import pdmpc_tpu.config as jc
    from pdmpc_tpu import controller as jctl
    from pdmpc_tpu.experiment import create_scenario as j_create
    from pdmpc_tpu.models.mpa import build_mpa as j_build

    cfg = jc.Config(amount=20, T_end=4.0, beam_width=256,
                    priority=jc.PriorityStrategies.coloring_priority
                    ).validate()
    mpa = j_build(cfg)
    sc_t = j_create(cfg, mpa).to_tensors()
    return (jax.jit(jctl.make_prioritized_step(
        cfg, mpa.to_tensors_for(cfg), sc_t)),
        jctl.initial_state(sc_t, cfg.Hp))


@functools.cache
def reference_run(entry):
    """The reference's applied poses and trims [steps, N, ...] from the
    card's start poses of ``entry``."""
    step, state = reference_step()
    state = state._replace(
        pose=jnp.asarray(fixture()["start_pose"][slot(entry)]))
    poses, trims = [], []
    for k in range(DEPARTURES[entry][0]):
        state, info = step(state, jnp.int32(k))
        poses.append(np.asarray(info.poses[:, 0]))
        trims.append(np.asarray(info.trims[:, 0]))
    return np.stack(poses), np.stack(trims)


def off_map(poses, vehicle):
    """Steps at which ``vehicle``'s applied center lies in no lanelet."""
    _, sc = scenario()
    rings = road_to_tensors(sc.road, "cpu").corridor_rings
    centers = torch.as_tensor(poses[:, vehicle, :2])
    return (~point_in_ring(centers[:, None], rings[None]).any(-1)
            ).nonzero().flatten().tolist()


def test_start_shifts_within_two_ulps_of_the_cards():
    cfg, sc = scenario()
    starts = shifted_poses(sc.to_tensors("cpu"), start_shifts(
        cfg.seed, SWEEP_SCENARIOS, cfg.amount, SWEEP_ARC))
    f = fixture()
    np.testing.assert_array_max_ulp(starts[f["entries"]].numpy(),
                                    f["start_pose"], maxulp=2)


@pytest.mark.parametrize("entry", [30])
def test_reference_takes_the_cards_trims(entry):
    _, trims = reference_run(entry)
    np.testing.assert_array_equal(
        trims, fixture()["applied_trims"][slot(entry), :len(trims)])


@pytest.mark.parametrize("entry", sorted(DEPARTURES))
def test_reference_leaves_the_map_as_the_card(entry):
    poses, _ = reference_run(entry)
    card = fixture()["applied_poses"][slot(entry), :len(poses)]
    for k, vehicle in DEPARTURES[entry][1]:
        assert off_map(poses, vehicle)[0] == k
        assert off_map(card, vehicle)[0] == k
