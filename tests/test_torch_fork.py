"""Vehicle 10 at the fork: reference behavior, not a port fault.

In the 20-vehicle CommonRoad run with random priorities and weights (beam
512, ``chip_smoke.py`` phase 14) vehicle 10 drives straight from lanelet
74 into lanelets 53 and 54 at steps 18 and 19, where its route turns into
68: the boundary constraint checks the predicted lanelets' left and right
boundaries only, so a lanelet's end is open. The JAX package's own run of
that configuration on the CPU parts from the card's run earlier, through
float ulps, so the two runs could not be compared there.

``tests/torch_fixtures/cr20_random_step17.npz`` holds the state the port
reached on an H100 before step 17 and the port's applied poses and trims
of steps 0 to 19 there (``python -m pdmpc_torch.record_state fork --out
FILE``). The reference's step, run from that state on the CPU, takes the
same trims at steps 17 to 19, lands on the card's poses and takes vehicle
10 into lanelets 53 and 54 as well.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdmpc_torch.experiment import create_scenario
from pdmpc_torch.models.mpa import build_mpa
from pdmpc_torch.ops.geometry import point_in_ring
from pdmpc_torch.record_state import fork_config
from pdmpc_torch.scenarios.scenario import road_to_tensors

# One intra-op thread per process, as the other port files.
torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                       "cr20_random_step17.npz")
STEPS = (17, 18, 19)
VEHICLE = 10


@functools.cache
def fixture():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


@functools.cache
def reference_steps():
    """The reference's applied poses and trims [3, N, ...] of steps 17 to
    19, run from the card's state before step 17."""
    import pdmpc_tpu.config as jc
    from pdmpc_tpu import controller as jctl
    from pdmpc_tpu.experiment import create_scenario as j_create
    from pdmpc_tpu.models.mpa import build_mpa as j_build

    cfg = jc.Config(amount=20, T_end=4.0,
                    priority=jc.PriorityStrategies.random_priority,
                    weight=jc.WeightStrategies.random_weight).validate()
    mpa = j_build(cfg)
    step = jax.jit(jctl.make_prioritized_step(
        cfg, mpa.to_tensors_for(cfg), j_create(cfg, mpa).to_tensors()))
    f = fixture()
    state = jctl.StepState(*(
        jnp.asarray(f[name].astype(np.int32) if f[name].dtype == np.int64
                    else f[name]) for name in jctl.StepState._fields))
    poses, trims = [], []
    for k in STEPS:
        state, info = step(state, jnp.int32(k))
        poses.append(np.asarray(info.poses[:, 0]))
        trims.append(np.asarray(info.trims[:, 0]))
    return np.stack(poses), np.stack(trims)


def test_fixture_is_the_fork_configuration():
    f = fixture()
    cfg = fork_config()
    assert int(f["step"]) == STEPS[0]
    assert f["pose"].shape == (cfg.amount, 3)
    assert f["applied_poses"].shape == (STEPS[-1] + 1, cfg.amount, 3)
    assert cfg.beam_width == 512 and cfg.k_end == 20


def test_reference_steps_equal_the_cards():
    """Trims equal for every vehicle, poses bit for bit."""
    poses, trims = reference_steps()
    f = fixture()
    np.testing.assert_array_equal(trims, f["applied_trims"][list(STEPS)])
    np.testing.assert_array_equal(poses, f["applied_poses"][list(STEPS)])


@pytest.mark.parametrize("k", STEPS[1:])
def test_reference_takes_vehicle_10_past_its_route(k):
    """At steps 18 and 19 the reference's vehicle 10 stands in lanelets 53
    and 54 (1-based ids) and in none of its own route's lanelets."""
    cfg = fork_config()
    sc = create_scenario(cfg, build_mpa(cfg))
    rings = road_to_tensors(sc.road, "cpu").corridor_rings
    poses, _ = reference_steps()
    center = torch.as_tensor(poses[STEPS.index(k), VEHICLE, :2])
    inside = point_in_ring(center[None], rings).nonzero().flatten().tolist()
    assert inside == [53, 54]
    assert not set(inside) & set(int(i) for i in sc.lanelet_indices[VEHICLE])
