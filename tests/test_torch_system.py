"""The port end to end on the CPU: the 3-vehicle CommonRoad golden.

Gate: the exact one. ``tests.golden.compare_golden`` holds the port's run
to ``commonroad_03veh.npz`` (the reference's CPU golden) — trims, fallback
pattern and levels equal, poses within 1e-4 — and the run is also held to
the behavioral checks of tests/test_system_commonroad.py: no collision,
on the road, no deadlock. The 20-vehicle golden takes minutes on one CPU
core and is held on the card by chip_smoke.py instead.
"""

import numpy as np
import pytest
import torch

from pdmpc_torch.config import Config
from pdmpc_torch.experiment import is_deadlock, run_experiment
from tests.golden import (
    compare_golden,
    golden_path,
    vehicle_centers_offroad,
)
from tests.test_controller import pairwise_vehicle_collisions

# One intra-op thread per process: the suite runs in several pytest
# workers at once, and a full torch thread pool in each of them
# oversubscribes the cores (a file that takes seconds alone then takes
# minutes).
torch.set_num_threads(1)

CFG = Config(amount=3, T_end=4.0, beam_width=64)


@pytest.fixture(scope="module")
def result():
    return run_experiment(CFG, device="cpu")


def test_matches_cpu_golden(result):
    compare_golden("commonroad_03veh", result)
    with np.load(golden_path("commonroad_03veh")) as g:
        # f32 ulps: the golden's XLA:CPU run fuses multiply-adds
        np.testing.assert_allclose(result.infos.cost, g["cost"], rtol=1e-6,
                                   atol=1e-6)


def test_no_collisions(result):
    assert pairwise_vehicle_collisions(result) == []


def test_on_road(result):
    from pdmpc_tpu.config import Config as JConfig
    from pdmpc_tpu.experiment import create_scenario
    from pdmpc_tpu.models.mpa import build_mpa

    cfg = JConfig(amount=3, T_end=4.0, beam_width=64).validate()
    scenario = create_scenario(cfg, build_mpa(cfg))
    assert vehicle_centers_offroad(result, scenario) == []


def test_no_deadlock(result):
    poses = result.infos.poses[:, :, 0]
    moved = np.linalg.norm(poses[-1, :, :2] - poses[0, :, :2], axis=-1)
    assert (moved > 0.5).all(), f"stuck vehicles: moved {moved}"
    assert not is_deadlock(result.infos, result.options).any()


def test_step_record(result):
    assert result.n_steps == CFG.k_end and result.n_vehicles == 3
    assert len(result.timings["step_seconds"]) == CFG.k_end
    assert (result.infos.priority_permutation == 0).all()
    # the coupling graph is exercised: some step couples vehicles
    assert result.infos.adjacency.any()
