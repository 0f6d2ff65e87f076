"""The port end to end on the CPU: the reference's CPU goldens.

Gate: the exact one. ``tests.golden.compare_golden`` holds each of the
port's runs to its golden (trims, fallback pattern and levels equal, poses
within 1e-4) and the cost to rtol 1e-6:

- ``commonroad_03veh``: the road path (outline crossing), Hp 6, beam 64;
- ``circle_03veh_hp10``: the convex path (SAT), Hp 10 (the DP
  reachability of the MPA), beam 128;
- ``circle_03veh_realistic``: the realistic MPA on the circle;
- ``commonroad_03veh_triple``: the triple-speed MPA on the road.

Each run is also held to the behavioral checks of the reference's tests
(tests/test_system_commonroad.py, test_long_horizon.py,
test_mpa_families.py): no collision, progress, and on the road where there
is one. The ``obstacle_geometry`` override has no golden: a road run
checked by SAT and a circle run checked by outline crossing are held to
pdmpc_tpu's own CPU runs of the same configurations.

The 20-vehicle golden takes minutes on one CPU core and is held on the
card by chip_smoke.py instead.
"""

import functools

import numpy as np
import pytest
import torch

from pdmpc_torch.config import Config, MpaType, ScenarioType
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

# golden name -> (configuration, least distance every vehicle moves)
GOLDENS = {
    "commonroad_03veh": (Config(amount=3, T_end=4.0, beam_width=64), 0.5),
    "circle_03veh_hp10": (Config(scenario_type=ScenarioType.circle, amount=3,
                                 T_end=2.0, Hp=10, beam_width=128), 0.3),
    "circle_03veh_realistic": (Config(scenario_type=ScenarioType.circle,
                                      amount=3, T_end=2.0, beam_width=128,
                                      mpa_type=MpaType.realistic), 0.3),
    "commonroad_03veh_triple": (Config(amount=3, T_end=2.0, beam_width=128,
                                       mpa_type=MpaType.triple_speed), 0.3),
}
NAMES = sorted(GOLDENS)
ROAD = [n for n in NAMES if GOLDENS[n][0].scenario_type
        == ScenarioType.commonroad]


@functools.cache
def result(name):
    return run_experiment(GOLDENS[name][0], device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_matches_cpu_golden(name):
    res = result(name)
    compare_golden(name, res)
    with np.load(golden_path(name)) as g:
        # f32 ulps: XLA:CPU's vectorized cos, sin and sqrt round
        # differently from torch's
        np.testing.assert_allclose(res.infos.cost, g["cost"], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_no_collisions(name):
    assert pairwise_vehicle_collisions(result(name)) == []


@pytest.mark.parametrize("name", ROAD)
def test_on_road(name):
    from pdmpc_tpu.config import Config as JConfig
    from pdmpc_tpu.config import MpaType as JMpaType
    from pdmpc_tpu.experiment import create_scenario
    from pdmpc_tpu.models.mpa import build_mpa

    cfg = GOLDENS[name][0]
    cfg = JConfig(amount=cfg.amount, T_end=cfg.T_end,
                  beam_width=cfg.beam_width,
                  mpa_type=JMpaType[cfg.mpa_type.name]).validate()
    scenario = create_scenario(cfg, build_mpa(cfg))
    assert vehicle_centers_offroad(result(name), scenario) == []


@pytest.mark.parametrize("name", NAMES)
def test_no_deadlock(name):
    res = result(name)
    poses = res.infos.poses[:, :, 0]
    moved = np.linalg.norm(poses[-1, :, :2] - poses[0, :, :2], axis=-1)
    assert (moved > GOLDENS[name][1]).all(), f"stuck vehicles: moved {moved}"
    assert not is_deadlock(res.infos, res.options).any()


@pytest.mark.parametrize("name", NAMES)
def test_step_record(name):
    res = result(name)
    cfg = GOLDENS[name][0]
    assert res.n_steps == cfg.k_end and res.n_vehicles == 3
    assert len(res.timings["step_seconds"]) == cfg.k_end
    assert res.infos.poses.shape[2] == cfg.Hp
    assert (res.infos.priority_permutation == 0).all()
    # the coupling graph is exercised: some step couples vehicles (except
    # on the realistic MPA, whose vehicles accelerate through its speed
    # grid and stay apart for these 2 s)
    assert res.infos.adjacency.any() == (name != "circle_03veh_realistic")


@pytest.mark.parametrize("case", ["commonroad_convex", "circle_non_convex"])
def test_geometry_override_matches_reference(case):
    """The ``obstacle_geometry`` override, which has no golden, against
    pdmpc_tpu's CPU run of the same configuration: cr3 checked by SAT
    (the lanelet boundary still by crossing) and the circle checked by
    outline crossing. Trims, fallbacks, levels, exhaustion, expansion
    counts and adjacency equal, poses within 1e-4, cost within rtol
    1e-6."""
    from pdmpc_tpu.config import Config as JConfig
    from pdmpc_tpu.config import ScenarioType as JScenarioType
    from pdmpc_tpu.experiment import run_experiment as j_run_experiment

    scenario, geometry = case.split("_", 1)
    kw = dict(amount=3, T_end=2.0, beam_width=64, obstacle_geometry=geometry)
    want = j_run_experiment(JConfig(
        scenario_type=JScenarioType[scenario], **kw)).infos
    res = run_experiment(Config(scenario_type=ScenarioType[scenario], **kw),
                         device="cpu")
    got = res.infos
    for f in ("trims", "needs_fallback", "levels", "is_exhausted",
              "n_expanded", "adjacency"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.poses, np.asarray(want.poses), atol=1e-4)
    np.testing.assert_allclose(got.cost, np.asarray(want.cost), rtol=1e-6,
                               atol=1e-6)
    assert np.asarray(want.n_expanded).min() > 0
    assert pairwise_vehicle_collisions(res) == []
