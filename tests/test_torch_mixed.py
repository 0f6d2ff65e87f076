"""The mixed road / free-space fleet in the port.

- Scenario tensors: every field of pdmpc_torch's mixed scenario equals
  pdmpc_tpu's (16 vehicles, the CPU golden's split of 10 road and 6
  free-space; 64, the full fleet of 40 and 24), values exactly.
- ``mixed_16veh``: the port's CPU run matches the golden exactly
  (``tests.golden.compare_golden``: trims, fallback pattern and levels
  equal, poses within 1e-4; cost within rtol 1e-6), and is collision-free
  with its road vehicles on the road. The 64-vehicle fleet runs on the
  card (chip_smoke.py phase 10).
"""

import functools

import numpy as np
import pytest
import torch

from pdmpc_torch.config import Config, ScenarioType
from pdmpc_torch.experiment import create_scenario, run_experiment
from pdmpc_torch.models.mpa import build_mpa
from tests.golden import compare_golden, golden_path, vehicle_centers_offroad
from tests.test_controller import pairwise_vehicle_collisions

# One intra-op thread per process (see tests/test_torch_system.py).
torch.set_num_threads(1)

GOLDEN = Config(scenario_type=ScenarioType.mixed, amount=16, T_end=1.0,
                beam_width=64)


@functools.cache
def result():
    return run_experiment(GOLDEN, device="cpu")


@pytest.mark.parametrize("amount", [16, 64])
def test_mixed_scenario_tensors(amount):
    from pdmpc_tpu.config import Config as JConfig
    from pdmpc_tpu.config import ScenarioType as JScenarioType
    from pdmpc_tpu.experiment import create_scenario as j_create
    from pdmpc_tpu.models.mpa import build_mpa as j_build

    tcfg = Config(scenario_type=ScenarioType.mixed, amount=amount).validate()
    jcfg = JConfig(scenario_type=JScenarioType.mixed,
                   amount=amount).validate()
    tsc = create_scenario(tcfg, build_mpa(tcfg)).to_tensors(device="cpu")
    jsc = j_create(jcfg, j_build(jcfg)).to_tensors()
    for f in jsc._fields:
        j, t = getattr(jsc, f), getattr(tsc, f)
        if j is None:
            assert t is None, f
            continue
        pairs = ([(f"road.{r}", getattr(t, r), getattr(j, r))
                  for r in j._fields] if f == "road" else [(f, t, j)])
        for name, got, want in pairs:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=name)
    # free-space vehicles have no lanelet: every path segment maps to 0
    n_road = min(40, (5 * amount) // 8)
    assert (tsc.segment_lanelet[n_road:] == 0).all()
    assert (tsc.segment_lanelet[:n_road] > 0).all()


def test_mixed_16veh_matches_golden():
    res = result()
    compare_golden("mixed_16veh", res)
    with np.load(golden_path("mixed_16veh")) as g:
        np.testing.assert_allclose(res.infos.cost, g["cost"], rtol=1e-6,
                                   atol=1e-6)
    assert res.max_number_of_computation_levels == int(res.infos.levels.max())


def test_mixed_16veh_behavior():
    from pdmpc_tpu.config import Config as JConfig
    from pdmpc_tpu.config import ScenarioType as JScenarioType
    from pdmpc_tpu.experiment import create_scenario as j_create
    from pdmpc_tpu.models.mpa import build_mpa as j_build

    res = result()
    assert pairwise_vehicle_collisions(res) == []
    jcfg = JConfig(scenario_type=JScenarioType.mixed, amount=16, T_end=1.0,
                   beam_width=64).validate()
    scenario = j_create(jcfg, j_build(jcfg))
    n_road = 10
    offroad = vehicle_centers_offroad(res, scenario)
    assert [(k, v) for k, v in offroad if v < n_road] == []
    poses = res.infos.poses[:, :, 0]
    moved = np.linalg.norm(poses[-1, :, :2] - poses[0, :, :2], axis=-1)
    assert (moved > 0.01).all(), moved
