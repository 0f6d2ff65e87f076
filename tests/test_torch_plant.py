"""The port's host-driven loop and plants on the CPU (pdmpc_torch/hlc.py,
plant.py), against pdmpc_tpu's: the twin of tests/test_plant_models.py's
plant tests.

- ``ExternalPlant``'s ring buffer and map-border stop: the same commands
  (stamps, positions, velocities, ``valid_after``) and the same stop as
  the reference's adapter for the same applied plans.
- ``hlc.run_with_plant`` with the simulation plant (circle-2, beam 32,
  10 steps) equals the port's ``run_experiment`` bit for bit in every
  record (the same step, on a batch of one) and meets the exact gate
  against ``pdmpc_tpu.hlc.run_with_plant``; it records the measure, plan
  and apply spans a step.
- The ``on_step`` abort, and the save-on-error path: a failure injected at
  step 4 leaves a partial result in the results root, which ``load_latest``
  does not serve, and reaches the caller.
"""

import functools
import glob
import json

import numpy as np
import pytest
import torch

import pdmpc_torch.config as tc
import pdmpc_tpu.config as jc
from pdmpc_torch import hlc
from pdmpc_torch.experiment import ExperimentResult, run_experiment
from pdmpc_torch.plant import ExternalPlant, PlantMeasurement
from pdmpc_torch.utils import filenames
from tests.test_torch_hdv import assert_exact

# One intra-op thread per process, as the other port files.
torch.set_num_threads(1)

CIRCLE2 = dict(amount=2, T_end=2.0, beam_width=32)


def circle2(module):
    return module.Config(scenario_type=module.ScenarioType.circle, **CIRCLE2)


@functools.cache
def host_run():
    return hlc.run_with_plant(circle2(tc), device="cpu")


def assert_same_infos(a, b):
    for field, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, field
        np.testing.assert_array_equal(x, y, err_msg=field)


def test_host_loop_equals_run_experiment():
    res = host_run()
    assert res.n_steps == 10
    assert_same_infos(res.infos, run_experiment(circle2(tc),
                                                device="cpu").infos)
    assert res.final_state.pose.shape == (2, 3)
    for span in ("measure", "plan", "apply"):
        starts, durations = np.asarray(res.timings[span])
        assert starts.shape == (10,) and (durations > 0).all(), span
    assert np.asarray(res.timings["control_loop"]).shape == (2, 1)


def test_host_loop_matches_reference_host_loop():
    from pdmpc_tpu.hlc import run_with_plant as j_run_with_plant

    assert_exact(host_run().infos, j_run_with_plant(circle2(jc)).infos)


def test_on_step_abort():
    seen = []

    def hook(k, info):
        seen.append((k, info.poses.shape))
        return k == 2

    res = hlc.run_with_plant(circle2(tc), on_step=hook, device="cpu")
    assert [k for k, _ in seen] == [0, 1, 2]
    assert seen[0][1] == (2, 6, 3)            # records without the B dim
    assert res.n_steps == 3
    assert_same_infos(res.infos, type(res.infos)(
        *(x[:3] for x in host_run().infos)))


def test_partial_result_saved_on_error(tmp_path, monkeypatch):
    """A failure mid-run persists the completed steps — the reference's
    onCleanup save path (HighLevelController.m:508-555) — marked partial,
    so the memoization never serves it, and the failure reaches the
    caller."""
    monkeypatch.setattr(filenames, "RESULTS_ROOT", str(tmp_path))
    cfg = circle2(tc).validate()
    crash_at = 4

    def on_step(k, info):
        if k == crash_at:
            raise RuntimeError("injected mid-run failure")

    with pytest.raises(RuntimeError, match="injected"):
        hlc.run_with_plant(cfg, on_step=on_step, device="cpu")
    metas = glob.glob(filenames.results_directory(cfg) + "/*.json")
    assert len(metas) == 1
    with open(metas[0]) as f:
        meta = json.load(f)
    assert meta["partial"] is True and meta["package"] == "pdmpc_torch"
    assert filenames.load_latest(cfg) is None
    saved = ExperimentResult.load(metas[0][: -len(".json")])
    assert saved.n_steps == crash_at + 1
    assert_same_infos(saved.infos, type(saved.infos)(
        *(x[:crash_at + 1] for x in host_run().infos)))


def buffer_plants(module):
    """An ExternalPlant of ``module`` at one vehicle measured at (2, 2),
    and the list its commands go to."""
    log = []
    cfg = module.Config(scenario_type=module.ScenarioType.circle,
                        amount=1).validate()
    meas = module.plant.PlantMeasurement(
        x=np.array([2.0]), y=np.array([2.0]), yaw=np.array([0.0]),
        speed=np.array([0.0]), steering=np.array([0.0]))
    plant = module.plant.ExternalPlant(cfg, measure_fn=lambda: meas,
                                       command_fn=log.append)
    plant.measure()
    return plant, log, cfg.Hp


def applied_poses(xy, hp):
    p = np.zeros((1, hp, 3))
    p[0, :, 0], p[0, :, 1] = xy
    return p


@pytest.mark.parametrize("x_step", [0.1, 0.6])
def test_ring_buffer_and_map_border_match_reference(x_step):
    """``x_step`` 0.1: the vehicle stays on the map (the ring buffer's
    delay, as tests/test_plant_models.py checks it); 0.6: its 4th
    buffered point leaves the map and the plant stops."""
    import pdmpc_torch
    import pdmpc_tpu
    import pdmpc_torch.plant  # noqa: F401
    import pdmpc_tpu.plant  # noqa: F401

    (port, port_log, hp), (ref, ref_log, _) = (buffer_plants(pdmpc_torch),
                                               buffer_plants(pdmpc_tpu))
    speed = np.array([0.5])
    for k in range(8):
        poses = applied_poses((2.0 + x_step * (k + 1), 2.0), hp)
        port.apply(poses, np.zeros((1, hp)), k, trim_speeds=speed,
                   trim_steerings=np.array([0.1]))
        ref.apply(poses, np.zeros((1, hp)), k, trim_speeds=speed)
        assert port.should_stop() == ref.should_stop(), k
        np.testing.assert_array_equal(port.out_of_map_limits,
                                      ref.out_of_map_limits)
    for got, want in zip(port_log, ref_log):
        assert got[0]["valid_after_ns"] == want[0]["valid_after_ns"]
        assert [{key: p[key] for key in want[0]["points"][0]}
                for p in got[0]["points"]] == want[0]["points"]
    cmd = port_log[-1][0]
    assert len(cmd["points"]) == hp + 1
    # the newest applied pose sits at the end of the buffer (the vehicle
    # receives it with an Hp-1-step delay, CpmLab.m:252-257), with the
    # heading and steering a perfect-execution plant restores
    newest = cmd["points"][-1]
    assert newest["px"] == pytest.approx(2.0 + x_step * 8)
    assert (newest["yaw"], newest["steering"]) == (0.0, 0.1)
    t = [p["t_ns"] for p in cmd["points"]]
    assert all(b >= a for a, b in zip(t, t[1:]))
    assert cmd["valid_after_ns"] == t[1]
    assert port.should_stop() == (x_step > 0.5)


def test_measurement_poses():
    m = PlantMeasurement(x=np.array([1.0, 2.0]), y=np.array([3.0, 4.0]),
                         yaw=np.array([0.5, 0.25]), speed=np.zeros(2),
                         steering=np.zeros(2))
    np.testing.assert_array_equal(m.poses, [[1.0, 3.0, 0.5],
                                            [2.0, 4.0, 0.25]])
    assert ExternalPlant(circle2(tc).validate(),
                         measure_fn=lambda: m).get_step_time() == 0.2
