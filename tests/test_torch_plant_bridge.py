"""The port's host loop driven by a plant in another process, over a
socket (pdmpc_torch/plant_bridge.py): the twin of
tests/test_plant_bridge.py.

``hlc.run_with_plant`` runs circle-3 (beam 64, 10 steps) against
``ExternalPlant`` fed by ``python -m pdmpc_torch.plant_bridge`` with a
clock 37.5 s ahead. The run equals the simulation plant's in every
record: the poses and headings cross the JSON bridge as float64 and come
back as the same float32 values, and the speed and steering angle map
back to the applied trims. One command is sent and received a step, and
``normalize_timing_results`` (bit-equal to the reference's on these
timings) recovers the clock offset. Every wait has a timeout: the port
line, each socket operation, the server's exit.
"""

import json

import numpy as np
import pytest
import torch

from pdmpc_torch import Config, ScenarioType
from pdmpc_torch import hlc
from pdmpc_torch.eval.processing import normalize_timing_results
from pdmpc_torch.experiment import create_scenario
from pdmpc_torch.models.mpa import build_mpa
from pdmpc_torch.plant import ExternalPlant
from pdmpc_torch.plant_bridge import PlantBridgeClient, launch_server

# One intra-op thread per process, as the other port files.
torch.set_num_threads(1)

CLOCK_OFFSET_S = 37.5
TIMEOUT_S = 60.0


@pytest.fixture(scope="module")
def bridge_run(tmp_path_factory):
    cfg = Config(scenario_type=ScenarioType.circle, amount=3, T_end=2.0,
                 beam_width=64).validate()
    scenario = create_scenario(cfg, build_mpa(cfg))
    spec_path = tmp_path_factory.mktemp("bridge") / "spec.json"
    spec_path.write_text(json.dumps({
        "start_poses": scenario.start_poses.tolist(),
        "start_speeds": [0.0] * cfg.amount,
        "clock_offset_s": CLOCK_OFFSET_S,
    }))
    proc, port = launch_server(str(spec_path), TIMEOUT_S)
    try:
        client = PlantBridgeClient("127.0.0.1", port, timeout_s=TIMEOUT_S)
        plant = ExternalPlant(cfg, measure_fn=client.measure_fn,
                              command_fn=client.command_fn)
        result = hlc.run_with_plant(cfg, plant=plant, device="cpu")
        server_record = client.finish()
        assert proc.wait(timeout=TIMEOUT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT_S)
    simulated = hlc.run_with_plant(cfg, device="cpu")
    return cfg, result, simulated, client, server_record


def test_bridge_run_equals_simulation_plant(bridge_run):
    cfg, result, simulated, _, _ = bridge_run
    assert result.n_steps == cfg.k_end
    for field, x, y in zip(result.infos._fields, result.infos,
                           simulated.infos):
        np.testing.assert_array_equal(x, y, err_msg=field)
    # the vehicles moved, and turned: the heading and the steering trims
    # crossed the bridge
    first = result.infos.poses[:, :, 0]
    assert (np.linalg.norm(first[-1, :, :2] - first[0, :, :2], axis=-1)
            > 0.3).all()
    assert len(np.unique(result.infos.trims[:, :, 0])) > 1


def test_one_command_per_step(bridge_run):
    cfg, _, _, client, server_record = bridge_run
    assert len(client.command_send_times) == cfg.k_end
    assert len(server_record["command_recv_times"]) == cfg.k_end
    assert server_record["clock_offset_s"] == CLOCK_OFFSET_S


def test_timing_normalization_on_skewed_clocks(bridge_run):
    """The command's send (controller clock) and receipt (plant clock,
    skewed by CLOCK_OFFSET_S) are one nearly simultaneous event;
    normalize_timing_results aligns them, as the reference's does."""
    from pdmpc_tpu.eval.processing import (
        normalize_timing_results as j_normalize,
    )

    _, _, _, client, server_record = bridge_run
    send = np.asarray(client.command_send_times)
    recv = np.asarray(server_record["command_recv_times"])
    assert abs(float(np.mean(recv - send)) - CLOCK_OFFSET_S) < 1.0

    def as_structs():
        return [{"receive_from_others": np.stack([t, np.zeros_like(t)]),
                 "controller_start_time": float(t[0])} for t in (send, recv)]

    normed = normalize_timing_results(as_structs())
    for got, want in zip(normed, j_normalize(as_structs())):
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    e0, e1 = (np.sum(n["receive_from_others"], axis=0) for n in normed)
    assert float(np.max(np.abs(e0 - e1))) < 0.5
    assert abs((normed[1]["offset"] - normed[0]["offset"])
               - CLOCK_OFFSET_S) < 1.0


def test_server_that_does_not_start_fails(tmp_path):
    with pytest.raises(RuntimeError, match="did not report a port"):
        launch_server(str(tmp_path / "missing.json"), TIMEOUT_S)
