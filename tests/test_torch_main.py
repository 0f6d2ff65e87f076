"""The port's entry point, result store and scaling measurements on the
CPU (pdmpc_torch/main.py, experiment.ExperimentResult.save and load,
utils/filenames.py, parallel/scaling.py).

- The CLI runs ``sequential`` and ``parallel_threads`` (2 gloo ranks, the
  (1, 2) mesh) and prints the JAX CLI's ``steps=... vehicles=...
  fallbacks=... control_loop=...`` line; the parallel run equals the
  sequential one bit for bit, and over one rank a parallel mode runs the
  single program and says so in its timings.
- A saved result loads back equal, and each package loads the other's.
- ``load_latest`` serves the newest complete result with equal options
  (never a partial one); ``repeat`` re-runs Config.json.
- The scaling smoke test of tests/test_scaling.py over 2 gloo ranks.
- ``ControllerTiming``'s once-only and per-step spans.
"""

import re

import numpy as np
import pytest
import torch

from pdmpc_torch import ComputationMode, Config, ScenarioType
from pdmpc_torch import main as tmain
from pdmpc_torch.experiment import ExperimentResult, run_experiment
from pdmpc_torch.parallel.scaling import (
    measure_data_parallel,
    measure_vehicle_axis,
)
from pdmpc_torch.utils import filenames
from pdmpc_torch.utils.timing import ControllerTiming

torch.set_num_threads(1)

ARGS = ["--scenario", "circle", "--amount", "4", "--t-end", "1.0",
        "--beam-width", "32", "--device", "cpu", "--no-save"]
LINE = r"^steps=5 vehicles=4 fallbacks=\d+ control_loop=[\d.]+s$"


def small(**kw):
    return Config(**{"scenario_type": ScenarioType.circle, "amount": 4,
                     "T_end": 1.0, "beam_width": 32, **kw})


def assert_same_infos(a, b):
    for f, x, y in zip(a._fields, a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f)


@pytest.fixture(scope="module")
def sequential():
    return run_experiment(small(), device="cpu")


def test_cli_sequential(capsys, sequential):
    assert tmain.cli(ARGS) == 0
    out = capsys.readouterr().out
    assert re.search(LINE, out, re.M), out
    assert f"fallbacks={int(sequential.infos.needs_fallback.sum())} " in out
    assert "rank=" not in out


def test_cli_parallel_threads(capsys, sequential):
    assert tmain.cli(ARGS + ["--computation-mode", "parallel_threads",
                             "--ranks", "2"]) == 0
    out = capsys.readouterr().out
    assert re.search(LINE, out, re.M), out
    pose_sum = float(np.sum(sequential.infos.poses, dtype=np.float64))
    assert re.search(rf"^rank=0 n_devices=2 mesh=\[1, 2\] backend=gloo "
                     rf"device=cpu pose_sum={re.escape(repr(pose_sum))}$",
                     out, re.M), out


def test_parallel_threads_equals_sequential(sequential):
    res = tmain.main(small(computation_mode=ComputationMode.parallel_threads),
                     save=False, device="cpu", n_ranks=2)
    assert res.timings["mesh"] == [1, 2] and res.timings["n_devices"] == 2
    assert res.timings["backend"] == "gloo"
    assert_same_infos(res.infos, sequential.infos)


@pytest.mark.parametrize("mode", ["parallel_threads", "parallel_physically"])
def test_parallel_mode_over_one_rank_runs_single_program(mode, sequential):
    res = tmain.main(small(computation_mode=ComputationMode(mode)),
                     save=False, device="cpu")
    assert res.timings["n_devices"] == 1 and res.timings["mesh"] == [1, 1]
    assert res.timings["program"] == "sequential"
    assert_same_infos(res.infos, sequential.infos)


def test_gui_is_not_ported():
    with pytest.raises(NotImplementedError, match="gui"):
        tmain.cli(ARGS + ["--gui"])


def test_save_load_round_trip(tmp_path, sequential):
    base = sequential.save(str(tmp_path))
    res = ExperimentResult.load(base)
    assert res.options.isequal(sequential.options)
    assert res.timings == sequential.timings
    assert res.git_hash == sequential.git_hash
    assert res.t_total == pytest.approx(5 * 0.2)
    assert_same_infos(res.infos, sequential.infos)


def test_each_package_loads_the_others_result(tmp_path, sequential):
    import pdmpc_tpu.config as jc
    from pdmpc_tpu.controller import StepInfo as JStepInfo
    from pdmpc_tpu.experiment import ExperimentResult as JResult

    from_port = JResult.load(sequential.save(str(tmp_path / "port")))
    assert from_port.options.to_json_dict() == \
        sequential.options.to_json_dict()
    assert_same_infos(from_port.infos, sequential.infos)

    jax_result = JResult(
        options=jc.Config.from_json_dict(sequential.options.to_json_dict()),
        infos=JStepInfo(*sequential.infos), final_state=None,
        timings={"control_loop": 1.5}, git_hash="abc")
    from_jax = ExperimentResult.load(jax_result.save(str(tmp_path / "jax")))
    assert from_jax.options.isequal(sequential.options)
    assert from_jax.timings == {"control_loop": 1.5}
    assert from_jax.git_hash == "abc"
    assert_same_infos(from_jax.infos, sequential.infos)


def test_load_latest_and_repeat(tmp_path, monkeypatch, sequential):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(filenames, "RESULTS_ROOT", str(tmp_path / "results"))
    cfg = small()
    assert filenames.load_latest(cfg) is None
    first = tmain.main(cfg, device="cpu")
    assert (tmp_path / "Config.json").is_file()
    # a truncated result with equal options is never served
    sequential.save(str(tmp_path / "partial"), partial=True)
    monkeypatch.setattr(filenames, "RESULTS_ROOT", str(tmp_path / "partial"))
    assert filenames.load_latest(cfg) is None
    monkeypatch.setattr(filenames, "RESULTS_ROOT", str(tmp_path / "results"))
    cached = tmain.main(cfg, device="cpu", use_cached=True)
    assert cached.final_state is None          # loaded, not run
    assert_same_infos(cached.infos, first.infos)
    assert filenames.load_latest(small(beam_width=16)) is None
    again = tmain.repeat(device="cpu")
    assert_same_infos(again.infos, sequential.infos)


def test_data_parallel_weak():
    out = measure_data_parallel(n_ranks=2, amount=2, t_end=0.4, beam=16,
                                batch_per_rank=2, device="cpu", timeout=300)
    assert out["n_devices"] == 2 and out["backend"] == "gloo"
    assert out["t_1dev_s"] > 0 and out["t_ndev_s"] > 0
    assert len(out["t_1dev_reps_s"]) == len(out["t_ndev_reps_s"]) == 2
    assert 0 < out["efficiency_vs_physical"] <= 1.5
    assert out["ranks_share_one_card"] is False


def test_vehicle_axis_strong():
    out = measure_vehicle_axis(n_ranks=2, amount=2, t_end=0.4, beam=16,
                               device="cpu", timeout=300)
    assert out["n_devices"] == 2
    assert out["speedup"] > 0
    assert 0 < out["efficiency_vs_physical"] <= 1.5


def test_controller_timing_spans():
    timing = ControllerTiming()
    with timing.span("hlc_init_all"):
        pass
    for step in (0, 2):
        with timing.span("plan", step):
            pass
    spans = timing.get_all_timings()
    assert spans["hlc_init_all"].shape == (2, 1)
    plan = spans["plan"]
    assert plan.shape == (2, 3)
    assert np.isnan(plan[:, 1]).all()
    assert (plan[1, [0, 2]] >= 0).all() and plan[0, 2] >= plan[0, 0]
    assert spans["controller_start_time"] == timing.controller_start_time
