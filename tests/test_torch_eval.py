"""The port's evaluation pipeline on the CPU (pdmpc_torch/eval/
processing.py, experiments.py's sweeps, phd.py), against pdmpc_tpu's.

- Every ``eval.processing`` function gives the reference's output on the
  same result (a circle-2 run of the port, and the same records stretched
  to 30 steps with a vehicle frozen so the deadlock paths run), and
  ``normalize_timing_results`` the reference's bit for bit on seeded
  multi-controller timings.
- A two-cell ``eval_experiments`` sweep (circle-2, constant and coloring
  priorities, no cache, no save) gives summaries that meet the exact gate
  against the reference's sweep: every count and level statistic equal,
  total cost within rtol 1e-6.
- The result store behind the sweeps: a second sweep is served from the
  cache, and a result the JAX package saved with equal options is never
  served (``utils.filenames.load_latest``).
- ``compute_values`` and ``write_values_txt`` on a host-loop result equal
  the reference's on the same timings.
"""

import functools
import glob
import re

import numpy as np
import pytest
import torch

import pdmpc_torch.config as tc
import pdmpc_tpu.config as jc
from pdmpc_torch.controller import StepInfo
from pdmpc_torch.eval import experiments, phd, processing
from pdmpc_torch.experiment import ExperimentResult, run_experiment
from pdmpc_torch.hlc import run_with_plant
from pdmpc_torch.utils import filenames

# One intra-op thread per process, as the other port files.
torch.set_num_threads(1)

PROCESSING = ("compute_deadlock_free_runtime", "data_cost_per_step",
              "data_fallback_rate", "compute_levels_data",
              "data_n_expanded", "summarize")
# summary fields that hold a measured time, not a result of the plan
TIMED = {"step_time_mean_ms"}


def small(module, **kw):
    return module.Config(**{"scenario_type": module.ScenarioType.circle,
                            "amount": 2, "T_end": 1.0, "beam_width": 32,
                            **kw})


@functools.cache
def port_result():
    return run_experiment(small(tc, T_end=2.0), device="cpu")


def as_reference(res):
    """The same result as a pdmpc_tpu ExperimentResult."""
    from pdmpc_tpu.controller import StepInfo as JStepInfo
    from pdmpc_tpu.experiment import ExperimentResult as JResult

    return JResult(options=jc.Config.from_json_dict(
        res.options.to_json_dict()), infos=JStepInfo(*res.infos),
        final_state=None, timings=res.timings)


def frozen(res):
    """``res``'s records three times over (30 steps) with vehicle 1 frozen
    at its first pose: a deadlock after 3 Hp steps."""
    infos = StepInfo(*(np.concatenate([x] * 3) for x in res.infos))
    poses = infos.poses.copy()
    poses[:, 1] = poses[0, 1]
    return ExperimentResult(options=res.options,
                            infos=infos._replace(poses=poses),
                            final_state=None, timings=res.timings)


def assert_same(got, want, msg=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), msg
        for key in want:
            assert_same(got[key], want[key], f"{msg}.{key}")
    elif isinstance(want, list):
        assert len(got) == len(want), msg
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{msg}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=msg)


@pytest.mark.parametrize("records", ["run", "frozen"])
@pytest.mark.parametrize("name", PROCESSING)
def test_processing_matches_reference(name, records):
    import pdmpc_tpu.eval.processing as jp

    res = port_result() if records == "run" else frozen(port_result())
    got = getattr(processing, name)(res)
    assert_same(got, getattr(jp, name)(as_reference(res)), name)
    if name == "summarize" and records == "frozen":
        assert got["deadlocked_vehicles"] == 1
        assert got["deadlock_free_runtime_s"] < res.t_total


def test_merge_matches_reference():
    import pdmpc_tpu.eval.processing as jp

    res = port_result()
    halves = [ExperimentResult(options=res.options, infos=StepInfo(
        *(x[:, v:v + 1] for x in res.infos)), final_state=None,
        timings={"control_loop": 1.0 + v}) for v in range(2)]
    got = processing.merge_experiment_results(halves)
    want = jp.merge_experiment_results([as_reference(h) for h in halves])
    for field, x, y in zip(got.infos._fields, got.infos, want.infos):
        np.testing.assert_array_equal(x, y, err_msg=field)
    assert got.timings == want.timings
    assert processing.merge_experiment_results(halves[:1]) is halves[0]
    with pytest.raises(ValueError):
        processing.merge_experiment_results([])


def seeded_timings():
    rng = np.random.default_rng(0)
    event = np.cumsum(rng.uniform(0.1, 0.2, 10))
    return [{"controller_start_time": 100.0 + off,
             "receive_from_others": np.stack([event + off - 0.01,
                                              rng.uniform(0, 0.02, 10)]),
             "optimize": np.stack([event + off, np.full(10, 0.05)])}
            for off in (0.0, 0.37, -1.25)]


def test_normalize_timing_results_bit_equal():
    import pdmpc_tpu.eval.processing as jp

    got = processing.normalize_timing_results(seeded_timings())
    assert_same(got, jp.normalize_timing_results(seeded_timings()))
    single = {"controller_start_time": 5.0}
    assert processing.normalize_timing_results(single) is single


def assert_summaries_gate(got, want):
    """The exact gate between two sweeps' summaries."""
    assert got.keys() == want.keys()
    for key, summary in want.items():
        for field, value in summary.items():
            if field in TIMED:
                continue
            if field == "total_cost":
                np.testing.assert_allclose(got[key][field], value,
                                           rtol=1e-6, err_msg=str(key))
            else:
                assert_same(got[key][field], value, f"{key}.{field}")


def test_sweep_meets_exact_gate_against_reference():
    from pdmpc_tpu.eval.experiments import eval_experiments as j_sweep

    kw = dict(n_vehicles_list=(2,), seeds=(1,), use_cache=False, save=False)
    got = experiments.eval_experiments(
        small(tc), priorities=(tc.PriorityStrategies.constant_priority,
                               tc.PriorityStrategies.coloring_priority),
        device="cpu", **kw)
    want = j_sweep(small(jc), priorities=(
        jc.PriorityStrategies.constant_priority,
        jc.PriorityStrategies.coloring_priority), **kw)
    assert sorted(got) == [(2, "coloring_priority", 2, 1),
                           (2, "constant_priority", 2, 1)]
    assert_summaries_gate(got, want)


def test_sweep_cache_serves_only_the_ports_results(tmp_path):
    """The cached sweep reuses the port's saved result, and never one
    that pdmpc_tpu saved with equal options (it may hold the TPU's
    timings)."""
    # the sweep's one cell
    cfg = small(tc, seed=1).validate()
    jax_saved = as_reference(run_experiment(cfg, device="cpu"))
    jax_saved.save(filenames.results_directory(cfg, str(tmp_path)))
    assert filenames.load_latest(cfg, str(tmp_path)) is None

    kw = dict(n_vehicles_list=(2,), seeds=(1,), root=str(tmp_path),
              priorities=(tc.PriorityStrategies.constant_priority,),
              device="cpu")
    first = experiments.eval_experiments(small(tc), **kw)
    files = sorted(glob.glob(str(tmp_path / "**" / "*.npz"),
                             recursive=True))
    assert len(files) == 2                 # the JAX result and the port's
    assert filenames.load_latest(cfg, str(tmp_path)) is not None
    again = experiments.eval_experiments(small(tc), **kw)
    assert sorted(glob.glob(str(tmp_path / "**" / "*.npz"),
                            recursive=True)) == files
    assert_summaries_gate(again, first)


def test_bounding_and_prioritization_cells(monkeypatch):
    cells = []

    def fake_sweep(**kw):
        cells.append(kw)
        return {}

    monkeypatch.setattr(experiments, "eval_experiments", fake_sweep)
    experiments.eval_bounding(small(tc), bounds=(1, 99), device="cpu")
    experiments.eval_prioritization(small(tc), device="cpu")
    assert cells[0]["max_num_cls_list"] == (1, 99)
    assert [p.value for p in cells[1]["priorities"]] == [
        "constant_priority", "random_priority", "FCA_priority",
        "coloring_priority", "explorative_priority"]


@functools.cache
def host_result():
    return run_with_plant(small(tc), device="cpu")


def test_compute_values_matches_reference():
    from pdmpc_tpu.eval.phd import compute_values as j_values

    res = host_result()
    got = phd.compute_values(res, i_step_start=1)
    assert got == j_values(as_reference(res), i_step_start=1)
    assert got["max_ms"] >= got["med_ms"] > 0
    assert got["n_steps_used"] == res.n_steps - 1
    with pytest.raises(ValueError, match="no finite step times"):
        phd.compute_values(ExperimentResult(
            options=res.options, infos=res.infos, final_state=None,
            timings={"plan": [[0.0] * 5, [np.nan] * 5]}))


def test_write_values_txt(tmp_path, monkeypatch):
    from pdmpc_tpu.eval.phd import write_values_txt as j_write

    res = host_result()
    path = phd.write_values_txt(res, path=str(tmp_path / "values.txt"),
                                i_step_start=1, label="H100 cr2")
    with open(path) as f:
        content = f.read()
    assert re.fullmatch(r"H100 cr2 -- max: *[\d.]+ ms -- med: *[\d.]+ ms\n",
                        content)
    j_path = j_write(as_reference(res), path=str(tmp_path / "ref.txt"),
                     i_step_start=1, label="H100 cr2")
    with open(j_path) as f:
        assert f.read() == content
    # the default path is the port's own, never results/phd/
    monkeypatch.setattr(phd, "RESULTS_ROOT", str(tmp_path / "root"))
    assert phd.write_values_txt(res, i_step_start=1) == str(
        tmp_path / "root" / "phd_torch" / "values.txt")
    # eval_phd's values block: 5 steps, fewer than the 20 of warm-up the
    # reference skips, so every step counts
    out = phd.eval_phd(res, out_path=str(tmp_path / "phd" / "v.txt"))
    assert out["values"]["n_steps_used"] == res.n_steps
    assert out["values_txt"] == str(tmp_path / "phd" / "v.txt")
