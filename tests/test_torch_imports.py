"""The port stands alone: no module of pdmpc_torch (the batch modules
``parallel.sharded`` and ``eval.experiments``, the entry ``main`` and the
distributed modules among them), nor chip_smoke.py, compare_trees.py or
the rank workers of the distributed tests (tests/test_torch_comm.py),
loads jax or anything of pdmpc_tpu; and its entry points, the batched
ones too, refuse to fall back to the CPU silently."""

import os
import subprocess
import sys
from functools import partial

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import pdmpc_torch
names = [m.name for m in pkgutil.walk_packages(pdmpc_torch.__path__,
                                               "pdmpc_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import compare_trees
import tests.test_torch_comm
assert {"pdmpc_torch.parallel.sharded", "pdmpc_torch.eval.experiments",
        "pdmpc_torch.profile_step", "pdmpc_torch.main",
        "pdmpc_torch.parallel.multihost", "pdmpc_torch.parallel.scaling",
        "pdmpc_torch.utils.filenames", "pdmpc_torch.utils.timing"
        } <= set(names), names
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "pdmpc_tpu")))
print(len(names), bad)
"""


def test_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 23
    assert bad.strip() == "[]", bad


def test_run_experiment_requires_cuda_by_default(monkeypatch):
    from pdmpc_torch import Config
    from pdmpc_torch.experiment import run_experiment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_experiment(Config(amount=3, T_end=0.2, beam_width=8))


@pytest.mark.parametrize("entry", ["run_experiment_batch",
                                   "monte_carlo_sweep", "spawn",
                                   "measure_data_parallel",
                                   "measure_vehicle_axis", "scaling_cli"])
def test_batch_entries_require_cuda_by_default(monkeypatch, entry):
    from pdmpc_torch import Config
    from pdmpc_torch.eval.experiments import monte_carlo_sweep
    from pdmpc_torch.experiment import run_experiment_batch
    from pdmpc_torch.parallel import multihost, scaling

    cfg = Config(amount=3, T_end=0.2, beam_width=8)
    run = {"run_experiment_batch": partial(run_experiment_batch, cfg,
                                           n_scenarios=2),
           "monte_carlo_sweep": partial(monte_carlo_sweep, cfg,
                                        n_scenarios=2,
                                        perturb_start_arc=1.0),
           "spawn": partial(multihost.spawn, print, 2),
           "measure_data_parallel": partial(scaling.measure_data_parallel,
                                            n_ranks=2),
           "measure_vehicle_axis": partial(scaling.measure_vehicle_axis,
                                           n_ranks=2),
           "scaling_cli": partial(scaling.main, ["--ranks", "2"])}[entry]
    # no rank process may start before the device is refused
    monkeypatch.setattr(multihost.multiprocessing, "get_context", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run()


@pytest.mark.parametrize("what", ["random_priority", "random_weight",
                                  "sampled", "hdv", "centralized",
                                  "computation_mode"])
def test_unported_config_raises(what, monkeypatch):
    """Every configuration the reference plans builds a step: random
    priorities and weights, the sampled optimizer, human-driven vehicles
    and a parallel computation mode build a prioritized step (the mode
    matters only to ``main``'s dispatch); centralized planning's run is
    built on ``make_centralized_step``, and refuses a vehicle-sharded
    backend."""
    from pdmpc_torch import (
        ComputationMode,
        Config,
        ManualControlConfig,
        OptimizerType,
        PriorityStrategies,
        WeightStrategies,
    )
    from pdmpc_torch import controller as ctl
    from pdmpc_torch.controller import StepState, make_prioritized_step
    from pdmpc_torch.experiment import create_scenario
    from pdmpc_torch.models.mpa import build_mpa
    from pdmpc_torch.parallel.comm import LocalComm

    kw = {
        "random_priority": dict(priority=PriorityStrategies.random_priority),
        "random_weight": dict(weight=WeightStrategies.random_weight),
        "sampled": dict(optimizer_type=OptimizerType.TpuSampled),
        "hdv": dict(manual_control_config=ManualControlConfig(
            is_active=True, amount=1, hdv_ids=(0,))),
        "centralized": dict(is_prioritized=False),
        "computation_mode": dict(
            computation_mode=ComputationMode.parallel_physically),
    }[what]
    cfg = Config(amount=3, T_end=0.2, beam_width=8, **kw).validate()
    mpa = build_mpa(cfg)
    scenario = create_scenario(cfg, mpa).to_tensors("cpu")
    mpa_t = mpa.to_tensors_for(cfg, "cpu")
    if what == "centralized":
        built = []

        def spy(*args):
            built.append(args)
            raise StopIteration

        monkeypatch.setattr(ctl, "make_centralized_step", spy)
        monkeypatch.setattr(ctl, "make_prioritized_step", None)
        state0 = ctl.initial_state(scenario, cfg.Hp)
        with pytest.raises(StopIteration):
            ctl.make_run(cfg)(StepState(*(x[None] for x in state0)),
                              mpa_t, scenario)
        assert [tuple(map(id, a)) for a in built] == [
            (id(cfg), id(mpa_t), id(scenario))]
        with pytest.raises(ValueError, match="one program"):
            ctl.make_run(cfg, LocalComm(cfg.amount))
        return
    if what == "hdv":
        assert scenario.is_hdv.tolist() == [True, False, False]
    assert callable(make_prioritized_step(cfg, mpa_t, scenario))
