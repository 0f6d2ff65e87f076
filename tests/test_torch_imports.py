"""The port stands alone: no module of pdmpc_torch (the batch modules
``parallel.sharded`` and ``eval.experiments`` among them), nor
chip_smoke.py or compare_trees.py, loads jax or anything of pdmpc_tpu; and
its entry points, the batched ones too, refuse to fall back to the CPU
silently."""

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
assert {"pdmpc_torch.parallel.sharded", "pdmpc_torch.eval.experiments",
        "pdmpc_torch.profile_step"} <= set(names), names
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "pdmpc_tpu")))
print(len(names), bad)
"""


def test_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 18
    assert bad.strip() == "[]", bad


def test_run_experiment_requires_cuda_by_default(monkeypatch):
    from pdmpc_torch import Config
    from pdmpc_torch.experiment import run_experiment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_experiment(Config(amount=3, T_end=0.2, beam_width=8))


@pytest.mark.parametrize("entry", ["run_experiment_batch",
                                   "monte_carlo_sweep"])
def test_batch_entries_require_cuda_by_default(monkeypatch, entry):
    from pdmpc_torch import Config
    from pdmpc_torch.eval.experiments import monte_carlo_sweep
    from pdmpc_torch.experiment import run_experiment_batch

    run = {"run_experiment_batch": partial(run_experiment_batch,
                                           n_scenarios=2),
           "monte_carlo_sweep": partial(monte_carlo_sweep, n_scenarios=2,
                                        perturb_start_arc=1.0)}[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(Config(amount=3, T_end=0.2, beam_width=8))


@pytest.mark.parametrize("what", ["random_priority", "random_weight",
                                  "sampled", "hdv", "centralized",
                                  "computation_mode"])
def test_unported_config_raises(what, monkeypatch):
    """The parallel computation mode is not ported yet: the entry point
    refuses it. Random priorities and weights, the sampled optimizer and
    human-driven vehicles, ported since, pass the same check and build a
    prioritized step; centralized planning passes it and ``make_run``
    builds its run on ``make_centralized_step``."""
    from pdmpc_torch import (
        ComputationMode,
        Config,
        ManualControlConfig,
        OptimizerType,
        PriorityStrategies,
        WeightStrategies,
    )
    from pdmpc_torch import controller as ctl
    from pdmpc_torch.controller import (
        StepState,
        check_main_path,
        make_prioritized_step,
    )
    from pdmpc_torch.experiment import create_scenario, run_experiment
    from pdmpc_torch.models.mpa import build_mpa

    kw, match = {
        "random_priority": (dict(priority=PriorityStrategies.random_priority),
                            None),
        "random_weight": (dict(weight=WeightStrategies.random_weight), None),
        "sampled": (dict(optimizer_type=OptimizerType.TpuSampled), None),
        "hdv": (dict(manual_control_config=ManualControlConfig(
            is_active=True, amount=1, hdv_ids=(0,))), None),
        "centralized": (dict(is_prioritized=False), None),
        "computation_mode": (dict(
            computation_mode=ComputationMode.parallel_physically),
            "computation_mode=parallel_physically"),
    }[what]
    cfg = Config(amount=3, T_end=0.2, beam_width=8, **kw)
    if match is None:
        cfg = cfg.validate()
        check_main_path(cfg)
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
            return
        if what == "hdv":
            assert scenario.is_hdv.tolist() == [True, False, False]
        assert callable(make_prioritized_step(cfg, mpa_t, scenario))
        return
    with pytest.raises(NotImplementedError, match=match):
        run_experiment(cfg, device="cpu")
