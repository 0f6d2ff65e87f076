"""The distributed runs equal the sequential ones (the reference's
systemtests run every computation mode against the same goldens,
tests/systemtests/systemtests.m:8): the port's ``make_sharded_run`` over
gloo ranks on the CPU, vehicle-sharded with ``MeshComm`` and the dense
level loop, against the port's single program and the JAX package's own
``make_sharded_run``.

- The cells of tests/test_sharded.py: circle-4 (beam 64, 3 steps, B = 2)
  on a (2, 2) mesh, and cr4 with vehicle 3 human-driven (beam 96, 3
  steps, B = 2) on (1, 4) and (2, 2) meshes; and circle-4 at beam 16 for
  15 steps (four computation levels, exhaustion and fallbacks) on (2, 2).
- Explorative voting (beam 8, 15 steps: levels and exhaustion) and the
  sampled search (64 rollouts, 3 steps), each circle-4 on a (1, 2) mesh;
  ``make_data_parallel_run`` of circle-4, B = 4, on 2 ranks.
- Every cell equals ``run_experiment_batch`` of its configuration in every
  record and the final states, bit for bit; every rank's assembled
  records (the replicated coupling graph among them) equal rank 0's; the
  tests/test_sharded.py cells equal the JAX package's run on its (2, 4)
  mesh: trims, levels and fallbacks equal, poses within 1e-6, as that
  file holds its own sharded run.
"""

import enum
import functools

import jax
import numpy as np
import pytest
import torch

import pdmpc_torch.config as tc
import pdmpc_tpu.config as jc
from pdmpc_torch.experiment import run_experiment_batch
from pdmpc_torch.parallel.multihost import spawn
from tests.test_torch_comm import sharded_runs

torch.set_num_threads(1)

STEPS3 = 3 * 0.2
HDV3 = dict(manual_control_config=tc.ManualControlConfig(
    is_active=True, amount=1, hdv_ids=(3,)))
CIRCLE = dict(scenario_type=tc.ScenarioType.circle, amount=4)
# name -> (Config keywords, mesh, batch, kind, ranks)
CELLS = {
    "circle4": (dict(CIRCLE, T_end=STEPS3, beam_width=64), (2, 2), 2,
                "sharded", 4),
    "cr4_hdv_1x4": (dict(amount=4, T_end=STEPS3, beam_width=96, **HDV3),
                    (1, 4), 2, "sharded", 4),
    "cr4_hdv_2x2": (dict(amount=4, T_end=STEPS3, beam_width=96, **HDV3),
                    (2, 2), 2, "sharded", 4),
    "circle4_levels": (dict(CIRCLE, T_end=3.0, beam_width=16), (2, 2), 2,
                       "sharded", 4),
    "circle4_explorative": (dict(
        CIRCLE, T_end=3.0, beam_width=8,
        priority=tc.PriorityStrategies.explorative_priority), (1, 2), 1,
        "sharded", 2),
    "circle4_sampled": (dict(
        CIRCLE, T_end=STEPS3, optimizer_type=tc.OptimizerType.TpuSampled,
        mcts_n_rollouts=64), (1, 2), 1, "sharded", 2),
    "circle4_data_parallel": (dict(CIRCLE, T_end=STEPS3, beam_width=64),
                              (2, 1), 4, "data_parallel", 2),
}
# the cells of tests/test_sharded.py, run by the JAX package too: cell ->
# the cell whose configuration and batch it shares (one reference run)
REFERENCE_CELLS = {"circle4": "circle4", "cr4_hdv_1x4": "cr4_hdv_1x4",
                   "cr4_hdv_2x2": "cr4_hdv_1x4"}


def port_config(kw):
    return tc.Config(**kw).validate()


def reference_config(kw):
    def conv(v):
        if isinstance(v, enum.Enum):
            return getattr(jc, type(v).__name__)[v.name]
        if isinstance(v, tc.ManualControlConfig):
            return jc.ManualControlConfig(**vars(v))
        return v
    return jc.Config(**{k: conv(v) for k, v in kw.items()}).validate()


@functools.cache
def world(n_ranks):
    """Each rank's results of every cell of ``n_ranks`` ranks."""
    cells = [(name, port_config(kw), mesh, b, kind)
             for name, (kw, mesh, b, kind, r) in CELLS.items()
             if r == n_ranks]
    return spawn(sharded_runs, n_ranks, (cells,), device="cpu", timeout=600)


def distributed(name):
    """Every rank's (final states, records) of cell ``name``."""
    return [rank[name] for rank in world(CELLS[name][4])]


@functools.cache
def sequential(name):
    kw, _, b, _, _ = CELLS[name]
    return run_experiment_batch(port_config(kw), b, device="cpu")


@functools.cache
def reference(name):
    from pdmpc_tpu.experiment import create_scenario
    from pdmpc_tpu.models.mpa import build_mpa
    from pdmpc_tpu.parallel import sharded as jsh

    kw, _, b, _, _ = CELLS[name]
    cfg = reference_config(kw)
    mpa = build_mpa(cfg)
    mpa_t = mpa.to_tensors_for(cfg)
    sc_t = create_scenario(cfg, mpa).to_tensors()
    mesh = jsh.make_mesh(2, 4)
    run = jsh.make_sharded_run(cfg, mpa_t, sc_t, mesh)
    states = jsh.place_batched_state(
        jsh.batched_initial_state(sc_t, cfg.Hp, b), mesh)
    return jax.block_until_ready(run(states, mpa_t, sc_t))


@pytest.mark.parametrize("name", list(CELLS))
def test_distributed_equals_sequential(name):
    final, infos = distributed(name)[0]
    seq = sequential(name)
    bad = [f for f, got, want in zip(infos._fields, infos, seq.infos)
           if got.dtype != want.dtype or not np.array_equal(got, want)]
    assert bad == [], (name, bad)
    bad = [f for f, got, want in zip(final._fields, final, seq.final_state)
           if not np.array_equal(got, want.numpy())]
    assert bad == [], (name, bad)


@pytest.mark.parametrize("name", list(CELLS))
def test_every_rank_holds_the_same_records(name):
    runs = distributed(name)
    final0, infos0 = runs[0]
    for rank, (final, infos) in enumerate(runs[1:], 1):
        for f, a, b in zip(infos._fields, infos0, infos):
            assert np.array_equal(a, b), (name, rank, f)
        for f, a, b in zip(final._fields, final0, final):
            assert np.array_equal(a, b), (name, rank, f)


@pytest.mark.parametrize("name", REFERENCE_CELLS)
def test_sharded_equals_reference_sharded(name):
    _, infos = distributed(name)[0]
    _, want = reference(REFERENCE_CELLS[name])
    for f in ("trims", "levels", "needs_fallback"):
        np.testing.assert_array_equal(getattr(infos, f),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{name}: {f}")
    np.testing.assert_allclose(infos.poses, np.asarray(want.poses), rtol=0,
                               atol=1e-6, err_msg=name)
