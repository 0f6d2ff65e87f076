"""Optimal and explorative voting in a batch of scenarios, on the CPU.

- cr4 with optimal and with explorative priorities (beam 32, 3 steps),
  ``monte_carlo_sweep`` of three scenarios (1 m of arc): held to the
  reference's ``jax.vmap`` of its run over the same starts with the exact
  gate (every integer and boolean field equal, poses within 1e-4, cost
  within rtol 1e-6), and each entry equal to the port's run of that
  scenario alone in every field. The sweep's scenarios vote different
  rows and, for explorative voting, solve different numbers of shifts.
- The vote's summation under the reference's ``jax.vmap``: XLA:CPU's
  batched one-hot contraction sums each scenario in the order of its run
  alone (at both orders' shapes), so the port votes each scenario with
  the order mapped for one (``controller._vote_lanes``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdmpc_torch.config as tc
import pdmpc_tpu.config as jc
from pdmpc_torch.controller import StepState, make_run
from pdmpc_torch.eval.experiments import monte_carlo_sweep, perturbed_states
from pdmpc_torch.experiment import create_scenario
from pdmpc_torch.models.mpa import build_mpa
from tests.test_torch_hdv import assert_exact

# One intra-op thread per process, as the other port files.
torch.set_num_threads(1)

B, ARC = 3, 1.0
PRIORITIES = ("optimal_priority", "explorative_priority")


def configs(priority):
    kw = dict(amount=4, T_end=0.7, beam_width=32)
    return (tc.Config(priority=tc.PriorityStrategies[priority], **kw),
            jc.Config(priority=jc.PriorityStrategies[priority], **kw))


@functools.cache
def sweeps(priority):
    """(the port's sweep, the reference's vmapped sweep)."""
    from pdmpc_tpu.eval.experiments import monte_carlo_sweep as j_sweep

    tcfg, jcfg = configs(priority)
    return (monte_carlo_sweep(tcfg, B, ARC, device="cpu"),
            j_sweep(jcfg, B, ARC))


@pytest.mark.parametrize("priority", PRIORITIES)
def test_sweep_matches_reference_vmap(priority):
    got, want = sweeps(priority)
    assert got.infos.cost.shape == (B, 3, 4)
    assert_exact(got.infos, want.infos)
    # the entries take different rows of the vote
    chosen = got.infos.priority_permutation
    assert len({chosen[i].tobytes() for i in range(B)}) > 1


@pytest.mark.parametrize("priority", PRIORITIES)
def test_entries_equal_single_runs(priority):
    got = sweeps(priority)[0].infos
    cfg = configs(priority)[0].validate()
    mpa = build_mpa(cfg)
    mpa_t = mpa.to_tensors_for(cfg, "cpu")
    sc_t = create_scenario(cfg, mpa).to_tensors("cpu")
    states = perturbed_states(sc_t, cfg, B, ARC)
    for i in range(B):
        _, alone = make_run(cfg)(StepState(*(x[i:i + 1] for x in states)),
                                 mpa_t, sc_t)
        bad = [f for f, a, x in zip(alone._fields, alone, got)
               if not torch.equal(a[0], torch.as_tensor(x[i]))]
        assert bad == [], (i, bad)
    if priority == "explorative_priority":
        # scenarios with fewer levels take part in fewer shifts
        assert len({int(lv.max()) for lv in got.levels[:, 0]}) > 1


def reference_vote(cost_g, belonging):
    """The reference vote's contraction (controller._vote_per_subgraph):
    one-hot matmul at Precision.HIGHEST, rounded to 8 decimals."""
    n = cost_g.shape[0]
    onehot = (belonging[:, None] == jnp.arange(n)[None, :]).astype(
        cost_g.dtype)
    return jnp.round(jnp.matmul(cost_g.T, onehot,
                                precision=jax.lax.Precision.HIGHEST), 8)


@pytest.mark.parametrize("p_cnt", [1, 2, 4, 16, 64, 128])
def test_reference_vmapped_vote_equals_single(p_cnt):
    rng = np.random.default_rng(p_cnt)
    single = jax.jit(reference_vote)
    batched = jax.jit(jax.vmap(reference_vote))
    for n in (3, 4, 5, 8, 12, 17, 20, 33):
        for b in (2, 5):
            cost = (rng.uniform(0, 1, (b, n, p_cnt))
                    * 10.0 ** rng.integers(-3, 3, (b, n, p_cnt))
                    ).astype(np.float32)
            belonging = np.minimum(rng.integers(0, n, (b, n)),
                                   np.arange(n)).astype(np.int32)
            got = np.asarray(batched(cost, belonging))
            for i in range(b):
                np.testing.assert_array_equal(
                    got[i], np.asarray(single(cost[i], belonging[i])),
                    err_msg=f"P={p_cnt} N={n} B={b} entry {i}")
