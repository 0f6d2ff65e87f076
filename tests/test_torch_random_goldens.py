"""The matrix goldens with random strategies or the sampled search, run by
the port on the CPU.

tests/test_matrix.py's cells that draw random numbers, at its scale (3
vehicles, T_end 1 s, beam 64, 128 rollouts), through ``run_experiment``
and ``tests.golden.compare_golden`` (trims, fallback pattern and levels
equal, poses within 1e-4) with the cost within rtol 1e-6, and
collision-free:

- ``mx03``, ``mx10`` and ``mx13`` draw random priorities or weights, only
  integers and exact uniforms (``pdmpc_torch.prng`` is bit-equal to
  ``jax.random``), so they must match exactly. ``mx11`` (random
  priorities on the realistic MPA with full coupling) takes some two
  minutes on one CPU thread and is held on the card (chip_smoke.py phase
  15), as ``mx06`` is.
- ``mx02``, ``mx04``, ``mx05``, ``mx09``, ``mx12`` and ``mx14`` run the
  sampled search, whose Gumbel noise goes through torch's f32 ``log``, an
  ulp from XLA's in about a quarter of the values. A draw can only change
  where the two best (noise + logit) sums of a rollout lie within those
  ulps; ``test_draws_part_only_at_near_ties`` checks that over every
  draw of two cells. All six match their goldens exactly here; should one
  part, the test names the first draw that differs and requires it to be
  such a near tie (top-two gap below 4 ulps of the sum), then holds the
  cell to bench.py's gate (same fallback pattern, total cost within
  1%).
"""

import numpy as np
import pytest
import torch

import pdmpc_torch.config as tc
from pdmpc_torch.experiment import run_experiment
from tests.golden import compare_golden, golden_path
from tests.test_controller import pairwise_vehicle_collisions

# One intra-op thread per process (see tests/test_torch_system.py).
torch.set_num_threads(1)

S, M, Co, P, W, O = (tc.ScenarioType, tc.MpaType, tc.CouplingStrategies,
                     tc.PriorityStrategies, tc.WeightStrategies,
                     tc.OptimizerType)

CELLS = {
    "mx02": (S.circle, M.single_speed, O.TpuSampled, Co.full_coupling,
             P.constant_priority, W.random_weight),
    "mx03": (S.commonroad, M.triple_speed, O.TpuOptimal,
             Co.distance_coupling, P.random_priority, W.distance_weight),
    "mx04": (S.circle, M.triple_speed, O.TpuSampled, Co.no_coupling,
             P.coloring_priority, W.constant_weight),
    "mx05": (S.commonroad, M.realistic, O.TpuSampled,
             Co.reachable_set_coupling, P.FCA_priority, W.random_weight),
    "mx09": (S.commonroad, M.triple_speed, O.TpuSampled, Co.full_coupling,
             P.explorative_priority, W.constant_weight),
    "mx10": (S.circle, M.triple_speed, O.TpuOptimal,
             Co.reachable_set_coupling, P.optimal_priority, W.random_weight),
    "mx12": (S.circle, M.realistic, O.TpuSampled, Co.distance_coupling,
             P.constant_priority, W.distance_weight),
    "mx13": (S.mixed, M.single_speed, O.TpuOptimal,
             Co.reachable_set_coupling, P.random_priority, W.distance_weight),
    "mx14": (S.mixed, M.triple_speed, O.TpuSampled, Co.full_coupling,
             P.coloring_priority, W.constant_weight),
}
SAMPLED = sorted(n for n, c in CELLS.items() if c[2] == O.TpuSampled)
# ulps of a (noise + logit) sum within which two draws count as tied
NEAR_TIE_ULPS = 4


def config(name):
    sc, mpa, opt, co, pr, w = CELLS[name]
    return tc.Config(scenario_type=sc, amount=3, T_end=1.0, beam_width=64,
                     mpa_type=mpa, optimizer_type=opt, coupling=co,
                     priority=pr, weight=w, mcts_n_rollouts=128)


def hold_exact(name, res):
    compare_golden(name, res)
    with np.load(golden_path(name)) as g:
        np.testing.assert_allclose(res.infos.cost, g["cost"], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("name", sorted(set(CELLS) - set(SAMPLED)))
def test_random_strategy_golden_exact(name):
    res = run_experiment(config(name), device="cpu")
    hold_exact(name, res)
    assert pairwise_vehicle_collisions(res) == []


def draw_differences(name):
    """Every rollout draw of the port's run of a sampled cell whose
    Gumbel-max choice differs between torch's noise and the reference's
    (``jax.random.gumbel`` from the same keys), on the same logits:
    (step, vehicle, layer, rollout, top-two gap of the reference's sums in
    ulps). Records each search layer's logits and noise rows in the run."""
    import jax

    import pdmpc_torch.controller as ctl
    from pdmpc_torch.ops import search as ts

    cfg = config(name)
    step = {}
    layers = []
    draw_noise, plan, logits_of = (ctl.rollout_noise,
                                   ctl.plan_trajectory_sampled,
                                   ts.policy_logits)

    def noise_of_step(seed, k, *args):
        step["k"], step["noise"] = k, draw_noise(seed, k, *args)
        return step["noise"]

    def recording(*args, **kw):
        noise = args[7]                                    # [V, Hp, R, n]
        ids = [int((step["noise"] == row).flatten(1).all(1).nonzero()[0])
               for row in noise]
        layer = []

        def logits(*a):
            out = logits_of(*a)
            layers.append((step["k"], ids, len(layer), out,
                           noise[:, len(layer)]))
            layer.append(None)
            return out

        ts.policy_logits = logits
        try:
            return plan(*args, **kw)
        finally:
            ts.policy_logits = logits_of

    ctl.rollout_noise, ctl.plan_trajectory_sampled = noise_of_step, recording
    try:
        run_experiment(cfg, device="cpu")
    finally:
        ctl.rollout_noise, ctl.plan_trajectory_sampled = draw_noise, plan

    hp, shape = cfg.Hp, tuple(layers[0][4].shape[1:])            # (R, n)

    @jax.jit
    def jax_noise(k, i):
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(cfg.seed), k), i)
        return jax.vmap(lambda kk: jax.random.gumbel(kk, shape))(
            jax.random.split(key, hp))

    found = []
    for k, ids, layer, logits, noise in layers:
        for v, i in enumerate(ids):
            ref = np.asarray(jax_noise(k, i))[layer] + logits[v].numpy()
            got = (noise[v] + logits[v]).numpy()
            for r in np.nonzero(ref.argmax(-1) != got.argmax(-1))[0]:
                top = np.sort(ref[r])[-2:]
                gap = (top[1] - top[0]) / np.spacing(np.float32(abs(top[1])))
                found.append((k, i, layer, int(r), float(gap)))
    return found


@pytest.mark.parametrize("name", ["mx02", "mx14"])
def test_draws_part_only_at_near_ties(name):
    """Across a sampled cell's run, a draw with torch's noise differs from
    the draw with the reference's noise only where the reference's two
    best sums lie within NEAR_TIE_ULPS ulps."""
    found = draw_differences(name)
    print(f"{name}: {len(found)} draws differ: {found[:5]}")
    assert all(gap < NEAR_TIE_ULPS for *_, gap in found), found


@pytest.mark.parametrize("name", SAMPLED)
def test_sampled_golden(name):
    res = run_experiment(config(name), device="cpu")
    assert pairwise_vehicle_collisions(res) == []
    try:
        compare_golden(name, res)
        exact = True
    except AssertionError:
        exact = False
    print(f"{name}: exact match {exact}")
    if exact:
        hold_exact(name, res)
        return
    found = draw_differences(name)
    print(f"{name}: first differing draw {found[:1]}")
    assert found and found[0][-1] < NEAR_TIE_ULPS, found[:1]
    with np.load(golden_path(name)) as g:
        assert (res.infos.needs_fallback == g["needs_fallback"]).all()
        cost, ref = float(res.infos.cost.sum()), float(g["cost"].sum())
    assert abs(cost - ref) <= 0.01 * abs(ref)
