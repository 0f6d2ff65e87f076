"""Controller modes of the port end to end on the CPU.

- The matrix goldens of tests/test_matrix.py that are deterministic and
  run in seconds: ``mx01`` (road, coloring priorities, constant weights),
  ``mx07`` (road, no coupling, explorative priorities) and ``mx08``
  (circle, distance coupling, FCA priorities, constant weights), each
  exact through ``tests.golden.compare_golden`` (trims, fallback pattern
  and levels equal, poses within 1e-4) with cost within rtol 1e-6, and
  collision-free. ``mx06`` (optimal priorities on the realistic MPA, some
  two minutes on one CPU core, ``slow`` in pdmpc_tpu) is held on the
  card by chip_smoke.py phase 11.
- Configurations with no golden, each run for a few steps through both
  packages from the same scenario and compared field by field (every
  integer and boolean field of the step record equal, poses within 1e-4,
  cost within rtol 1e-6): the successor constraints
  ``area_of_previous_trajectory`` and ``none``, parallel avoidance by
  previous plans (``isDealPredictionInconsistency=False``), a circle with
  static obstacles in the vehicles' way (as tests/test_obstacles.py builds
  them), FCA priorities with distance coupling on the road, and optimal
  (8 orientations a step) and explorative (3 level shifts a step)
  priorities with full coupling on the circle.
"""

import enum

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdmpc_torch.config as tc
import pdmpc_tpu.config as jc
from pdmpc_torch import controller as tctl
from pdmpc_torch.experiment import create_scenario, run_experiment
from pdmpc_torch.models.mpa import build_mpa
from pdmpc_torch.parallel.sharded import batched_initial_state
from tests.golden import compare_golden, golden_path
from tests.test_controller import pairwise_vehicle_collisions

# One intra-op thread per process (see tests/test_torch_system.py).
torch.set_num_threads(1)

S, M, Co, P, W = (tc.ScenarioType, tc.MpaType, tc.CouplingStrategies,
                  tc.PriorityStrategies, tc.WeightStrategies)
CS = tc.ConstraintFromSuccessor

# tests/test_matrix.py's cells, at its scale (3 vehicles, T_end 1 s,
# beam 64)
GOLDENS = {
    "mx01": (S.commonroad, M.single_speed, Co.reachable_set_coupling,
             P.coloring_priority, W.constant_weight),
    "mx07": (S.commonroad, M.single_speed, Co.no_coupling,
             P.explorative_priority, W.distance_weight),
    "mx08": (S.circle, M.single_speed, Co.distance_coupling,
             P.FCA_priority, W.constant_weight),
}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_matrix_golden(name):
    sc, mpa, co, pr, w = GOLDENS[name]
    res = run_experiment(tc.Config(
        scenario_type=sc, amount=3, T_end=1.0, beam_width=64, mpa_type=mpa,
        coupling=co, priority=pr, weight=w, mcts_n_rollouts=128),
        device="cpu")
    compare_golden(name, res)
    with np.load(golden_path(name)) as g:
        np.testing.assert_allclose(res.infos.cost, g["cost"], rtol=1e-6,
                                   atol=1e-6)
    assert pairwise_vehicle_collisions(res) == []
    if pr == P.explorative_priority:
        for prios in res.infos.priorities:
            assert sorted(prios.tolist()) == [1, 2, 3]


def square(cx, cy, half):
    return np.array([[cx - half, cy - half], [cx + half, cy - half],
                     [cx + half, cy + half], [cx - half, cy + half]],
                    dtype=np.float32)


def both_configs(kw):
    def conv(module):
        return {k: (getattr(module, type(v).__name__)[v.name]
                    if isinstance(v, enum.Enum) else v)
                for k, v in kw.items()}
    return tc.Config(**conv(tc)).validate(), jc.Config(**conv(jc)).validate()


def run_both(kw, obstacles=()):
    """The step records of both packages' prioritized steps over k_end
    steps of the same scenario (``obstacles`` added as static ones)."""
    from pdmpc_tpu import controller as jctl
    from pdmpc_tpu.experiment import create_scenario as j_create
    from pdmpc_tpu.models.mpa import build_mpa as j_build

    tcfg, jcfg = both_configs(kw)
    jm = j_build(jcfg)
    jsc = j_create(jcfg, jm)
    jsc.obstacles = list(obstacles)
    jst = jsc.to_tensors()
    step = jax.jit(jctl.make_prioritized_step(jcfg, jm.to_tensors_for(jcfg),
                                              jst))
    state, want = jctl.initial_state(jst, jcfg.Hp), []
    for k in range(jcfg.k_end):
        state, info = step(state, jnp.int32(k))
        want.append(jax.tree.map(np.asarray, info))

    tm = build_mpa(tcfg)
    tsc = create_scenario(tcfg, tm)
    tsc.obstacles = list(obstacles)
    tst = tsc.to_tensors("cpu")
    step = tctl.make_prioritized_step(tcfg, tm.to_tensors_for(tcfg, "cpu"),
                                      tst)
    state, got = batched_initial_state(tst, tcfg.Hp, 1), []
    for k in range(tcfg.k_end):
        state, info = step(state, k)
        got.append(tctl.infos_to_numpy(tctl.StepInfo(*(x[0] for x in info))))
    return got, want


EXACT = ("trims", "needs_fallback", "is_exhausted", "n_expanded",
         "adjacency", "directed_coupling", "directed_sequential", "levels",
         "priorities", "priority_permutation")

# name -> (configuration, static obstacles)
VARIANTS = {
    "previous_trajectory": (dict(
        amount=3, T_end=0.6, beam_width=64,
        constraint_from_successor=CS.area_of_previous_trajectory), ()),
    "no_successor_constraint": (dict(
        amount=3, T_end=0.6, beam_width=64,
        constraint_from_successor=CS.none), ()),
    "previous_plans_avoided": (dict(
        scenario_type=S.circle, amount=3, T_end=1.0, beam_width=64,
        isDealPredictionInconsistency=False), ()),
    # vehicle 0 starts at (0.25, 2.0) heading +x, vehicle 1 at (4.25, 2.0)
    # heading -x: a square on each path, and one off them
    "static_obstacles": (dict(
        scenario_type=S.circle, amount=2, T_end=1.6, beam_width=64),
        (square(0.8, 2.0, 0.06), square(3.7, 2.02, 0.05),
         square(2.25, 3.0, 0.1))),
    "fca_distance_road": (dict(
        amount=3, T_end=0.6, beam_width=64,
        coupling=Co.distance_coupling, priority=P.FCA_priority), ()),
    "optimal_full_circle": (dict(
        scenario_type=S.circle, amount=3, T_end=0.6, beam_width=64,
        coupling=Co.full_coupling, priority=P.optimal_priority,
        max_priority_permutations=8), ()),
    "explorative_full_circle": (dict(
        scenario_type=S.circle, amount=3, T_end=0.6, beam_width=64,
        coupling=Co.full_coupling, priority=P.explorative_priority), ()),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_matches_reference_step_by_step(name):
    kw, obstacles = VARIANTS[name]
    got, want = run_both(kw, obstacles)
    for k, (g, w) in enumerate(zip(got, want)):
        for f in EXACT:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f"step {k}: {f}")
        np.testing.assert_allclose(g.poses, w.poses, atol=1e-4,
                                   err_msg=f"step {k}: poses")
        np.testing.assert_allclose(g.cost, w.cost, rtol=1e-6, atol=1e-6,
                                   err_msg=f"step {k}: cost")
    if obstacles:
        # the planned areas keep clear of every static obstacle
        from pdmpc_torch.ops.search import _sat_separates_batch

        shapes = torch.as_tensor(np.stack([g.shapes for g in got]))
        for obs in obstacles:
            apart = _sat_separates_batch(shapes, torch.as_tensor(obs))
            assert apart.all(), name
        # and the first square is in vehicle 0's way: its plans bend
        y0 = np.stack([g.poses[0, :, 1] for g in got])
        assert np.abs(y0 - 2.0).max() > 0.01
