"""Scenario batches of the step's state.

Torch twin of pdmpc_tpu/parallel/sharded.py's ``batched_initial_state``:
the state of B scenarios with a leading scenario dim, which the batched
step (``controller.make_prioritized_step``) takes. The mesh runs over
vehicles and scenarios come with the distributed backend.
"""

from __future__ import annotations

from pdmpc_torch.controller import StepState, initial_state
from pdmpc_torch.scenarios.scenario import ScenarioTensors


def batched_initial_state(scenario: ScenarioTensors, hp: int,
                          batch: int) -> StepState:
    """``initial_state`` of ``scenario`` for ``batch`` identical scenarios:
    every field [batch, ...] (a copy, so a caller may overwrite one
    scenario's start)."""
    state0 = initial_state(scenario, hp)
    return StepState(*(x[None].expand(batch, *x.shape).clone()
                       for x in state0))
