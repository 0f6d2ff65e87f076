"""Batched rollouts of cr6 with random priorities and weights (B = 3): the
port's ``monte_carlo_sweep`` held to the reference's vmapped run with the
exact gate, and each entry to the port's single run from its start
(tests/test_torch_batch.py holds the other cells and says how; each road
cell has a file of its own, so the cells run in parallel workers)."""

import torch

from tests.test_torch_batch import (
    assert_entries_equal_single_runs,
    assert_sweep_matches_reference,
)

# One intra-op thread per process, as the other port files.
torch.set_num_threads(1)


def test_sweep_matches_reference_vmap():
    assert_sweep_matches_reference("cr6_random")


def test_entries_equal_single_runs():
    assert_entries_equal_single_runs("cr6_random")
