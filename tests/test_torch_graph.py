"""pdmpc_torch.parallel.graph against pdmpc_tpu.parallel.graph, bit-exact
for every integer and boolean result, on random weighted DAGs (negative
weights included, as distance weights beyond d_max are), plus the
controller's compact schedule and unique compaction against their JAX
twins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdmpc_torch import controller as tctl
from pdmpc_torch.parallel import graph as tg
from pdmpc_tpu import controller as jctl
from pdmpc_tpu.parallel import graph as jg

# One intra-op thread per process: the suite runs in several pytest
# workers at once, and a full torch thread pool in each of them
# oversubscribes the cores (a file that takes seconds alone then takes
# minutes).
torch.set_num_threads(1)


def random_dag(rng, n, density):
    """Symmetric coupling, a random priority permutation, the DAG it
    induces, and weights in [-1, 1] (never exactly 0) on its edges."""
    upper = np.triu(rng.random((n, n)) < density, 1)
    adj = upper | upper.T
    prio = rng.permutation(n) + 1
    directed = adj & (prio[:, None] < prio[None, :])
    w = rng.uniform(-1, 1, size=(n, n)).astype(np.float32)
    w[w == 0] = 0.5
    return adj, prio, directed, np.where(directed, w, 0).astype(np.float32)


CASES = [(n, d, s) for s, (n, d) in enumerate(
    [(3, 0.8), (8, 0.4), (12, 0.6), (20, 0.2), (20, 0.5)])]


@pytest.mark.parametrize("n,density,seed", CASES)
def test_graph_algebra(n, density, seed):
    rng = np.random.default_rng(seed)
    adj, prio, directed, weights = random_dag(rng, n, density)
    t = torch.tensor

    np.testing.assert_array_equal(
        tg.directed_coupling_from_priorities(t(adj), t(prio)).numpy(),
        np.asarray(jg.directed_coupling_from_priorities(
            jnp.asarray(adj), jnp.asarray(prio))))
    np.testing.assert_array_equal(tg.constant_priorities(n).numpy(),
                                  np.asarray(jg.constant_priorities(n)))

    lv_t, dag_t = tg.kahn_levels(t(directed))
    lv_j, dag_j = jg.kahn_levels(jnp.asarray(directed))
    np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j))
    assert bool(dag_t) == bool(dag_j)

    for max_cls in sorted({1, 2, 3, n // 2, n}):
        seq_t = tg.greedy_cut(t(weights), max_cls, n)
        seq_j = jg.greedy_cut(jnp.asarray(weights), max_cls, n)
        np.testing.assert_array_equal(seq_t.numpy(), np.asarray(seq_j),
                                      err_msg=f"max_num_cls={max_cls}")
        levels = np.asarray(jg.kahn_levels(seq_j)[0])
        fb = rng.random(n) < 0.2
        np.testing.assert_array_equal(
            tg.fallback_closure(t(fb), t(adj), seq_t).numpy(),
            np.asarray(jg.fallback_closure(jnp.asarray(fb), jnp.asarray(adj),
                                           seq_j)))
        for c_chunk in (1, 2, 3):
            sched_t, n_t = tctl.compact_schedule(t(levels), c_chunk, seq_t)
            sched_j, n_j = jctl.compact_schedule(jnp.asarray(levels),
                                                 c_chunk, seq_j)
            assert n_t == int(n_j)
            np.testing.assert_array_equal(sched_t.numpy(),
                                          np.asarray(sched_j))

    # distance weights are floats: within rtol 1e-6. Both compute the norm
    # as sqrt(fma(dy, dy, dx * dx)), but XLA:CPU's vectorized f32 square
    # root is one ulp above the rounded one for some 0.7% of inputs (an
    # ulp of the distance); which pairs are edges is exact
    pos = rng.uniform(0, 4, size=(n, 2)).astype(np.float32)
    w_t = tg.distance_weights(t(directed), t(pos), t(np.float32(0.8)), 0.2,
                              6).numpy()
    w_j = np.asarray(jg.distance_weights(jnp.asarray(directed),
                                         jnp.asarray(pos), jnp.float32(0.8),
                                         0.2, 6))
    np.testing.assert_allclose(w_t, w_j, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(w_t != 0, w_j != 0)


def strategy_graph(kind, n, seed):
    """Symmetric coupling graphs of the prioritizers' inputs."""
    rng = np.random.default_rng(seed)
    if kind == "isolated":            # a few edges, most vertices alone
        upper = np.zeros((n, n), dtype=bool)
        upper[0, 1] = upper[2, 4] = True
    elif kind == "complete":
        upper = np.ones((n, n), dtype=bool)
    elif kind == "bipartite":
        side = rng.random(n) < 0.5
        upper = (side[:, None] != side[None, :]) & (rng.random((n, n)) < 0.7)
    elif kind == "dense":             # cr20-sized, as full coupling nears
        upper = rng.random((n, n)) < 0.8
    else:
        upper = rng.random((n, n)) < 0.25
    upper = np.triu(upper, 1)
    return upper | upper.T


GRAPHS = [("isolated", 9, 0), ("complete", 6, 1), ("bipartite", 10, 2),
          ("bipartite", 20, 3), ("dense", 20, 4), ("random", 12, 5),
          ("random", 20, 6), ("random", 3, 7)]


@pytest.mark.parametrize("kind,n,seed", GRAPHS)
def test_strategy_graph_algebra(kind, n, seed):
    """coloring_priorities, weak_components, priorities_from_directed_
    coupling, number_of_computation_levels and constant_weights equal
    their JAX twins exactly."""
    adj = strategy_graph(kind, n, seed)
    t = torch.as_tensor
    colors = tg.coloring_priorities(t(adj))
    np.testing.assert_array_equal(
        colors.numpy(),
        np.asarray(jax.jit(jg.coloring_priorities)(jnp.asarray(adj))))
    # a coloring: coupled vehicles never share a level
    assert not (adj & (colors.numpy()[:, None] == colors.numpy()[None])).any()
    directed = tg.directed_coupling_from_priorities(t(adj), colors).numpy()
    for graph in (adj, directed):
        np.testing.assert_array_equal(
            tg.weak_components(t(graph)).numpy(),
            np.asarray(jax.jit(jg.weak_components)(jnp.asarray(graph))))
    np.testing.assert_array_equal(
        tg.priorities_from_directed_coupling(t(directed)).numpy(),
        np.asarray(jax.jit(jg.priorities_from_directed_coupling)(
            jnp.asarray(directed))))
    assert (int(tg.number_of_computation_levels(t(directed))) == int(
        jax.jit(jg.number_of_computation_levels)(jnp.asarray(directed))))
    w_t = tg.constant_weights(t(directed))
    w_j = np.asarray(jg.constant_weights(jnp.asarray(directed)))
    assert w_t.dtype == torch.float32
    np.testing.assert_array_equal(w_t.numpy(), w_j)


def test_kahn_levels_batched():
    """Kahn levels of a stack of graphs equal each graph's own."""
    rng = np.random.default_rng(11)
    stack = np.stack([random_dag(rng, 7, 0.5)[2] for _ in range(4)])
    stack[1, 3, 2] = stack[1, 2, 3] = True                  # a cycle
    lv, dag = tg.kahn_levels(torch.as_tensor(stack))
    for p in range(4):
        lv_j, dag_j = jg.kahn_levels(jnp.asarray(stack[p]))
        np.testing.assert_array_equal(lv[p].numpy(), np.asarray(lv_j))
        assert bool(dag[p]) == bool(dag_j)


def test_kahn_cycle():
    a = np.zeros((3, 3), dtype=bool)
    a[0, 1] = a[1, 0] = True
    lv_t, dag_t = tg.kahn_levels(torch.as_tensor(a))
    lv_j, dag_j = jg.kahn_levels(jnp.asarray(a))
    np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j))
    assert not bool(dag_t) and not bool(dag_j)


def test_unique_padded():
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 6, size=(64, 7))
    want = np.stack([np.asarray(jnp.unique(jnp.asarray(r), size=8,
                                           fill_value=0)) for r in ids])
    got = tctl._unique_padded(torch.as_tensor(ids), 8)
    np.testing.assert_array_equal(got.numpy(), want)
