"""Coupling-graph algebra: leveling, priorities, weights, cutting,
components and fallback propagation.

Torch twin of pdmpc_tpu/parallel/graph.py (all but the host-side
``unique_priorities_np``): integer/boolean matrix algebra on [N, N]
tensors; ``fori_loop``s become Python loops. What the step calls also
takes leading scenario dims ([B, N, N]), planning each scenario as the
reference's vmap does. The random strategies draw with
``pdmpc_torch.prng``, bit-equal to the reference's ``jax.random``; one
draw a step serves every scenario, since its key depends on the seed and
the step only.
"""

from __future__ import annotations

import torch

from pdmpc_torch import prng
from pdmpc_torch.ops.geometry import fma


def kahn_levels(directed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Computation level (1-based) of each vehicle from a sequential DAG.

    directed: [..., N, N] bool, entry (i, j) = edge i -> j (leading dims
    batch independent graphs). Returns (levels [..., N] i64, is_dag bool
    [...]). Vertices stuck in a cycle keep level 0.
    Reference: utility/kahn.m:1-24.
    """
    n = directed.shape[-1]
    a = directed.to(torch.int64)
    levels = torch.zeros(directed.shape[:-1], dtype=torch.int64,
                         device=directed.device)
    sorted_mask = torch.zeros_like(levels, dtype=torch.bool)
    for current in range(1, n + 1):
        sources = ~sorted_mask & (a.sum(dim=-2) == 0)
        levels = torch.where(sources, current, levels)
        a = torch.where(sources[..., :, None], 0, a)
        sorted_mask = sorted_mask | sources
    return levels, sorted_mask.all(dim=-1)


def number_of_computation_levels(directed: torch.Tensor) -> torch.Tensor:
    """Reference: IterationData.m:87-89."""
    return kahn_levels(directed)[0].max()


def directed_coupling_from_priorities(adjacency: torch.Tensor,
                                      priorities: torch.Tensor
                                      ) -> torch.Tensor:
    """Edge i -> j kept iff coupled and priorities[i] < priorities[j]
    (smaller value plans first). Reference: Prioritizer.m:64-77. Leading
    dims batch scenarios."""
    return adjacency.bool() & (priorities[..., :, None]
                               < priorities[..., None, :])


def ranks_of(order: torch.Tensor) -> torch.Tensor:
    """Priorities 1..N from vehicle orders [..., N]: ``order[..., r]``
    gets r + 1."""
    rank = torch.arange(1, order.shape[-1] + 1, dtype=order.dtype,
                        device=order.device)
    return torch.empty_like(order).scatter_(-1, order,
                                            rank.expand_as(order))


def priorities_from_directed_coupling(directed: torch.Tensor) -> torch.Tensor:
    """Priorities (1..N) from a DAG in (Kahn level, vehicle index) order, a
    stable topological order. Reference: Prioritizer.m:79-95."""
    n = directed.shape[0]
    levels, _ = kahn_levels(directed)
    key = levels * n + torch.arange(n, device=directed.device)
    return ranks_of(torch.argsort(key))                  # keys are distinct


def constant_priorities(n: int, device=None) -> torch.Tensor:
    """priority = vehicle index. Reference: ConstantPrioritizer.m."""
    return torch.arange(1, n + 1, dtype=torch.int64, device=device)


def random_priorities(n: int, time_step: int, seed: int = 0,
                      device=None) -> torch.Tensor:
    """Random permutation of 1..N seeded by the time step: the permutation
    of ``fold_in(PRNGKey(seed), time_step)`` (RandomPrioritizer.m; the
    reference's ``jax.random.permutation``, bit for bit).

    N numbers a step: drawn on the host, where the threefry pass costs no
    kernel launches, and moved to ``device`` once."""
    key = prng.fold_in(prng.prng_key(seed), time_step)
    return prng.permutation(key, torch.arange(1, n + 1)).to(device)


def coloring_priorities(adjacency: torch.Tensor) -> torch.Tensor:
    """Graph-coloring priorities minimizing the number of computation
    levels (ColoringPrioritizer.m:31-151): greedy coloring in SDO/LDO
    vertex order, then the colors (levels) ordered by descending largest
    member degree. Returns each vehicle's level rank as its priority
    [..., N] (leading dims: scenarios, each colored on its own).

    Runs on the host, a Python loop over each [N, N] matrix: once a step,
    and every tie breaks where the JAX function's does (``jnp.argmax`` and
    ``jnp.argmin`` take the first extremum, the stable level sort keeps
    the color order), spelled out here instead of left to a device's
    argmax. The batch's adjacency is copied to the host once; the result
    goes back to the adjacency's device.
    """
    n = adjacency.shape[-1]
    batch = adjacency.bool().cpu().reshape(-1, n, n).tolist()
    ranks = [_coloring_ranks(adj) for adj in batch]
    return torch.tensor(ranks, dtype=torch.int64).reshape(
        adjacency.shape[:-1]).to(adjacency.device)


def _coloring_ranks(adj: list[list[bool]]) -> list[int]:
    """``coloring_priorities`` of one adjacency given as nested lists."""
    n = len(adj)
    degree = [sum(row[j] for row in adj) for j in range(n)]
    color = [1 if d == 0 else 0 for d in degree]       # isolated: color 1
    for _ in range(n):
        if all(color):
            break
        # saturation degree: distinct colors among the neighbors
        neigh = [{color[j] for j in range(n) if adj[i][j] and color[j]}
                 for i in range(n)]
        # max saturation, then max degree, then the lowest index
        score = [len(neigh[i]) * (n + 1) + degree[i] if not color[i] else -1
                 for i in range(n)]
        v = score.index(max(score))
        color[v] = next(c for c in range(1, n + 1) if c not in neigh[v])
    # levels ordered by descending largest member degree, ties by color
    level_deg = {c: max(degree[i] for i in range(n) if color[i] == c)
                 for c in set(color)}
    order = sorted(level_deg, key=lambda c: (-level_deg[c], c))
    rank = {c: r + 1 for r, c in enumerate(order)}
    return [rank[c] for c in color]


def constant_weights(directed: torch.Tensor) -> torch.Tensor:
    """Reference: ConstantWeigher.m (weight 0.5 on every edge)."""
    return directed.to(torch.float32) * 0.5


def random_weights(directed: torch.Tensor, time_step: int,
                   seed: int = 0) -> torch.Tensor:
    """Uniform weights on [0, 1) of the directed edges, seeded by the time
    step: ``uniform(fold_in(PRNGKey(seed ^ 0x5EED), time_step), [N, N])``
    (RandomWeigher.m; the reference's ``jax.random.uniform``, bit for bit).

    N x N numbers a step: drawn on the host and moved to the graph's device
    once, as ``random_priorities``; the one draw weighs every scenario of
    a batch ``directed`` [..., N, N]."""
    key = prng.fold_in(prng.prng_key(seed ^ 0x5EED), time_step)
    w = prng.uniform(key, tuple(directed.shape[-2:])).to(directed.device)
    return torch.where(directed.bool(), w, torch.zeros_like(w))


def distance_weights(directed: torch.Tensor, positions: torch.Tensor,
                     max_mpa_speed, dt: float, hp: int) -> torch.Tensor:
    """weight = 1 - d / d_max with d_max = 2 * v_max * dt * Hp.
    Reference: DistanceWeigher.m."""
    d = pairwise_distances(positions)
    max_distance = 2.0 * max_mpa_speed * dt * hp
    w = 1.0 - d / max_distance
    return torch.where(directed.bool(), w, torch.zeros_like(w))


def pairwise_distances(positions: torch.Tensor) -> torch.Tensor:
    """[..., N, N] distances between positions [..., N, 2], as XLA:CPU
    evaluates ``jnp.linalg.norm`` of the differences: sqrt(fma(dy, dy,
    dx * dx))."""
    diff = positions[..., :, None, :] - positions[..., None, :, :]
    return torch.sqrt(fma(diff[..., 1], diff[..., 1],
                          diff[..., 0] * diff[..., 0]))


def greedy_cut(weighted_directed: torch.Tensor, max_num_cls: int,
               n_vehicles: int) -> torch.Tensor:
    """Partition into <= max_num_cls computation levels by greedily
    sequentializing edges in descending weight order while the leveling
    stays within the bound. Reference: cut/GreedyCutter.m:25-90; the
    incremental longest-path bookkeeping is pdmpc_tpu's.

    Edges are weight != 0 (distance weights go negative beyond d_max and
    stay edges). Leading dims batch scenarios, each cut on its own.
    Returns directed_coupling_sequential [..., N, N] bool. The edge loop
    reads a longest path at every edge, so it runs on one host copy of
    the batch's weights and the result goes back to their device.
    """
    directed = weighted_directed != 0.0
    if max_num_cls >= n_vehicles:
        return directed
    if max_num_cls <= 1:
        return torch.zeros_like(directed)
    n = weighted_directed.shape[-1]
    host = weighted_directed.cpu().reshape(-1, n, n)
    seq = torch.stack([_greedy_cut_one(w, max_num_cls) for w in host])
    return seq.reshape(directed.shape).to(directed.device)


def _greedy_cut_one(weighted_directed: torch.Tensor,
                    max_num_cls: int) -> torch.Tensor:
    """``greedy_cut`` of one [N, N] weight matrix on the host."""
    n = weighted_directed.shape[0]
    flat_w = weighted_directed.reshape(-1)
    is_edge = flat_w != 0.0
    m = int(is_edge.sum())
    order = torch.sort(
        torch.where(is_edge, -flat_w, torch.full_like(flat_w, torch.inf)),
        stable=True,
    ).indices
    # reach[u, v] = #edges on the longest accepted path u -> v (0 on the
    # diagonal, "none" otherwise); accepting (r, c) only lengthens chains
    # through it
    none = -n * 4
    reach = torch.full((n, n), none, dtype=torch.int64)
    reach.fill_diagonal_(0)
    seq = torch.zeros((n, n), dtype=torch.bool)
    for e in order[:m].tolist():
        r, c = divmod(e, n)
        up = int(reach[:, r].max())
        down = int(reach[c, :].max())
        if up + 1 + down + 1 <= max_num_cls:       # levels = edges + 1
            via = reach[:, r][:, None] + 1 + reach[c, :][None, :]
            reach = torch.maximum(reach, via)
            seq[r, c] = True
    return seq


def weak_components(directed: torch.Tensor) -> torch.Tensor:
    """Weakly-connected component labels [..., N] i64 of graphs
    [..., N, N] (leading dims batch scenarios): each vertex carries the
    smallest vertex index of its component (min-label propagation; the
    conncomp of PrioritizedExplorativeController.m:206)."""
    n = directed.shape[-1]
    sym = directed.bool() | directed.bool().mT
    labels = torch.arange(n, device=directed.device).expand(
        directed.shape[:-1])
    for _ in range(n):
        neigh = torch.where(sym, labels[..., None, :], n)
        labels = torch.minimum(labels, neigh.amin(dim=-1))
    return labels


def fallback_closure(fallbacks: torch.Tensor, adjacency: torch.Tensor,
                     sequential: torch.Tensor) -> torch.Tensor:
    """Propagate fallbacks through the coupling graph minus the sequential
    edges out of falling-back vehicles (their predictions were consumed).
    Reference: PrioritizedController.check_others_fallback (:650-674).
    Returns the closed fallback vector [..., N] bool (leading dims batch
    scenarios).
    """
    n = adjacency.shape[-1]
    adj = adjacency.bool()
    outgoing = sequential.bool() & fallbacks[..., :, None]
    fb_matrix = adj & ~(outgoing | outgoing.mT)
    reach = fallbacks
    for _ in range(n):
        reach = reach | torch.any(fb_matrix & reach[..., :, None], dim=-2)
    return reach
