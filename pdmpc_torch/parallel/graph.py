"""Coupling-graph algebra (main-path subset): leveling, priorities, weights,
cutting and fallback propagation.

Torch twin of pdmpc_tpu/parallel/graph.py: integer/boolean matrix algebra
on [N, N] tensors; ``fori_loop``s become Python loops.
"""

from __future__ import annotations

import torch

from pdmpc_torch.ops.geometry import fma


def kahn_levels(directed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Computation level (1-based) of each vehicle from a sequential DAG.

    directed: [N, N] bool, entry (i, j) = edge i -> j. Returns (levels [N]
    i64, is_dag bool). Vertices stuck in a cycle keep level 0.
    Reference: utility/kahn.m:1-24.
    """
    n = directed.shape[0]
    a = directed.to(torch.int64)
    levels = torch.zeros((n,), dtype=torch.int64, device=directed.device)
    sorted_mask = torch.zeros((n,), dtype=torch.bool, device=directed.device)
    for current in range(1, n + 1):
        sources = ~sorted_mask & (a.sum(dim=0) == 0)
        levels = torch.where(sources, current, levels)
        a = torch.where(sources[:, None], 0, a)
        sorted_mask = sorted_mask | sources
    return levels, sorted_mask.all()


def directed_coupling_from_priorities(adjacency: torch.Tensor,
                                      priorities: torch.Tensor
                                      ) -> torch.Tensor:
    """Edge i -> j kept iff coupled and priorities[i] < priorities[j]
    (smaller value plans first). Reference: Prioritizer.m:64-77."""
    return adjacency.bool() & (priorities[:, None] < priorities[None, :])


def constant_priorities(n: int, device=None) -> torch.Tensor:
    """priority = vehicle index. Reference: ConstantPrioritizer.m."""
    return torch.arange(1, n + 1, dtype=torch.int64, device=device)


def distance_weights(directed: torch.Tensor, positions: torch.Tensor,
                     max_mpa_speed, dt: float, hp: int) -> torch.Tensor:
    """weight = 1 - d / d_max with d_max = 2 * v_max * dt * Hp.
    Reference: DistanceWeigher.m."""
    diff = positions[:, None, :] - positions[None, :, :]
    # XLA:CPU's norm: sqrt(fma(dy, dy, dx * dx))
    d = torch.sqrt(fma(diff[..., 1], diff[..., 1], diff[..., 0] * diff[..., 0]))
    max_distance = 2.0 * max_mpa_speed * dt * hp
    w = 1.0 - d / max_distance
    return torch.where(directed.bool(), w, torch.zeros_like(w))


def greedy_cut(weighted_directed: torch.Tensor, max_num_cls: int,
               n_vehicles: int) -> torch.Tensor:
    """Partition into <= max_num_cls computation levels by greedily
    sequentializing edges in descending weight order while the leveling
    stays within the bound. Reference: cut/GreedyCutter.m:25-90; the
    incremental longest-path bookkeeping is pdmpc_tpu's.

    Edges are weight != 0 (distance weights go negative beyond d_max and
    stay edges). Returns directed_coupling_sequential [N, N] bool.
    """
    directed = weighted_directed != 0.0
    if max_num_cls >= n_vehicles:
        return directed
    n = weighted_directed.shape[0]
    if max_num_cls <= 1:
        return torch.zeros_like(directed)

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
    reach = torch.full((n, n), none, dtype=torch.int64,
                       device=directed.device)
    reach.fill_diagonal_(0)
    seq = torch.zeros_like(directed)
    for e in order[:m].tolist():
        r, c = divmod(e, n)
        up = int(reach[:, r].max())
        down = int(reach[c, :].max())
        if up + 1 + down + 1 <= max_num_cls:       # levels = edges + 1
            via = reach[:, r][:, None] + 1 + reach[c, :][None, :]
            reach = torch.maximum(reach, via)
            seq[r, c] = True
    return seq


def fallback_closure(fallbacks: torch.Tensor, adjacency: torch.Tensor,
                     sequential: torch.Tensor) -> torch.Tensor:
    """Propagate fallbacks through the coupling graph minus the sequential
    edges out of falling-back vehicles (their predictions were consumed).
    Reference: PrioritizedController.check_others_fallback (:650-674).
    Returns the closed fallback vector [N] bool.
    """
    n = adjacency.shape[0]
    adj = adjacency.bool()
    outgoing = sequential.bool() & fallbacks[:, None]
    fb_matrix = adj & ~(outgoing | outgoing.T)
    reach = fallbacks
    for _ in range(n):
        reach = reach | torch.any(fb_matrix & reach[:, None], dim=0)
    return reach
