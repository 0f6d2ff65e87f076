"""The port's coupling, priority and voting strategies against pdmpc_tpu's
on the same inputs (made from numpy seeds):

- ``_couple`` for every coupling strategy, with and without the
  lanelet-adjacency prefilter, and a pair at exactly the coupling
  distance: adjacency equal;
- ``_fca_priorities`` with touching and side-by-side rectangles: equal;
- the vote totals of ``_vote_per_subgraph`` (one-hot contraction, then
  ``round(., 8)``) at shapes of both of XLA:CPU's summation orders: bit
  equal;
- twins of tests/test_priority_modes.py's TestOptimalEquivalence and
  TestExplorativeVoteNumerics: the same fake ``solve`` fed through the JAX
  function and its port gives equal costs, chosen rows, priorities,
  directed couplings, sequential graphs and levels. The port votes a
  batch of scenarios; these cases give it a batch of one
  (``one_scenario``).
"""

import enum
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdmpc_torch.config as tc
import pdmpc_tpu.config as jc
from pdmpc_torch import controller as tctl
from pdmpc_torch.models.bicycle import VEHICLE_LENGTH, VEHICLE_WIDTH
from pdmpc_torch.ops.search import PlanResult as TPlan
from pdmpc_torch.parallel import graph as tg
from pdmpc_torch.parallel.comm import LocalComm as TComm
from pdmpc_tpu import controller as jctl
from pdmpc_tpu.ops.search import PlanResult as JPlan
from pdmpc_tpu.parallel import graph as jg
from pdmpc_tpu.parallel.comm import LocalComm as JComm

# One intra-op thread per process (see tests/test_torch_system.py).
torch.set_num_threads(1)

F32 = np.float32


def configs(**kw):
    """The same configuration in both packages."""
    def conv(module):
        return {k: (getattr(module, type(v).__name__)[v.name]
                    if isinstance(v, enum.Enum) else v)
                for k, v in kw.items()}
    return tc.Config(**conv(tc)), jc.Config(**conv(jc))


def batch_of_one(solve):
    """A one-scenario fake ``solve`` as the port's batched vote calls it:
    ``solve(directed [1, N, N], scenarios)``, results with the scenario
    dim."""
    def call(directed_p, scenarios=None):
        planned, shapes, sequential, levels = solve(directed_p[0])
        return (TPlan(*(x[None] for x in planned)), shapes[None],
                sequential[None], levels[None])
    return call


def one_scenario(voted):
    """The port's vote of a batch of one without the scenario dim."""
    return (TPlan(*(x[0] for x in voted[0])), *(x[0] for x in voted[1:]))


def convex_polys(rng, n, hp, k=8):
    """[n, hp, k, 2] convex polygons (sorted angles) over the map."""
    centers = rng.uniform(0.5, 4.0, (n, hp, 1, 2))
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, hp, k)), axis=-1)
    r = rng.uniform(0.1, 0.6, (n, hp, 1))
    return (centers + np.stack([r * np.cos(ang), r * np.sin(ang)], -1)
            ).astype(F32)


def couple_inputs(seed, n=10, n_lanelets=12, lp=4):
    """Reachable sets, poses (vehicles 0 and 1 exactly the coupling
    distance apart), the speed and predicted lanelets with a lanelet
    adjacency whose row and column 0 are False."""
    rng = np.random.default_rng(seed)
    rs = convex_polys(rng, n, 6)
    poses = np.concatenate([rng.uniform(0, 4, (n, 2)),
                            rng.uniform(-3, 3, (n, 1))], -1).astype(F32)
    speed = F32(0.5)
    max_d = F32(F32(F32(2.0) * speed) * F32(0.2)) * F32(6)
    poses[0, :2] = (0.0, 0.0)
    poses[1, :2] = (max_d, 0.0)
    pred = rng.integers(0, n_lanelets + 1, (n, lp))
    upper = np.triu(rng.random((n_lanelets + 1,) * 2) < 0.15, 1)
    adj_l = upper | upper.T | np.eye(n_lanelets + 1, dtype=bool)
    adj_l[0, :] = adj_l[:, 0] = False
    pred[1] = pred[0]                  # the exact pair passes the prefilter
    return rs, poses, speed, pred, adj_l


@pytest.mark.parametrize("prefilter", [False, True])
@pytest.mark.parametrize("coupling", list(tc.CouplingStrategies))
def test_couple(coupling, prefilter):
    rs, poses, speed, pred, adj_l = couple_inputs(3)
    tcfg, jcfg = configs(coupling=coupling, amount=rs.shape[0])
    extra_t = extra_j = {}
    if prefilter:
        extra_t = dict(pred_lanelets=torch.as_tensor(pred),
                       adjacency_lanelets=torch.as_tensor(adj_l))
        extra_j = dict(pred_lanelets=jnp.asarray(pred),
                       adjacency_lanelets=jnp.asarray(adj_l))
    got = tctl._couple(tcfg, torch.as_tensor(rs), torch.as_tensor(poses),
                       torch.as_tensor(speed), **extra_t).numpy()
    want = np.asarray(jax.jit(lambda r, p, s, **e: jctl._couple(
        jcfg, r, p, s, **e))(jnp.asarray(rs), jnp.asarray(poses),
                             jnp.asarray(speed), **extra_j))
    np.testing.assert_array_equal(got, want)
    assert (got == got.T).all() and not got.diagonal().any()
    if coupling == tc.CouplingStrategies.distance_coupling:
        assert got[0, 1]                       # d == max_distance couples
        if prefilter:
            # the prefilter drops pairs the distance alone would couple
            plain = tctl._couple(tcfg, torch.as_tensor(rs),
                                 torch.as_tensor(poses),
                                 torch.as_tensor(speed)).numpy()
            assert (plain & ~got).any()
    if coupling == tc.CouplingStrategies.reachable_set_coupling:
        assert 0 < got.sum() < got.size - got.shape[0]


def fca_ref_points(seed, n=6, hp=6):
    """Reference points [n, hp, 2]: vehicles 0 and 1 on the x axis with
    rectangles (offset included) touching end to end at step 0, vehicle 2
    beside vehicle 0 touching side by side, the rest random straight
    lines; all with yaw 0 where they touch, so the corners are exact."""
    rng = np.random.default_rng(seed)
    off = tc.Config().offset
    hx = F32((VEHICLE_LENGTH + 2 * off) / 2.0)
    hy = F32((VEHICLE_WIDTH + 2 * off) / 2.0)
    step = F32(0.0625)
    k = np.arange(hp, dtype=F32)[:, None]
    pts = np.zeros((n, hp, 2), dtype=F32)
    pts[0] = np.concatenate([k * step, np.zeros_like(k)], -1)
    pts[1] = pts[0] + np.array([2 * hx, 0.0], dtype=F32)
    pts[2] = pts[0] + np.array([0.0, 2 * hy], dtype=F32)
    for v in range(3, n):
        start = rng.uniform(0.5, 3.5, 2)
        yaw = rng.uniform(-np.pi, np.pi)
        d = 0.05 * np.array([np.cos(yaw), np.sin(yaw)])
        pts[v] = (start + k * d).astype(F32)
    pts[4] = pts[3] + F32(0.05)                # a close overlapping pair
    return pts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fca_priorities_touching(seed):
    pts = fca_ref_points(seed)
    n = pts.shape[0]
    rng = np.random.default_rng(seed + 10)
    upper = np.triu(rng.random((n, n)) < 0.7, 1)
    adj = upper | upper.T
    adj[0, 1] = adj[1, 0] = adj[0, 2] = adj[2, 0] = True
    adj[3, 4] = adj[4, 3] = True
    tcfg, jcfg = configs(amount=n, priority=tc.PriorityStrategies.FCA_priority)
    got = tctl._fca_priorities(tcfg, torch.as_tensor(adj),
                               torch.as_tensor(pts)).numpy()
    want = np.asarray(jax.jit(lambda a, p: jctl._fca_priorities(
        jcfg, a, p))(jnp.asarray(adj), jnp.asarray(pts)))
    np.testing.assert_array_equal(got, want)
    # the touching pairs count as collisions: 0, 1, 2, 3 and 4 collide
    # somewhere, vehicle 5 (if alone) plans last
    assert sorted(got.tolist()) == list(range(1, n + 1))
    yaws = tctl._calculate_yaw(torch.as_tensor(pts))
    assert (yaws[:3] == 0).all()


# (P candidate rows, N vehicles): XLA:CPU sums the one-hot contraction in
# four lanes below P = 64 at P >= 2 with N in {8, 11, 12, 14, 15, 16} (and
# N in {4, 6, 7} at P >= 8), in four or two lanes for most N up to 48 at
# P >= 64, one vehicle after another elsewhere (controller._vote_lanes).
# The P of max_priority_permutations 32 and 64 are swept over N = 2..64;
# explorative voting's P (at most N) is sampled above 16.
VOTE_SHAPES = [(1, 3), (1, 8), (2, 5), (2, 8), (3, 11), (4, 3), (8, 3),
               (8, 4), (8, 6), (8, 9), (16, 7), (16, 8), (16, 12), (16, 13),
               (16, 16), (16, 20), (3, 20), (20, 20), (8, 64), (12, 14),
               (40, 40), (63, 63), (128, 5), (128, 48), (256, 21)] + [
                   (p, n) for p in (32, 64) for n in range(2, 65)]


@pytest.mark.parametrize("p_cnt,n", VOTE_SHAPES)
def test_vote_totals_bit_equal(p_cnt, n):
    """``_subgraph_totals`` against the vote's own JAX expression
    (controller._vote_per_subgraph: clamp, one-hot matmul at
    Precision.HIGHEST, round to 8 decimals), jitted, on costs spread over
    six decades with exhausted vehicles."""
    rng = np.random.default_rng(p_cnt * 100 + n)

    def totals_j(cost, exh, belonging):
        cost_l = jnp.where(exh, jctl._EXHAUSTED_PENALTY, cost)
        cost_g = jnp.swapaxes(cost_l, 0, 1)
        onehot = (belonging[:, None] == jnp.arange(n, dtype=jnp.int32)[
            None, :]).astype(cost_g.dtype)
        return jnp.round(jnp.matmul(cost_g.T, onehot,
                                    precision=jax.lax.Precision.HIGHEST), 8)

    for trial in range(8):
        cost = (rng.uniform(0, 1, (p_cnt, n))
                * 10.0 ** rng.integers(-3, 3, (p_cnt, n))).astype(F32)
        exh = rng.random((p_cnt, n)) < 0.05
        belonging = np.minimum.accumulate(
            rng.integers(0, n, n)[::-1])[::-1].copy() if trial % 2 else np.zeros(
                n, dtype=np.int64)
        want = np.asarray(jax.jit(totals_j)(jnp.asarray(cost),
                                            jnp.asarray(exh),
                                            jnp.asarray(belonging,
                                                        dtype=jnp.int32)))
        cost_l = torch.where(torch.as_tensor(exh),
                             torch.full((p_cnt, n), tctl._EXHAUSTED_PENALTY),
                             torch.as_tensor(cost))
        got = tctl._subgraph_totals(cost_l.T, torch.as_tensor(belonging))
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"trial {trial}")


@pytest.mark.parametrize("p_cnt,n", [(512, 3), (4, 65)])
def test_vote_order_unmapped_shape_warns(p_cnt, n):
    """Past the mapped shapes (N <= 64; P <= 64 or P in {128, 256}) the
    vote warns that its totals may part an ulp from the reference's; a
    mapped shape does not."""
    def solve(directed_p):
        planned = TPlan(
            trims=torch.zeros((n, 1), dtype=torch.int64),
            poses=torch.zeros((n, 1, 3)), shapes=torch.zeros((n, 1, 5, 2)),
            cost=directed_p.float().sum(dim=1),
            is_exhausted=torch.zeros((n,), dtype=torch.bool),
            n_expanded=torch.zeros((n,), dtype=torch.int64))
        return planned, torch.zeros((n, 1, 16, 2)), directed_p, \
            tg.kahn_levels(directed_p)[0]

    comm = TComm(n)
    belonging = torch.zeros((1, n), dtype=torch.int64)
    for rows in (p_cnt, 2):
        stack = torch.zeros((rows, 1, n, n), dtype=torch.bool)
        invalid = torch.zeros((rows, 1, n), dtype=torch.bool)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tctl._vote_per_subgraph(comm, batch_of_one(solve), stack,
                                    belonging, invalid,
                                    [[0]] + [[]] * (rows - 1))
        said = [w for w in caught if "summation order" in str(w.message)]
        assert bool(said) == (not tctl.vote_order_mapped(rows, n)), (rows, n)
        assert bool(said) == (rows > 256 or n > 64), (rows, n)


def _fake_solves(n, w):
    """The same fake solve for both packages: a vehicle's cost is the sum
    of w over its out-edges, with dyadic w so that any summation order
    gives the same f32 cost; the levels are the orientation's Kahn
    levels."""
    hp, vo = 1, 16

    def solve_j(directed_p):
        cost = jnp.sum(directed_p.astype(jnp.float32) * jnp.asarray(w),
                       axis=1)
        planned = JPlan(
            trims=jnp.zeros((n, hp), dtype=jnp.int32),
            poses=jnp.zeros((n, hp, 3)), shapes=jnp.zeros((n, hp, 5, 2)),
            cost=cost, is_exhausted=jnp.zeros((n,), dtype=bool),
            n_expanded=jnp.zeros((n,), dtype=jnp.int32))
        return planned, jnp.zeros((n, hp, vo, 2)), directed_p, \
            jg.kahn_levels(directed_p)[0]

    def solve_t(directed_p):
        cost = (directed_p.float() * torch.as_tensor(w)).sum(dim=1)
        planned = TPlan(
            trims=torch.zeros((n, hp), dtype=torch.int64),
            poses=torch.zeros((n, hp, 3)), shapes=torch.zeros((n, hp, 5, 2)),
            cost=cost, is_exhausted=torch.zeros((n,), dtype=torch.bool),
            n_expanded=torch.zeros((n,), dtype=torch.int64))
        return planned, torch.zeros((n, hp, vo, 2)), directed_p, \
            tg.kahn_levels(directed_p)[0]

    return solve_j, solve_t


def assert_votes_equal(got, want):
    """(planned, shapes, sequential, levels, priorities, directed, chosen)
    of the port's vote against the JAX one's."""
    names = ("shapes", "sequential", "levels", "priorities", "directed",
             "chosen")
    np.testing.assert_array_equal(got[0].cost.numpy(),
                                  np.asarray(want[0].cost), err_msg="cost")
    for name, a, b in zip(names, got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


class TestOptimalEquivalence:
    """Port twin of tests/test_priority_modes.py TestOptimalEquivalence:
    the per-subgraph orientation vote reaches the brute-force minimum and
    equals the JAX vote row for row."""

    def _run_case(self, adj_np, seed):
        n = adj_np.shape[0]
        rng = np.random.default_rng(seed)
        w = (rng.integers(7, 128, size=(n, n)) / 64.0).astype(F32)
        solve_j, solve_t = _fake_solves(n, w)
        tcfg, jcfg = configs(scenario_type=tc.ScenarioType.circle,
                             amount=max(n, 2), max_priority_permutations=16)
        want = jctl._solve_optimal(jcfg, JComm(n), solve_j,
                                   jnp.asarray(adj_np))
        got = one_scenario(tctl._solve_optimal(
            tcfg, TComm(n), batch_of_one(solve_t),
            torch.as_tensor(adj_np)[None]))
        assert_votes_equal(got, want)

        best = np.inf
        for prio in tg.unique_priorities_np(adj_np):
            d = adj_np & (prio[:, None] < prio[None, :])
            best = min(best, (d * w).sum())
        np.testing.assert_allclose(float(got[0].cost.sum()), best, rtol=1e-6)
        pr, d = got[4].numpy(), got[5].numpy()
        assert sorted(pr.tolist()) == list(range(1, n + 1))
        ii, jj = np.nonzero(d)
        assert (pr[ii] < pr[jj]).all()
        return got

    def test_two_components_with_cycle_candidates(self):
        n = 8
        adj = np.zeros((n, n), dtype=bool)
        for i, j in [(0, 1), (1, 2), (0, 2), (3, 4), (4, 5), (5, 6)]:
            adj[i, j] = adj[j, i] = True
        chosen = set()
        for seed in range(5):
            chosen |= set(self._run_case(adj, seed)[6].tolist())
        assert len(chosen) > 1           # the vote does not always keep row 0

    def test_partial_enumeration_warns(self):
        """A component with more than e_cap edges is enumerated in part,
        with a warning, and still equals the JAX vote."""
        n = 5
        adj = ~np.eye(n, dtype=bool)     # 10 edges > e_cap = 4
        with pytest.warns(UserWarning, match="enumeration is partial"):
            rng = np.random.default_rng(9)
            w = (rng.integers(7, 128, size=(n, n)) / 64.0).astype(F32)
            solve_j, solve_t = _fake_solves(n, w)
            tcfg, jcfg = configs(amount=n, max_priority_permutations=16)
            got = one_scenario(tctl._solve_optimal(
                tcfg, TComm(n), batch_of_one(solve_t),
                torch.as_tensor(adj)[None]))
        want = jctl._solve_optimal(jcfg, JComm(n), solve_j, jnp.asarray(adj))
        assert_votes_equal(got, want)


class TestExplorativeVoteNumerics:
    """Port twin of tests/test_priority_modes.py TestExplorativeVoteNumerics:
    an exhausted vehicle (cost inf) in one permutation must not poison the
    other subgraph's vote; both packages choose the same rows."""

    def test_exhausted_cost_does_not_poison_other_subgraphs(self):
        n, hp, vo = 4, 1, 16
        tcfg, jcfg = configs(scenario_type=tc.ScenarioType.circle, amount=n,
                             max_num_CLs=2)
        seq0 = np.zeros((n, n), dtype=bool)
        seq0[0, 1] = seq0[2, 3] = True
        levels0 = np.array([1, 2, 1, 2])
        fast, slow = [2.0, 2.0, 1.0, 1.0], [1.0, np.inf, 5.0, 5.0]

        def solve_j(directed_p):
            is_p1 = directed_p[1, 0]
            planned = JPlan(
                trims=jnp.zeros((n, hp), dtype=jnp.int32),
                poses=jnp.zeros((n, hp, 3)),
                shapes=jnp.zeros((n, hp, 5, 2)),
                cost=jnp.where(is_p1, jnp.asarray(fast), jnp.asarray(slow)),
                is_exhausted=jnp.where(
                    is_p1, jnp.zeros((n,), dtype=bool),
                    jnp.asarray([False, True, False, False])),
                n_expanded=jnp.zeros((n,), dtype=jnp.int32))
            levels = jnp.where(is_p1, jnp.asarray([2, 1, 2, 1]),
                               jnp.asarray([1, 2, 1, 2]))
            return planned, jnp.zeros((n, hp, vo, 2)), directed_p, levels

        def solve_t(directed_p):
            is_p1 = bool(directed_p[1, 0])
            planned = TPlan(
                trims=torch.zeros((n, hp), dtype=torch.int64),
                poses=torch.zeros((n, hp, 3)),
                shapes=torch.zeros((n, hp, 5, 2)),
                cost=torch.tensor(fast if is_p1 else slow),
                is_exhausted=torch.tensor(
                    [False] * 4 if is_p1 else [False, True, False, False]),
                n_expanded=torch.zeros((n,), dtype=torch.int64))
            levels = torch.tensor([2, 1, 2, 1] if is_p1 else [1, 2, 1, 2])
            return planned, torch.zeros((n, hp, vo, 2)), directed_p, levels

        want = jctl._solve_explorative(
            jcfg, JComm(n), solve_j, jnp.asarray(seq0), jnp.asarray(seq0),
            jnp.asarray(levels0, dtype=jnp.int32), 2)
        got = one_scenario(tctl._solve_explorative(
            tcfg, TComm(n), batch_of_one(solve_t), torch.as_tensor(seq0)[None],
            torch.as_tensor(seq0)[None], torch.as_tensor(levels0)[None], 2))
        np.testing.assert_array_equal(got[6].numpy(), [1, 1, 1, 1])
        assert torch.isfinite(got[0].cost).all()
        assert_votes_equal(got, want)


def test_explorative_solves_only_valid_shifts():
    """With one computation level every shift but the first is masked out
    of the reference's vote; the port solves just that one and votes the
    same."""
    n = 5
    tcfg, jcfg = configs(amount=n)
    w = (np.arange(n * n).reshape(n, n) % 13 / 16.0 + 0.25).astype(F32)
    solve_j, solve_t = _fake_solves(n, w)
    calls = []

    def counting(directed_p):
        calls.append(directed_p)
        return solve_t(directed_p)

    empty = np.zeros((n, n), dtype=bool)
    levels0 = np.ones(n, dtype=np.int64)
    got = one_scenario(tctl._solve_explorative(
        tcfg, TComm(n), batch_of_one(counting), torch.as_tensor(empty)[None],
        torch.as_tensor(empty)[None], torch.as_tensor(levels0)[None], n))
    want = jctl._solve_explorative(
        jcfg, JComm(n), solve_j, jnp.asarray(empty), jnp.asarray(empty),
        jnp.asarray(levels0, dtype=jnp.int32), n)
    assert len(calls) == 1
    assert_votes_equal(got, want)
