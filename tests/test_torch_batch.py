"""Batched scenario rollouts on the CPU: ``run_experiment_batch`` and
``monte_carlo_sweep`` against the reference's vmapped runs and against the
port's own single runs.

- Each cell's ``monte_carlo_sweep`` (1 m of arc) is held to the
  reference's (``jax.vmap`` of its run over the same starts) with
  ``tests.golden``'s exact gate: trims, levels, fallbacks, priorities and
  adjacency equal, poses within 1e-4, cost within rtol 1e-6.
- Each batch entry equals the port's single run from its start, every
  ``StepInfo`` field with ``torch.equal``: the merged chunk loop plans a
  scenario as it plans it alone.
- The start shifts are bit-equal to ``jax.random.uniform``'s and the
  shifted poses within two ulps of the reference's.
- The merged schedule, on random DAGs, plans each scenario's rows in its
  own ``compact_schedule`` order and every vehicle once.
- ``run_experiment_batch`` of one scenario equals ``run_experiment``; the
  voting modes, in a batch and in a sweep of two scenarios, plan each
  entry as its run alone; the kernels' row guard refuses more rows than
  their grid holds without launching.

The cr6 cells run in tests/test_torch_batch_cr6_coloring.py and
tests/test_torch_batch_cr6_random.py, a worker each.
"""

import enum
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import pdmpc_torch.config as tc
import pdmpc_tpu.config as jc
from pdmpc_torch.config import (
    OptimizerType as O,
)
from pdmpc_torch.config import (
    PriorityStrategies as P,
)
from pdmpc_torch.config import (
    ScenarioType as S,
)
from pdmpc_torch.config import (
    WeightStrategies as W,
)
from pdmpc_torch.controller import (
    StepState,
    compact_schedule,
    make_run,
    merged_schedule,
)
from pdmpc_torch.eval.experiments import (
    monte_carlo_sweep,
    perturbed_states,
    shifted_poses,
    start_shifts,
)
from pdmpc_torch.experiment import (
    create_scenario,
    run_experiment,
    run_experiment_batch,
)
from pdmpc_torch.models.mpa import build_mpa
from pdmpc_torch.parallel import graph as tg

# One intra-op thread per process, as the other port files.
torch.set_num_threads(1)

ARC = 1.0
# cell -> (configuration, scenarios)
CELLS = {
    "cr4_constant": (dict(amount=4, T_end=2.0, beam_width=64), 3),
    "cr6_coloring": (dict(amount=6, T_end=2.0, beam_width=64,
                          priority=P.coloring_priority), 4),
    "cr6_random": (dict(amount=6, T_end=2.0, beam_width=64,
                        priority=P.random_priority,
                        weight=W.random_weight), 3),
    "circle4_sampled": (dict(scenario_type=S.circle, amount=4, T_end=2.0,
                             optimizer_type=O.TpuSampled,
                             mcts_n_rollouts=64), 4),
}
GATE_EXACT = ("trims", "levels", "needs_fallback", "priorities",
              "adjacency")


def both_configs(kw):
    def conv(module):
        return {k: (getattr(module, type(v).__name__)[v.name]
                    if isinstance(v, enum.Enum) else v)
                for k, v in kw.items()}
    return tc.Config(**conv(tc)).validate(), jc.Config(**conv(jc)).validate()


@functools.cache
def port_batch(name):
    kw, b = CELLS[name]
    return monte_carlo_sweep(both_configs(kw)[0], b, ARC, device="cpu")


@functools.cache
def reference_batch(name):
    from pdmpc_tpu.eval.experiments import monte_carlo_sweep as j_sweep

    kw, b = CELLS[name]
    return j_sweep(both_configs(kw)[1], b, ARC)


@functools.cache
def port_tensors(name):
    cfg = both_configs(CELLS[name][0])[0]
    mpa = build_mpa(cfg)
    return (cfg, mpa.to_tensors_for(cfg, "cpu"),
            create_scenario(cfg, mpa).to_tensors("cpu"))


def single_runs(name):
    """The port's run of each batch entry alone, from that entry's start:
    [(entry, infos)] with the infos [1, k_end, ...]."""
    cfg, mpa_t, sc_t = port_tensors(name)
    b = CELLS[name][1]
    states = perturbed_states(sc_t, cfg, b, ARC)
    run = make_run(cfg)
    return [(i, run(StepState(*(x[i:i + 1] for x in states)), mpa_t,
                    sc_t)[1]) for i in range(b)]


def assert_entries_equal_single_runs(name):
    got = port_batch(name).infos
    for i, alone in single_runs(name):
        bad = [f for f, a, x in zip(alone._fields, alone, got)
               if not torch.equal(a[0], torch.as_tensor(x[i]))]
        assert bad == [], (name, i, bad)


def assert_sweep_matches_reference(name):
    got, want = port_batch(name).infos, reference_batch(name).infos
    assert got.cost.shape == want.cost.shape
    for field in GATE_EXACT:
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(want, field)),
                                      err_msg=f"{name}: {field}")
    np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.cost, want.cost, rtol=1e-6, atol=1e-6)
    # the entries part ways in their level sequences, so the merged
    # schedule runs chunks of some scenarios only
    if name != "circle4_sampled":
        assert len({got.levels[i].tobytes()
                    for i in range(got.levels.shape[0])}) > 1


# this file's cells; each cr6 cell has a file of its own (the files run
# in parallel workers)
HERE = ["cr4_constant", "circle4_sampled"]


@pytest.mark.parametrize("name", HERE)
def test_sweep_matches_reference_vmap(name):
    assert_sweep_matches_reference(name)


@pytest.mark.parametrize("name", HERE)
def test_entries_equal_single_runs(name):
    assert_entries_equal_single_runs(name)


@pytest.mark.parametrize("seed,b,n,arc", [(0, 3, 4, 1.0), (7, 32, 20, 1.0),
                                          (12345, 5, 6, 0.37)])
def test_start_shifts_bit_equal(seed, b, n, arc):
    got = start_shifts(seed, b, n, arc).numpy()
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (b, n),
                                         maxval=arc))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def reference_shifted_poses(sc_t, shifts):
    """pdmpc_tpu eval.experiments.monte_carlo_sweep's ``shift_pose``,
    vmapped over scenarios and vehicles and run op by op (not jitted) as
    it is there."""
    from pdmpc_tpu.ops import geometry as geo

    def shift_pose(i, arc):
        path = sc_t.reference_paths[i]
        cumlen = sc_t.path_cumlen[i]
        s0, _, _ = geo.project_to_polyline(sc_t.start_poses[i, :2], path,
                                           cumlen)
        pts = geo.sample_path_at_arclength(
            path, jnp.stack([s0 + arc, s0 + arc + 1e-3]), cumlen,
            sc_t.is_loop[i])
        d = pts[1] - pts[0]
        yaw = jnp.arctan2(d[1], d[0])
        return jnp.stack([pts[0, 0], pts[0, 1], yaw])

    return np.asarray(jax.vmap(
        jax.vmap(shift_pose, in_axes=(0, 0)), in_axes=(None, 0))(
            jnp.arange(sc_t.n_vehicles), shifts)).astype(np.float32)


@pytest.mark.parametrize("name", ["cr6_coloring", "circle4_sampled"])
def test_shifted_poses_within_two_ulps(name):
    from pdmpc_tpu.experiment import create_scenario as j_create
    from pdmpc_tpu.models.mpa import build_mpa as j_build

    tcfg, jcfg = both_configs(CELLS[name][0])
    _, _, sc_t = port_tensors(name)
    jsc = j_create(jcfg, j_build(jcfg)).to_tensors()
    shifts = start_shifts(tcfg.seed, 32, sc_t.n_vehicles, ARC)
    got = shifted_poses(sc_t, shifts).numpy()
    want = reference_shifted_poses(jsc, jnp.asarray(shifts.numpy()))
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


@st.composite
def dag_batches(draw):
    """A batch of random DAGs [B, N, N] (a random vehicle order, each
    forward pair an edge at random), their Kahn levels and a chunk
    width."""
    b = draw(st.integers(1, 4))
    n = draw(st.integers(1, 8))
    seq = np.zeros((b, n, n), dtype=bool)
    for i in range(b):
        order = draw(st.permutations(range(n)))
        for x in range(n):
            for y in range(x + 1, n):
                seq[i, order[x], order[y]] = draw(st.booleans())
    seq = torch.as_tensor(seq)
    levels, is_dag = tg.kahn_levels(seq)
    assert bool(is_dag.all())
    return levels, seq, draw(st.integers(1, 3))


@settings(max_examples=60, deadline=None)
@given(dag_batches())
def test_merged_schedule_keeps_each_scenarios_own(batch):
    levels, seq, c_chunk = batch
    b, n = levels.shape
    merged = merged_schedule(levels, c_chunk, seq)
    seen = {}
    for t, chunk in enumerate(merged):
        assert chunk.shape[0] == 3 and chunk.shape[1] > 0
        for bi, vi, ri in chunk.T.tolist():
            assert ri == bi * n + vi
            seen.setdefault(bi, []).append((t, vi))
    for i in range(b):
        own, n_chunks = compact_schedule(levels[i], c_chunk, seq[i])
        want = [(t, v) for t in range(n_chunks) for v in own[t].tolist()
                if v >= 0]
        assert seen[i] == want
        assert sorted(v for _, v in seen[i]) == list(range(n))


def test_batch_of_one_equals_run_experiment():
    cfg = tc.Config(scenario_type=S.circle, amount=3, T_end=1.0,
                    beam_width=64, priority=P.FCA_priority)
    single = run_experiment(cfg, device="cpu")
    batch = run_experiment_batch(cfg, n_scenarios=1, device="cpu")
    for field, a, x in zip(single.infos._fields, single.infos, batch.infos):
        np.testing.assert_array_equal(a, x[0], err_msg=field)
    for a, x in zip(single.final_state, batch.final_state):
        assert torch.equal(a, x[0])
    assert batch.timings["vehicle_solves_per_second"] > 0


def test_corridor_clip_in_passes_equals_one_pass(monkeypatch):
    """The reachable sets are clipped to the corridor CLIP_ROWS vehicles a
    pass; one vehicle a pass plans what one pass for all plans."""
    import pdmpc_torch.controller as ctl

    cfg = tc.Config(amount=3, T_end=0.4, beam_width=16)
    one_pass = run_experiment(cfg, device="cpu")
    monkeypatch.setattr(ctl, "CLIP_ROWS", 1)
    passes = run_experiment(cfg, device="cpu")
    for field, a, x in zip(one_pass.infos._fields, one_pass.infos,
                           passes.infos):
        np.testing.assert_array_equal(a, x, err_msg=field)


@pytest.mark.parametrize("priority", [P.optimal_priority,
                                      P.explorative_priority])
@pytest.mark.parametrize("entry", ["batch", "sweep"])
def test_voting_refused_past_one_scenario(priority, entry):
    """Voting past one scenario, refused until the voting modes were
    batched, now runs: each entry of a batch (identical starts) or a sweep
    (starts shifted 1 m) of two circle-3 scenarios equals its scenario
    planned alone."""
    cfg = tc.Config(scenario_type=S.circle, amount=3, T_end=0.4,
                    beam_width=8, priority=priority).validate()
    mpa = build_mpa(cfg)
    mpa_t = mpa.to_tensors_for(cfg, "cpu")
    sc_t = create_scenario(cfg, mpa).to_tensors("cpu")
    if entry == "batch":
        got = run_experiment_batch(cfg, n_scenarios=2, device="cpu").infos
        states = perturbed_states(sc_t, cfg, 2)
    else:
        got = monte_carlo_sweep(cfg, 2, ARC, device="cpu").infos
        states = perturbed_states(sc_t, cfg, 2, ARC)
    assert got.cost.shape == (2, cfg.k_end, 3)
    for i in range(2):
        _, alone = make_run(cfg)(StepState(*(x[i:i + 1] for x in states)),
                                 mpa_t, sc_t)
        bad = [f for f, a, x in zip(alone._fields, alone, got)
               if not torch.equal(a[0], torch.as_tensor(x[i]))]
        assert bad == [], (i, bad)


def test_kernel_row_guard_refuses_before_launching(monkeypatch):
    """Past MAX_ROWS planning rows a wrapper raises before it launches:
    the CUDA branch is taken with CPU tensors (the device index forced to
    0), and neither the build nor a plain version may be reached."""
    from pdmpc_torch.ops import collision as coll

    coll.check_rows(coll.MAX_ROWS)
    with pytest.raises(ValueError, match="planning rows"):
        coll.check_rows(coll.MAX_ROWS + 1)

    def forbidden(*args, **kwargs):
        raise AssertionError("reached past the row guard")

    for name in ("build_kernels", "outline_hits_plain", "boundary_hits_plain",
                 "sat_hits_plain", "outline_hits_lattice_plain",
                 "boundary_hits_lattice_plain", "sat_hits_lattice_plain"):
        monkeypatch.setattr(coll, name, forbidden)
    monkeypatch.setattr(coll, "_device_of", lambda live: 0)
    monkeypatch.setattr(coll, "_check", lambda dev, specs: None)
    v = coll.MAX_ROWS + 1
    cx = torch.zeros((v, 4, 0))
    live = torch.zeros((v, 0), dtype=torch.bool)
    # bundles of one row: the guard reads the candidates' rows first
    out = coll.precompute_outline(torch.zeros((1, 1, 16, 2)),
                                  torch.zeros((1, 1), dtype=torch.bool))
    seg = coll.precompute_segments(torch.zeros((1, 1, 2, 2)),
                                   torch.zeros((1, 1), dtype=torch.bool))
    sat = coll.precompute_obstacles(torch.zeros((1, 1, 16, 2)),
                                    torch.zeros((1, 1), dtype=torch.bool))
    lat = coll.Lattice(torch.zeros((12, 12, 4, 2)),
                       torch.zeros((v, 0), dtype=torch.int64),
                       torch.zeros((v, 0, 3)), torch.zeros((v, 0, 1)),
                       torch.zeros((v, 0, 1)))
    live_lat = torch.zeros((v, 0, 12), dtype=torch.bool)
    for call in (lambda: coll.outline_hits(cx, cx, out, live),
                 lambda: coll.boundary_hits(cx, cx, seg, live),
                 lambda: coll.sat_hits(cx, cx, sat, live),
                 lambda: coll.outline_hits_lattice(lat, live_lat, out),
                 lambda: coll.boundary_hits_lattice(lat, live_lat, seg),
                 lambda: coll.sat_hits_lattice(lat, live_lat, sat)):
        with pytest.raises(ValueError, match="planning rows"):
            call()
