"""Human-driven vehicles (HDVs) in the port, against pdmpc_tpu on the CPU:
the twin of tests/test_hdv.py.

- circle-3 with HDV 1 (beam 96, T_end 3 s) and cr3 with HDV 1 (beam 64,
  T_end 2 s), each held to ``pdmpc_tpu.experiment.run_experiment`` of the
  same configuration with the exact gate: every integer and boolean
  field of the step record equal (trims, levels, fallbacks, adjacency,
  priorities, ...), poses within 1e-4, cost within rtol 1e-6. The HDV's
  poses are its reference points, which the two packages sample an ulp
  apart at some steps; no decision differs. Each run also meets the
  reference test's checks: the HDV follows its path, stays outside the
  coupling graph and never falls back, no two vehicles collide, and on
  the road the CAVs keep moving.
- the pieces of the HDV step against the reference's expressions on
  seeded inputs: the HDV trim (the straight trim closest to the
  reference speed), the directional CAV-HDV coupling (is_hdv_behind.m)
  and ``vehicles_at_intersection``.
- an HDV batch of two (``monte_carlo_sweep``, 1 m of arc): each entry
  equals its scenario's run alone in every field.
"""

import enum
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdmpc_torch.config as tc
import pdmpc_tpu.config as jc
from pdmpc_torch import controller as tctl
from pdmpc_torch.controller import StepState, make_run
from pdmpc_torch.eval.experiments import monte_carlo_sweep, perturbed_states
from pdmpc_torch.experiment import create_scenario, run_experiment
from pdmpc_torch.models.mpa import build_mpa
from tests.test_controller import pairwise_vehicle_collisions

# One intra-op thread per process, as the other port files.
torch.set_num_threads(1)

CELLS = {
    "circle3_hdv1": dict(scenario_type=tc.ScenarioType.circle, amount=3,
                         T_end=3.0, beam_width=96),
    "cr3_hdv1": dict(amount=3, T_end=2.0, beam_width=64),
}
HDV = 1


def both_configs(kw, hdv_ids=(HDV,)):
    """The configuration ``kw`` in both packages, with the HDVs
    ``hdv_ids``."""
    def conv(module):
        out = {k: (getattr(module, type(v).__name__)[v.name]
                   if isinstance(v, enum.Enum) else v)
               for k, v in kw.items()}
        out["manual_control_config"] = module.ManualControlConfig(
            is_active=True, amount=len(hdv_ids), hdv_ids=tuple(hdv_ids))
        return out
    return tc.Config(**conv(tc)), jc.Config(**conv(jc))


@functools.cache
def runs(name):
    """(the port's run, the reference's run) of cell ``name``."""
    from pdmpc_tpu.experiment import run_experiment as j_run

    tcfg, jcfg = both_configs(CELLS[name])
    return run_experiment(tcfg, device="cpu"), j_run(jcfg)


def assert_exact(got, want):
    """The exact gate between two runs' records."""
    for field in got._fields:
        a, b = getattr(got, field), np.asarray(getattr(want, field))
        assert a.shape == b.shape, field
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=field)
    np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.cost, want.cost, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_matches_reference(name):
    got, want = runs(name)
    assert_exact(got.infos, want.infos)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_hdv_behavior(name):
    res, _ = runs(name)
    infos = res.infos
    poses = infos.poses[:, :, 0]
    # the HDV drives its reference path, unimpeded
    assert np.linalg.norm(poses[-1, HDV, :2] - poses[0, HDV, :2]) > (
        2.0 if name.startswith("circle") else 0.5)
    assert not infos.adjacency[:, HDV, :].any()
    assert not infos.adjacency[:, :, HDV].any()
    assert not infos.needs_fallback[:, HDV].any()
    assert pairwise_vehicle_collisions(res) == []
    if name.startswith("cr"):
        for v in (0, 2):
            d = np.linalg.norm(poses[-1, v, :2] - poses[0, v, :2])
            assert d > 0.3, f"CAV {v} is stuck (moved {d:.3f} m)"


def test_hdv_trim_matches_reference():
    """The straight trim with the speed closest to each reference speed,
    the first on a tie (pdmpc_tpu controller, HDV apply)."""
    from pdmpc_tpu.models.mpa import build_mpa as j_build

    for kw in (dict(scenario_type=tc.ScenarioType.circle), {},
               dict(mpa_type=tc.MpaType.triple_speed)):
        tcfg, jcfg = (c.validate() for c in both_configs(kw))
        mpa_t = build_mpa(tcfg).to_tensors_for(tcfg, "cpu")
        mpa_j = j_build(jcfg).to_tensors_for(jcfg)
        speeds = np.concatenate([np.asarray(mpa_j.trim_speed),
                                 np.random.default_rng(0).uniform(0, 1.5, 40)
                                 ]).astype(np.float32)
        dist = jnp.where(
            (jnp.abs(mpa_j.trim_steering) < 1e-9)[None, :],
            jnp.abs(mpa_j.trim_speed[None, :] - jnp.asarray(speeds)[:, None]),
            jnp.inf)
        want = np.asarray(jnp.argmin(dist, axis=-1))
        got = tctl._hdv_trim(mpa_t, torch.as_tensor(speeds))
        np.testing.assert_array_equal(got.numpy(), want)


def reference_hdv_behind(road, cl_g, pose_g):
    """pdmpc_tpu make_prioritized_step's directional coupling on one
    scenario, as it is written there (controller.py:844-855)."""
    pred_m = road.hdv_predecessor[cl_g[:, None], cl_g[None, :]]
    over_m = road.hdv_overlap[cl_g[:, None], cl_g[None, :]]
    same = cl_g[:, None] == cl_g[None, :]
    vec_cav_hdv = pose_g[None, :, :2] - pose_g[:, None, :2]
    hdv_heading = jnp.stack([jnp.cos(pose_g[:, 2]), jnp.sin(pose_g[:, 2])],
                            axis=-1)
    scal = jnp.sum(hdv_heading[None, :, :] * vec_cav_hdv, axis=-1)
    return pred_m | ((same | over_m) & (scal < 0.0))


def test_hdv_behind_matches_reference():
    """On random lanelets of the map and random poses, some pairs on one
    lanelet, the [B, N, N] port equals the reference scenario by
    scenario."""
    import jax

    from pdmpc_torch.scenarios.road import get_road_data as t_road
    from pdmpc_torch.scenarios.scenario import road_to_tensors as t_tensors
    from pdmpc_tpu.scenarios.road import get_road_data as j_road
    from pdmpc_tpu.scenarios.scenario import road_to_tensors as j_tensors

    t_rt, j_rt = t_tensors(t_road(), "cpu"), j_tensors(j_road())
    n_lanelets = t_rt.hdv_predecessor.shape[0] - 1
    rng = np.random.default_rng(4)
    b, n = 6, 12
    lanelets = rng.integers(1, n_lanelets + 1, (b, n))
    lanelets[:, 1::3] = lanelets[:, ::3][:, :lanelets[:, 1::3].shape[1]]
    poses = np.concatenate([rng.uniform(0, 4.5, (b, n, 2)),
                            rng.uniform(-np.pi, np.pi, (b, n, 1))],
                           -1).astype(np.float32)
    got = tctl._hdv_behind(t_rt, torch.as_tensor(lanelets),
                           torch.as_tensor(poses)).numpy()
    ref = jax.jit(lambda cl, p: reference_hdv_behind(j_rt, cl, p))
    for i in range(b):
        want = np.asarray(ref(jnp.asarray(lanelets[i], dtype=jnp.int32),
                              jnp.asarray(poses[i])))
        np.testing.assert_array_equal(got[i], want, err_msg=f"scenario {i}")
    assert got.any() and not got.all()


def test_vehicles_at_intersection():
    """The port against pdmpc_tpu's vehicles_at_intersection: entry steps
    kept while inside, reset to inf on leaving."""
    from pdmpc_tpu.controller import vehicles_at_intersection as j_at

    center = (2.25, 2.0)
    rng = np.random.default_rng(2)
    t_times = torch.full((8,), torch.inf)
    j_times = jnp.full((8,), jnp.inf)
    for step in range(6):
        pos = rng.uniform(1.5, 3.0, (8, 2)).astype(np.float32)
        t_at, t_times = tctl.vehicles_at_intersection(
            step, t_times, torch.as_tensor(pos), center, 0.5)
        j_at_, j_times = j_at(step, j_times, jnp.asarray(pos),
                              jnp.asarray(center), 0.5)
        np.testing.assert_array_equal(t_at.numpy(), np.asarray(j_at_))
        np.testing.assert_array_equal(t_times.numpy(), np.asarray(j_times))
    # the reference test's two steps
    times = torch.full((3,), torch.inf)
    at, times = tctl.vehicles_at_intersection(
        5, times, torch.tensor([[2.3, 2.0], [0.0, 0.0], [2.2, 2.1]]), center,
        0.5)
    assert at.tolist() == [True, False, True]
    assert times.tolist() == [5.0, np.inf, 5.0]
    at, times = tctl.vehicles_at_intersection(
        6, times, torch.tensor([[4.0, 4.0], [2.25, 2.0], [2.2, 2.1]]), center,
        0.5)
    assert at.tolist() == [False, True, True]
    assert times.tolist() == [np.inf, 6.0, 5.0]


def test_hdv_batch_entries_equal_single_runs():
    """An HDV sweep of two scenarios on the road: each entry equals its
    scenario planned alone."""
    cfg = both_configs(dict(amount=3, T_end=1.0, beam_width=32))[0]
    b, arc = 2, 1.0
    batch = monte_carlo_sweep(cfg, b, arc, device="cpu").infos
    cfg = cfg.validate()
    mpa = build_mpa(cfg)
    mpa_t = mpa.to_tensors_for(cfg, "cpu")
    sc_t = create_scenario(cfg, mpa).to_tensors("cpu")
    assert sc_t.is_hdv.tolist() == [False, True, False]
    states = perturbed_states(sc_t, cfg, b, arc)
    for i in range(b):
        _, alone = make_run(cfg)(StepState(*(x[i:i + 1] for x in states)),
                                 mpa_t, sc_t)
        bad = [f for f, a, x in zip(alone._fields, alone, batch)
               if not torch.equal(a[0], torch.as_tensor(x[i]))]
        assert bad == [], (i, bad)
    assert not batch.adjacency[:, :, HDV].any()
