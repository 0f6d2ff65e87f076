"""Centralized planning in the port, against pdmpc_tpu on the CPU: the
twin of tests/test_centralized.py.

- circle-2 (beam 320, T_end 3 s) and cr3 (beam 16, 5 steps), each held
  to ``pdmpc_tpu.experiment.run_experiment`` of the same configuration
  with the exact gate: every integer and boolean field of the step
  record equal, poses within 1e-4, cost within rtol 1e-6 (the reference
  points, which the cost reads, are sampled an ulp apart at some steps).
  circle-2 also meets the reference test's checks: the head-on pair
  passes without exhaustion or collision, and the records carry no
  coupling graph. cr3 at beam 16 exhausts its joint search, as the
  reference's does, and its fleet holds its poses.
- ``plan_centralized`` against the JAX function on seeded inputs: two
  and three vehicles, with static obstacles and lanelet boundaries in
  the way (the port checks those through the kernels' plain versions):
  trims, exhaustion and expansion counts equal, poses within 1e-5 and
  cost within rtol 1e-6 (the poses are bit-equal but where XLA:CPU's
  vectorized sine of a yaw is an ulp off torch's).
- the product-space guard's ``ValueError``.
- a centralized batch of two scenarios: each entry equals its run alone.
"""

import enum
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdmpc_torch.config as tc
import pdmpc_tpu.config as jc
from pdmpc_torch.controller import StepState, make_run
from pdmpc_torch.eval.experiments import monte_carlo_sweep, perturbed_states
from pdmpc_torch.experiment import create_scenario, run_experiment
from pdmpc_torch.models.mpa import build_mpa
from pdmpc_torch.ops.search import Obstacles
from pdmpc_torch.ops.search_centralized import plan_centralized
from tests.test_controller import pairwise_vehicle_collisions
from tests.test_torch_hdv import assert_exact

# One intra-op thread per process, as the other port files.
torch.set_num_threads(1)

CELLS = {
    "circle2": dict(scenario_type=tc.ScenarioType.circle, amount=2,
                    T_end=3.0, beam_width=320),
    "cr3": dict(amount=3, T_end=1.0, beam_width=16),
}


def both_configs(kw):
    def conv(module):
        return {k: (getattr(module, type(v).__name__)[v.name]
                    if isinstance(v, enum.Enum) else v)
                for k, v in kw.items()}
    return (tc.Config(is_prioritized=False, **conv(tc)),
            jc.Config(is_prioritized=False, **conv(jc)))


@functools.cache
def runs(name):
    """(the port's run, the reference's run) of cell ``name``."""
    from pdmpc_tpu.experiment import run_experiment as j_run

    tcfg, jcfg = both_configs(CELLS[name])
    return run_experiment(tcfg, device="cpu"), j_run(jcfg)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_matches_reference(name):
    got, want = runs(name)
    assert got.n_steps == (5 if name == "cr3" else 15)
    assert_exact(got.infos, want.infos)


def test_head_on_passes():
    res, _ = runs("circle2")
    poses = res.infos.poses[:, :, 0]
    d = np.linalg.norm(poses[-1, :, :2] - poses[0, :, :2], axis=-1)
    assert (d > 2.0).all()
    assert not res.infos.is_exhausted.any()
    assert pairwise_vehicle_collisions(res) == []
    # no sequential couplings, one level
    assert not res.infos.directed_sequential.any()
    assert (res.infos.levels == 1).all()


def test_exhausted_fleet_holds_its_poses():
    res, _ = runs("cr3")
    exhausted = res.infos.is_exhausted[:, 0]
    assert exhausted.any()
    assert (res.infos.needs_fallback == res.infos.is_exhausted).all()
    # the pose a step applies is its plan's first, or the held one
    held = res.final_state.pose.numpy()
    last = np.flatnonzero(~exhausted)
    if exhausted[-1] and last.size:
        np.testing.assert_array_equal(held, res.infos.poses[last[-1], :, 0])


def joint_inputs(name, n_veh, seed):
    """(port MPA, JAX MPA, x0, trim0, ref_points, v_ref, static obstacles
    [O, VO, 2], boundary segments [N, S, 2, 2]) on the MPA of scenario
    ``name``: vehicles near each other driving toward a shared point,
    obstacles and boundary segments in their way."""
    from pdmpc_tpu.models.mpa import build_mpa as j_build

    kw = CELLS[name] | dict(amount=n_veh)
    tcfg, jcfg = (c.validate() for c in both_configs(kw))
    mpa_t = build_mpa(tcfg).to_tensors_for(tcfg, "cpu")
    mpa_j = j_build(jcfg).to_tensors_for(jcfg)
    rng = np.random.default_rng(seed)
    hp = mpa_t.Hp
    x0 = np.concatenate([rng.uniform(1.5, 2.5, (n_veh, 2)),
                         rng.uniform(-np.pi, np.pi, (n_veh, 1))], -1)
    trim0 = rng.integers(0, mpa_t.n_trims, n_veh)
    trim0 = np.where(np.asarray(mpa_j.trim_speed)[trim0] > 0, trim0, 1)
    heading = np.stack([np.cos(x0[:, 2]), np.sin(x0[:, 2])], -1)
    step = np.linspace(0.1, 0.6, hp)[None, :, None]
    ref = x0[:, None, :2] + step * heading[:, None] + rng.normal(
        0, 0.02, (n_veh, hp, 2))
    v_ref = np.full((n_veh, hp), 0.5)
    obs_center = x0[:, :2].mean(axis=0) + rng.normal(0, 0.3, (3, 2))
    square = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]]) * 0.08
    obstacles = np.repeat(obs_center[:, None] + square, 4, axis=1)
    seg = np.zeros((n_veh, 24, 2, 2))
    for v in range(n_veh):
        a = x0[v, :2] + rng.uniform(-0.6, 0.6, (24, 2))
        seg[v, :, 0] = a
        seg[v, :, 1] = a + rng.uniform(-0.4, 0.4, (24, 2))
    f32 = np.float32
    return (mpa_t, mpa_j, x0.astype(f32), trim0, ref.astype(f32),
            v_ref.astype(f32), obstacles.astype(f32), seg.astype(f32))


@pytest.mark.parametrize("name,n_veh,seed,beam", [
    ("circle2", 2, 0, 64), ("circle2", 2, 1, 200), ("circle2", 3, 2, 8),
    ("cr3", 2, 3, 32), ("cr3", 3, 4, 4)])
def test_plan_centralized_matches_reference(name, n_veh, seed, beam):
    from pdmpc_tpu.ops.search import Obstacles as JObstacles
    from pdmpc_tpu.ops.search_centralized import (
        plan_centralized as j_plan,
    )

    mpa_t, mpa_j, x0, trim0, ref, v_ref, obs, seg = joint_inputs(
        name, n_veh, seed)
    hp = mpa_t.Hp
    n_obs = obs.shape[0]
    seg_mask = np.arange(seg.shape[1])[None] < [[20], [24], [9]][:n_veh]
    obs_mask = np.ones((n_obs, hp), dtype=bool)
    obs_mask[0, hp // 2:] = False
    expanded = []
    for with_checks in (False, True):
        kw_j, kw_t = {}, {}
        if with_checks:
            polys = np.broadcast_to(obs[:, None], (n_obs, hp, 16, 2))
            kw_j = dict(obstacles=JObstacles(jnp.asarray(polys),
                                             jnp.asarray(obs_mask)),
                        boundary_segments=jnp.asarray(seg),
                        boundary_mask=jnp.asarray(seg_mask))
            kw_t = dict(obstacles=Obstacles(torch.as_tensor(polys.copy()),
                                            torch.as_tensor(obs_mask)),
                        boundary_segments=torch.as_tensor(seg),
                        boundary_mask=torch.as_tensor(seg_mask))
        # jitted, as the reference's run compiles it
        want = jax.jit(j_plan, static_argnames=("dt", "beam_width"))(
            mpa_j, jnp.asarray(x0), jnp.asarray(trim0, dtype=jnp.int32),
            jnp.asarray(ref), jnp.asarray(v_ref), dt=0.2, beam_width=beam,
            **kw_j)
        got = plan_centralized(mpa_t, torch.as_tensor(x0),
                               torch.as_tensor(trim0), torch.as_tensor(ref),
                               torch.as_tensor(v_ref), 0.2, beam, **kw_t)
        for field in ("trims", "is_exhausted", "n_expanded"):
            np.testing.assert_array_equal(
                getattr(got, field).numpy(), np.asarray(getattr(want,
                                                                field)),
                err_msg=f"{field}, checks {with_checks}")
        for field in ("poses", "shapes"):
            np.testing.assert_allclose(
                getattr(got, field).numpy(), np.asarray(getattr(want,
                                                                field)),
                rtol=0, atol=1e-5, err_msg=f"{field}, checks {with_checks}")
        np.testing.assert_allclose(float(got.cost), float(want.cost),
                                   rtol=1e-6)
        expanded.append(int(got.n_expanded))
    # the obstacles and boundaries in the way cut candidates
    assert expanded[1] < expanded[0], expanded


def test_product_space_guard():
    cfg = tc.Config(scenario_type=tc.ScenarioType.circle, amount=6,
                    beam_width=512, is_prioritized=False).validate()
    mpa = build_mpa(cfg).to_tensors_for(cfg, "cpu")
    with pytest.raises(ValueError, match="product space too large"):
        plan_centralized(mpa, torch.zeros((6, 3)),
                         torch.zeros((6,), dtype=torch.int64),
                         torch.zeros((6, 6, 2)), torch.zeros((6, 6)), 0.2,
                         512)


def test_batch_entries_equal_single_runs():
    """A centralized sweep of two circle scenarios (1 m of arc): each
    entry equals its scenario planned alone."""
    cfg = both_configs(dict(scenario_type=tc.ScenarioType.circle, amount=2,
                            T_end=1.0, beam_width=64))[0]
    b, arc = 2, 1.0
    batch = monte_carlo_sweep(cfg, b, arc, device="cpu").infos
    cfg = cfg.validate()
    mpa = build_mpa(cfg)
    mpa_t = mpa.to_tensors_for(cfg, "cpu")
    sc_t = create_scenario(cfg, mpa).to_tensors("cpu")
    states = perturbed_states(sc_t, cfg, b, arc)
    for i in range(b):
        _, alone = make_run(cfg)(StepState(*(x[i:i + 1] for x in states)),
                                 mpa_t, sc_t)
        bad = [f for f, a, x in zip(alone._fields, alone, batch)
               if not torch.equal(a[0], torch.as_tensor(x[i]))]
        assert bad == [], (i, bad)
    assert not np.array_equal(batch.poses[0], batch.poses[1])


def test_kernel_candidate_count_guard():
    """A layer's joint candidates (up to the guard's 8,000,000) fit the
    kernels' 32-bit candidate index; past MAX_CANDIDATES a wrapper
    raises."""
    from pdmpc_torch.ops import collision as coll
    from pdmpc_torch.ops.search_centralized import MAX_JOINT_CANDIDATES

    coll.check_candidate_count(MAX_JOINT_CANDIDATES)
    coll.check_candidate_count(coll.MAX_CANDIDATES)
    with pytest.raises(ValueError, match="candidates a row"):
        coll.check_candidate_count(coll.MAX_CANDIDATES + 1)
