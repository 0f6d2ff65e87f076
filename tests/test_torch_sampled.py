"""The port's sampled search (TpuSampled) against the reference's.

``pdmpc_torch.ops.search.plan_trajectory_sampled`` takes its Gumbel noise
as an argument. Fed the noise ``jax.random.gumbel`` draws from the
reference's own keys, it must plan what pdmpc_tpu's jitted
``plan_trajectory_sampled`` plans from those keys: trims, ``is_exhausted``,
``n_expanded`` and the cost equal bit for bit, poses and swept shapes
within two ulps (rtol 2.4e-7; XLA:CPU's f32 cosine and sine sit an ulp
from torch's for some yaws, ``python -m tests.test_torch_numerics``, and
nothing else differs). Inputs: a free-space start half blocked, fully
blocked (every rollout dies: the plan is rollout 0's, exhausted, at cost
inf) and, at a near-greedy temperature, with nearly every rollout the
same path (exact ties of the leaf cost, the first rollout wins); then the
reference's own per-step planning inputs of a road run (outline and
boundary crossing) and a circle run (SAT), captured with
``make_prioritized_step(..., debug_capture=True)``.

Then twins of tests/test_sampled.py on the port alone (feasible plans,
exhaustion, determinism per seed) and the rollout policy's logits, which
XLA:CPU computes with the reciprocal of the temperature.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdmpc_torch import convert, prng
from pdmpc_torch.ops import search as ts
from pdmpc_torch.ops.collision import (
    candidate_polys,
    precompute_obstacles,
    sat_hits_plain,
)
from pdmpc_tpu.config import Config, OptimizerType, ScenarioType
from pdmpc_tpu.controller import initial_state, make_prioritized_step
from pdmpc_tpu.experiment import create_scenario
from pdmpc_tpu.models.mpa import build_mpa
from pdmpc_tpu.ops import search as js

# One intra-op thread per process (see tests/test_torch_system.py).
torch.set_num_threads(1)

VO = 16
ULPS2 = dict(rtol=2.4e-7, atol=1e-12)


def jax_noise(keys, hp, r, n):
    """The Gumbel noise [V, Hp, R, n] the reference's search draws from
    the per-vehicle keys [V, 2]: one key a layer (split), each drawing
    gumbel((R, n))."""
    def per_vehicle(key):
        return jax.vmap(lambda k: jax.random.gumbel(k, (r, n)))(
            jax.random.split(key, hp))
    return np.asarray(jax.jit(jax.vmap(per_vehicle))(keys))


def assert_plans_equal(got, want, msg=""):
    for field in ("trims", "is_exhausted", "n_expanded", "cost"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            err_msg=f"{msg}: {field}")
    for field in ("poses", "shapes"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            err_msg=f"{msg}: {field}", **ULPS2)


@pytest.fixture(scope="module")
def free_space():
    """The circle MPA and a start at the standstill trim heading +x, as
    tests/test_sampled.py sets up."""
    cfg = Config(scenario_type=ScenarioType.circle, amount=1).validate()
    mpa_j = build_mpa(cfg).to_tensors()
    mpa = convert.mpa_from_numpy(
        {k: np.asarray(v) for k, v in mpa_j._asdict().items()}, device="cpu")
    hp = mpa_j.Hp
    eq = int(np.argwhere(np.asarray(mpa_j.trims_stop))[0][0])
    x0 = np.array([0.25, 2.0, 0.0], np.float32)
    ref = np.stack([0.25 + 0.16 * np.arange(1, hp + 1),
                    np.full(hp, 2.0)], -1).astype(np.float32)
    return cfg, mpa_j, mpa, hp, eq, x0, ref


def box(corners, hp):
    """One square obstacle at every layer, padded to VO: [1, Hp, VO, 2]."""
    sq = np.asarray(corners, np.float32)
    poly = np.concatenate([sq, np.repeat(sq[-1:], VO - 4, axis=0)])
    return np.broadcast_to(poly, (1, hp, VO, 2)).copy()


BOXES = {
    # half blocks the straight path (test_sampled's feasibility case)
    "half": [[0.8, 1.99], [1.0, 1.99], [1.0, 2.2], [0.8, 2.2]],
    # encloses the start: every move and the standstill area collide
    "blocked": [[-0.1, 1.5], [0.6, 1.5], [0.6, 2.5], [-0.1, 2.5]],
    # far away: nothing collides
    "free": [[9.0, 9.0], [9.2, 9.0], [9.2, 9.2], [9.0, 9.2]],
}


@pytest.mark.parametrize("case,temperature", [
    ("half", 0.01), ("half", 0.002), ("half", 0.0), ("blocked", 0.01),
    ("free", 1e-5)])
def test_fed_jax_noise_matches_reference(free_space, case, temperature):
    cfg, mpa_j, mpa, hp, eq, x0, ref = free_space
    r = 128
    polys = box(BOXES[case], hp)
    v_ref = np.full((hp,), 0.8, np.float32)
    plan = jax.jit(lambda x, t, rp, vr, p, key: js.plan_trajectory_sampled(
        mpa_j, x, t, rp, vr, js.Obstacles(
            polys=p, mask=jnp.ones((1, hp), bool)), cfg.dt_seconds, r, key,
        temperature=temperature))
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = plan(jnp.asarray(x0), jnp.int32(eq), jnp.asarray(ref),
                    jnp.asarray(v_ref), jnp.asarray(polys), key)
        noise = jax_noise(key[None], hp, r, mpa_j.n_trims)
        got = ts.plan_trajectory_sampled(
            mpa, torch.tensor(x0)[None], torch.tensor([eq]),
            torch.tensor(ref)[None], torch.tensor(v_ref)[None],
            ts.Obstacles(polys=torch.tensor(polys)[None],
                         mask=torch.ones((1, 1, hp), dtype=torch.bool)),
            cfg.dt_seconds, torch.tensor(noise), temperature=temperature)
        got = got._replace(**{f: getattr(got, f)[0] for f in got._fields})
        assert_plans_equal(got, want, f"seed {seed}")
        assert bool(want.is_exhausted) == (case == "blocked")
        if case == "free":
            # the near-greedy policy: every rollout lives and ties
            assert int(want.n_expanded) == r * hp


REPLAYS = {
    "road": Config(amount=3, T_end=1.0, optimizer_type=OptimizerType.TpuSampled,
                   mcts_n_rollouts=64),
    "circle": Config(scenario_type=ScenarioType.circle, amount=3, T_end=1.6,
                     optimizer_type=OptimizerType.TpuSampled,
                     mcts_n_rollouts=64),
}


@pytest.mark.parametrize("name", sorted(REPLAYS))
def test_replayed_inputs_match_reference(name):
    """Every vehicle of every step of a sampled run, planned from the
    reference's captured inputs by both searches (the port's batched over
    the step's vehicles, fed the reference's noise)."""
    cfg = REPLAYS[name].validate()
    mpa_jj = build_mpa(cfg)
    mpa_j = mpa_jj.to_tensors_for(cfg)
    sc_t = create_scenario(cfg, mpa_jj).to_tensors()
    step = jax.jit(make_prioritized_step(cfg, mpa_j, sc_t,
                                         debug_capture=True))
    mpa = convert.mpa_from_numpy(
        {k: np.asarray(v) for k, v in mpa_j._asdict().items()}, device="cpu")
    hp, r, n_trims = cfg.Hp, cfg.mcts_n_rollouts, mpa_j.n_trims

    def ref_plan(k, i, x0, trim0, ref_p, v_ref, polys, mask, segs=None,
                 smask=None):
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(cfg.seed), k), i)
        obs = js.Obstacles(polys=polys,
                           mask=jnp.broadcast_to(mask[:, None],
                                                 (polys.shape[0], hp)))
        return js.plan_trajectory_sampled(
            mpa_j, x0, trim0, ref_p, v_ref, obs, cfg.dt_seconds, r, key,
            boundary_segments=segs, boundary_mask=smask,
            temperature=cfg.mcts_temperature,
            non_convex=cfg.use_non_convex_obstacles)

    in_axes = (None,) + (0,) * (9 if name == "road" else 7)
    ref_plan = jax.jit(jax.vmap(ref_plan, in_axes=in_axes))
    keys_of = jax.jit(lambda k, i: jax.vmap(lambda ii: jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(cfg.seed), k), ii))(i))
    state = initial_state(sc_t, hp)
    n_obstacle_steps = 0
    for k in range(cfg.k_end):
        state, _, cap = step(state, jnp.asarray(k, dtype=jnp.int32))
        cap = {key: np.asarray(v) for key, v in cap.items()}
        idx = np.arange(cap["trim0"].shape[0])
        args = [cap[key] for key in ("pose0", "trim0", "ref_points", "v_ref",
                                     "obs_polys", "obs_mask")]
        if name == "road":
            args += [cap["bnd_segs"], cap["bnd_mask"]]
        want = ref_plan(jnp.int32(k), jnp.asarray(idx, jnp.int32), *args)
        noise = jax_noise(keys_of(jnp.int32(k), jnp.asarray(idx, jnp.int32)),
                          hp, r, n_trims)
        t = [torch.tensor(a) for a in args]
        n_obs = cap["obs_mask"].shape[1]
        got = ts.plan_trajectory_sampled(
            mpa, t[0], t[1].long(), t[2], t[3],
            ts.Obstacles(polys=t[4], mask=t[5][:, :, None].expand(
                -1, n_obs, hp)),
            cfg.dt_seconds, torch.tensor(noise),
            boundary_segments=t[6] if name == "road" else None,
            boundary_mask=t[7] if name == "road" else None,
            temperature=cfg.mcts_temperature,
            non_convex=cfg.use_non_convex_obstacles)
        assert_plans_equal(got, want, f"step {k}")
        n_obstacle_steps += int(cap["obs_mask"].any())
    assert n_obstacle_steps > 0


# ---- twins of tests/test_sampled.py, on the port alone -------------------


def port_plan(free_space, corners, seed, r=128, temperature=0.002):
    """The port's sampled plan of the free-space start against one box,
    with the noise of key PRNGKey(seed)."""
    cfg, _, mpa, hp, eq, x0, ref = free_space
    noise = prng.gumbel(prng.split(prng.prng_key(seed), hp),
                        (r, mpa.n_trims))
    return ts.plan_trajectory_sampled(
        mpa, torch.tensor(x0)[None], torch.tensor([eq]),
        torch.tensor(ref)[None], torch.full((1, hp), 0.8),
        ts.Obstacles(polys=torch.tensor(box(corners, hp))[None],
                     mask=torch.ones((1, 1, hp), dtype=torch.bool)),
        cfg.dt_seconds, noise[None], temperature=temperature)


def test_sampled_plans_are_feasible(free_space):
    """Every plan that is not exhausted takes allowed transitions only and
    no swept area overlaps the obstacle (SAT, touching counts)."""
    _, _, mpa, hp, eq, _, _ = free_space
    pre = precompute_obstacles(torch.tensor(box(BOXES["half"], 1))[:, 0][None],
                               torch.ones((1, 1), dtype=torch.bool))
    n_feasible = 0
    for seed in range(8):
        res = port_plan(free_space, BOXES["half"], seed)
        if bool(res.is_exhausted[0]):
            continue
        n_feasible += 1
        prev = eq
        for k, trim in enumerate(res.trims[0].tolist()):
            assert bool(mpa.transition[k, prev, trim]), (seed, k)
            prev = trim
        shapes = res.shapes[0]                              # [Hp, VA, 2]
        cx = shapes[..., 0].T.contiguous()[None]            # [1, VA, Hp]
        cy = shapes[..., 1].T.contiguous()[None]
        assert not sat_hits_plain(cx, cy, pre).any(), seed
    assert n_feasible > 0


def test_sampled_exhausts_when_fully_blocked(free_space):
    res = port_plan(free_space, BOXES["blocked"], 0, r=64)
    assert bool(res.is_exhausted[0])
    assert float(res.cost[0]) == float("inf")
    assert int(res.n_expanded[0]) == 0


def test_sampled_run_deterministic_per_seed():
    from pdmpc_torch import Config as TConfig
    from pdmpc_torch import OptimizerType as TOpt
    from pdmpc_torch import ScenarioType as TScen
    from pdmpc_torch.experiment import run_experiment

    cfg = TConfig(scenario_type=TScen.circle, amount=3, T_end=1.6,
                  optimizer_type=TOpt.TpuSampled, mcts_n_rollouts=64)
    a = run_experiment(cfg, device="cpu")
    b = run_experiment(cfg, device="cpu")
    np.testing.assert_array_equal(a.infos.poses, b.infos.poses)
    c = run_experiment(dataclasses.replace(cfg, seed=1), device="cpu")
    assert not np.array_equal(a.infos.poses, c.infos.poses)


def test_logits_use_the_reciprocal_product():
    """XLA:CPU compiles the reference's ``-fan_d2 / temperature`` as a
    product with f32(1) / f32(temperature); ``policy_logits`` computes
    that product, and the inputs tell it from an IEEE division."""
    rng = np.random.default_rng(0)
    d2 = (rng.uniform(0, 1, (64, 12)) ** 3).astype(np.float32)
    allowed = rng.random((64, 12)) < 0.7
    for temperature in (0.01, 0.002, 0.0037):
        want = np.asarray(jax.jit(lambda x, a: jnp.where(
            a, -x / temperature, -jnp.inf))(d2, allowed))
        got = ts.policy_logits(torch.tensor(d2), torch.tensor(allowed),
                               temperature).numpy()
        np.testing.assert_array_equal(got, want)
        division = np.where(allowed, -d2 / np.float32(temperature), -np.inf)
        assert (division != want).any(), temperature
    uniform = ts.policy_logits(torch.tensor(d2), torch.tensor(allowed), 0.0)
    assert torch.equal(uniform == 0, torch.tensor(allowed))


def test_fan_placement_of_candidates():
    """The sampled search places its drawn areas with the beam search's
    fused transform: the same polygons as ``candidate_polys`` builds for
    the lattice (bit for bit)."""
    rng = np.random.default_rng(1)
    table = torch.tensor(rng.normal(0, 0.2, (4, 4, 5, 2)), dtype=torch.float32)
    trim = torch.tensor(rng.integers(0, 4, (2, 3)))
    pose = torch.tensor(rng.uniform(-2, 2, (2, 3, 3)), dtype=torch.float32)
    c, s = torch.cos(pose[..., 2:]), torch.sin(pose[..., 2:])
    cx, cy = candidate_polys(table, trim, pose, c, s)       # [V, VA, 3*4]
    child = torch.tensor(rng.integers(0, 4, (2, 3)))
    px, py = ts._placed(table[trim, child], pose, c, s)     # [V, VA, 3]
    flat = torch.arange(3) * 4 + child                      # [V, 3]
    assert torch.equal(px, cx.gather(2, flat[:, None].expand(-1, 5, -1)))
    assert torch.equal(py, cy.gather(2, flat[:, None].expand(-1, 5, -1)))
