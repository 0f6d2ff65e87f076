"""The port's beam search against the reference's on the reference's own
planning inputs.

Two runs are replayed step by step through pdmpc_tpu's
``make_prioritized_step(..., debug_capture=True)``, which records every
vehicle's exact planning inputs (pose, trim, reference samples, the
obstacle snapshot it planned against and its mask, boundary segments where
there is a road): the cr3 golden scenario (road, outline crossing) and the
circle Hp-10 golden scenario (free space, SAT). For every step, the port's
``plan_trajectory`` plans all vehicles in one batched call, on tables
carried over with ``convert.mpa_from_numpy``, and is compared with
pdmpc_tpu's ``plan_trajectory(use_pallas=False)`` (the XLA path the CPU
goldens come from): trims, ``is_exhausted``, ``n_expanded`` and the cost
equal bit for bit (the port fuses the multiply-adds that XLA:CPU contracts:
child poses, candidate areas, step costs), poses and swept shapes within
two ulps (rtol 2.4e-7).

Why not exact poses: XLA:CPU's vectorized f32 cos and sin differ from
torch's in some 5% of inputs (``python -m tests.test_torch_numerics``),
so a yaw's cosine can be an ulp apart. In these replays that leaves a few
pose and swept-shape entries one or two ulps apart, and no decision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdmpc_torch import convert
from pdmpc_torch.ops import collision as tc
from pdmpc_torch.ops import search as tsearch
from pdmpc_tpu.config import Config, ScenarioType
from pdmpc_tpu.controller import initial_state, make_prioritized_step
from pdmpc_tpu.experiment import create_scenario
from pdmpc_tpu.models.mpa import build_mpa
from pdmpc_tpu.ops import search as jsearch

# One intra-op thread per process: the suite runs in several pytest
# workers at once, and a full torch thread pool in each of them
# oversubscribes the cores (a file that takes seconds alone then takes
# minutes).
torch.set_num_threads(1)

CONFIGS = {
    "cr3": Config(amount=3, T_end=4.0, beam_width=64),
    "circle_hp10": Config(scenario_type=ScenarioType.circle, amount=3,
                          T_end=2.0, Hp=10, beam_width=128),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def replay(request):
    cfg = CONFIGS[request.param].validate()
    mpa = build_mpa(cfg)
    mpa_t = mpa.to_tensors_for(cfg)
    sc_t = create_scenario(cfg, mpa).to_tensors()
    step = jax.jit(make_prioritized_step(cfg, mpa_t, sc_t,
                                         debug_capture=True))
    state = initial_state(sc_t, cfg.Hp)
    caps = []
    for k in range(cfg.k_end):
        state, _, cap = step(state, jnp.asarray(k, dtype=jnp.int32))
        caps.append({kk: np.asarray(v) for kk, v in cap.items()})
    return cfg, mpa_t, caps


def _reference_planner(cfg, mpa_j, cap):
    """pdmpc_tpu's XLA-path planner for all vehicles of a captured step,
    jitted; call it on the capture."""
    hp = cfg.Hp

    def ref_plan(x0, trim0, ref_p, v_ref, polys, mask, segs=None,
                 smask=None):
        obs = jsearch.Obstacles(polys=polys, mask=jnp.broadcast_to(
            mask[:, None], (polys.shape[0], hp)))
        return jsearch.plan_trajectory(
            mpa_j, x0, trim0, ref_p, v_ref, obs, cfg.dt_seconds,
            cfg.beam_width, boundary_segments=segs, boundary_mask=smask,
            use_pallas=False, non_convex=cfg.use_non_convex_obstacles)

    ref_plan = jax.jit(jax.vmap(ref_plan))
    keys = ["pose0", "trim0", "ref_points", "v_ref", "obs_polys", "obs_mask"]
    if "bnd_segs" in cap:
        keys += ["bnd_segs", "bnd_mask"]
    return lambda c: ref_plan(*(c[key] for key in keys))


def _port_plan(cfg, mpa, cap):
    """The port's plan of all vehicles of a captured step, on the CPU."""
    t = {key: torch.tensor(cap[key]) for key in cap}
    n_obs = cap["obs_mask"].shape[1]
    return tsearch.plan_trajectory(
        mpa, t["pose0"], t["trim0"].long(), t["ref_points"], t["v_ref"],
        tsearch.Obstacles(polys=t["obs_polys"], mask=t["obs_mask"][
            :, :, None].expand(-1, n_obs, cfg.Hp)),
        cfg.dt_seconds, cfg.beam_width,
        boundary_segments=t.get("bnd_segs"),
        boundary_mask=t.get("bnd_mask"),
        non_convex=cfg.use_non_convex_obstacles)


def test_plans_match_reference(replay):
    cfg, mpa_j, caps = replay
    mpa = convert.mpa_from_numpy(
        {k: np.asarray(v) for k, v in mpa_j._asdict().items()}, device="cpu")
    ref_plan = _reference_planner(cfg, mpa_j, caps[0])
    n_checked = n_hit_obstacles = n_pruned = 0
    for k, cap in enumerate(caps):
        want = ref_plan(cap)
        got = _port_plan(cfg, mpa, cap)
        msg = f"step {k}"
        for field in ("trims", "is_exhausted", "n_expanded", "cost"):
            np.testing.assert_array_equal(
                getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                err_msg=f"{msg}: {field}")
        for field in ("poses", "shapes"):
            np.testing.assert_allclose(
                getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                rtol=2.4e-7, atol=1e-12, err_msg=f"{msg}: {field}")
        n_checked += len(cap["trim0"])
        n_hit_obstacles += int(cap["obs_mask"].any(axis=1).sum())
        n_pruned += int((np.asarray(want.n_expanded) > cfg.beam_width).sum())
    assert n_checked == 3 * cfg.k_end
    # the replay exercises the obstacle path and the pruning top-k
    assert n_hit_obstacles > 0
    assert n_pruned > 0


def test_cost_to_go_matches_reference():
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 4, size=(2, 5, 12, 2)).astype(np.float32)
    ref = rng.uniform(0, 4, size=(2, 6, 2)).astype(np.float32)
    v_ref = rng.uniform(0, 0.8, size=(2, 6)).astype(np.float32)
    for k in range(6):
        want = jax.vmap(lambda p, r, v: jsearch._cost_to_go(p, r, v, k, 0.2))(
            pos, ref, v_ref)
        got = tsearch._cost_to_go(torch.as_tensor(pos), torch.as_tensor(ref),
                                  torch.as_tensor(v_ref), k, 0.2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


def test_collision_checks_per_layer(replay, monkeypatch):
    """Each search layer masks its candidates with one call of each check
    that applies, in its lattice form: on the road the outline and
    boundary kernels', the outline result passed on as the boundary
    check's live mask; on the circle the SAT kernel's and no crossing
    kernel's. The search builds no candidate tensors itself: every call of
    ``candidate_polys`` comes from inside a collision wrapper (their plain
    versions on the CPU). The plan so made is the reference's XLA-path
    plan."""
    cfg, mpa_j, caps = replay
    mpa = convert.mpa_from_numpy(
        {k: np.asarray(v) for k, v in mpa_j._asdict().items()}, device="cpu")
    hp = cfg.Hp
    cap = max(caps, key=lambda c: int(c["obs_mask"].sum()))

    polys_calls = {"all": 0, "in_wrappers": 0}

    def counted(*args, _fn=tc.candidate_polys):
        polys_calls["all"] += 1
        return _fn(*args)

    monkeypatch.setattr(tc, "candidate_polys", counted)
    names = ("outline_hits_lattice", "boundary_hits_lattice",
             "sat_hits_lattice", "outline_hits", "boundary_hits", "sat_hits")
    calls = {name: [] for name in names}
    for name in names:
        def recorded(*args, _name=name, _fn=getattr(tsearch, name)):
            before = polys_calls["all"]
            out = _fn(*args)
            polys_calls["in_wrappers"] += polys_calls["all"] - before
            calls[_name].append((args, out))
            return out
        monkeypatch.setattr(tsearch, name, recorded)
    got = _port_plan(cfg, mpa, cap)
    road = "bnd_segs" in cap
    assert {name: len(c) for name, c in calls.items()} == {
        "outline_hits_lattice": hp if road else 0,
        "boundary_hits_lattice": hp if road else 0,
        "sat_hits_lattice": 0 if road else hp,
        "outline_hits": 0, "boundary_hits": 0, "sat_hits": 0}
    for (_, outline), (args, _) in zip(calls["outline_hits_lattice"],
                                       calls["boundary_hits_lattice"]):
        assert args[1] is outline
    assert polys_calls["all"] == polys_calls["in_wrappers"] > 0

    want = _reference_planner(cfg, mpa_j, cap)(cap)
    for field in ("trims", "is_exhausted", "n_expanded", "cost"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            err_msg=field)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses),
                               rtol=2.4e-7, atol=1e-12)
