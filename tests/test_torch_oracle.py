"""The port's A* oracle (pdmpc_torch/utils/astar_oracle.py and native/)
and the debug-capture step (``make_prioritized_step(...,
debug_capture=True)``), against pdmpc_tpu's: the twins of
tests/test_native.py and tests/test_oracle_replay.py.

- On the inputs of tests/test_native.py (free space, an obstacle, boxed
  in) the port's numpy oracle returns the reference oracle's plan (trims,
  poses, cost, exhaustion, expansions equal), and the port's native
  oracle, built with g++ into ``pdmpc_torch/_build/``, agrees with it.
- The port's cr3 golden run with ``debug_capture`` records the
  reference's capture step by step: every mask, index, trim and pose0
  equal, ``v_ref`` equal, the obstacle snapshots and reference points a
  few ulps apart (XLA:CPU's vectorized cos and sin differ from torch's:
  the rotated reachable sets part by at most 3.5 ulps of 4 m, the
  reference points by 2 ulps); with the capture on, the run still meets
  its CPU golden (``commonroad_03veh``) exactly, as without it.
- Every plan of the port's cr3 replay is oracle-optimal over the
  identical constraint set (non-convex outlines and lanelet boundaries),
  and the native oracle returns the numpy oracle's optimum on step 5.
"""

import functools
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdmpc_torch
import pdmpc_torch.config as tc
import pdmpc_tpu.config as jc
from pdmpc_torch.controller import make_prioritized_step
from pdmpc_torch.experiment import ExperimentResult, create_scenario
from pdmpc_torch.models.mpa import build_mpa
from pdmpc_torch.native import astar_plan_native, compile_native
from pdmpc_torch.parallel.sharded import batched_initial_state
from pdmpc_torch.utils.astar_oracle import astar_plan

# One intra-op thread per process, as the other port files.
torch.set_num_threads(1)

DT = 0.2
# capture fields a few ulps apart, and their tolerance
ULP_FIELDS = {"obs_polys": 2.4e-6, "ref_points": 1e-6}


def single_speed(module):
    from importlib import import_module

    cfg = module.Config(scenario_type=module.ScenarioType.circle,
                        mpa_type=module.MpaType.single_speed)
    return import_module(module.__name__.replace(
        ".config", ".models.mpa")).build_mpa(cfg)


def free_space_inputs(obstacle):
    """The planning inputs of tests/test_native.py: a straight reference
    at 0.8 m/s, and no obstacle, a box ahead, or a box around."""
    ref = np.stack([np.cumsum(np.full(6, 0.16)), np.zeros(6)], axis=-1)
    box = {"none": None,
           "ahead": [[0.35, -0.15], [0.65, -0.15], [0.65, 0.15],
                     [0.35, 0.15]],
           "boxed_in": [[-60.0, -60.0], [60.0, -60.0], [60.0, 60.0],
                        [-60.0, 60.0]]}[obstacle]
    obs = (np.zeros((1, 6, 4, 2)) if box is None
           else np.tile(np.array([box])[:, None], (1, 6, 1, 1)))
    mask = np.full((1, 6), box is not None)
    return dict(x0=np.zeros(3), trim0=6, ref_points=ref,
                v_ref=np.full(6, 0.8), obs_polys=obs, obs_mask=mask, dt=DT)


def assert_same_plan(got, want, exact=True):
    np.testing.assert_array_equal(got.trims, want.trims)
    assert got.is_exhausted == want.is_exhausted
    if exact:
        np.testing.assert_array_equal(got.poses, want.poses)
        assert got.cost == want.cost
        assert got.n_expanded == want.n_expanded
    elif not want.is_exhausted:
        np.testing.assert_allclose(got.poses, want.poses, atol=1e-12)
        assert got.cost == pytest.approx(want.cost, rel=1e-9)


@pytest.mark.parametrize("obstacle", ["none", "ahead", "boxed_in"])
def test_oracle_matches_reference_and_native(obstacle):
    from pdmpc_tpu.utils.astar_oracle import astar_plan as j_astar_plan

    kw = free_space_inputs(obstacle)
    got = astar_plan(single_speed(tc), **kw)
    assert_same_plan(got, j_astar_plan(single_speed(jc), **kw))
    assert got.is_exhausted == (obstacle == "boxed_in")
    assert_same_plan(astar_plan_native(single_speed(tc), **kw), got,
                     exact=False)


def test_native_builds_into_the_ports_build_directory():
    path = compile_native()
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(os.path.abspath(pdmpc_torch.__file__)), "_build")
    assert os.path.getsize(path) > 1000
    assert compile_native() == path


def test_compile_native_force_rebuilds(tmp_path, monkeypatch):
    """``force`` builds the library again even where it exists (a new
    file at the same content-hashed path); ``native_available`` loads
    it."""
    from pdmpc_torch import native
    from pdmpc_tpu.native import native_available as jax_native_available

    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    path = native.compile_native()
    assert os.path.dirname(path) == str(tmp_path)
    first = os.stat(path)
    assert native.compile_native() == path
    assert os.stat(path).st_ino == first.st_ino          # not rebuilt
    assert native.compile_native(force=True) == path
    assert os.stat(path).st_ino != first.st_ino          # rebuilt
    monkeypatch.setattr(native, "_lib", None)
    assert native.native_available() and jax_native_available()


@pytest.mark.parametrize("fault", ["compile_error", "no_compiler"])
def test_native_available_false_when_gxx_fails(tmp_path, monkeypatch,
                                                 fault):
    from pdmpc_torch import native

    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    if fault == "compile_error":
        broken = tmp_path / "astar.cpp"
        broken.write_text("this is not C++\n")
        monkeypatch.setattr(native, "_SRC", str(broken))
    else:
        monkeypatch.setenv("PATH", str(tmp_path))        # no g++ on it
    assert native.native_available() is False
    assert native._lib is None
    with pytest.raises(RuntimeError if fault == "compile_error"
                       else FileNotFoundError):
        native.compile_native()


@functools.cache
def port_replay():
    """The port's cr3 golden run, step by step with debug_capture: (mpa,
    configuration, [(records, capture)] a step)."""
    cfg = tc.Config(amount=3, T_end=4.0, beam_width=64).validate()
    mpa = build_mpa(cfg)
    mpa_t = mpa.to_tensors_for(cfg, "cpu")
    sc_t = create_scenario(cfg, mpa).to_tensors("cpu")
    step = make_prioritized_step(cfg, mpa_t, sc_t, debug_capture=True)
    state = batched_initial_state(sc_t, cfg.Hp, 1)
    steps = []
    for k in range(cfg.k_end):
        state, info, cap = step(state, k)
        steps.append((type(info)(*(x[0].numpy() for x in info)),
                      {key: v.numpy() for key, v in cap.items()}))
    return mpa, cfg, steps


def test_capture_matches_reference():
    from pdmpc_tpu.controller import initial_state
    from pdmpc_tpu.controller import make_prioritized_step as j_step
    from pdmpc_tpu.experiment import create_scenario as j_scenario
    from pdmpc_tpu.models.mpa import build_mpa as j_mpa

    from tests.golden import compare_golden

    _, _, steps = port_replay()
    cfg = jc.Config(amount=3, T_end=4.0, beam_width=64).validate()
    mpa_t = j_mpa(cfg).to_tensors_for(cfg)
    sc_t = j_scenario(cfg, j_mpa(cfg)).to_tensors()
    step = jax.jit(j_step(cfg, mpa_t, sc_t, debug_capture=True))
    state = initial_state(sc_t, cfg.Hp)
    for k, (_, cap) in enumerate(steps):
        state, _, want = step(state, jnp.asarray(k, dtype=jnp.int32))
        assert cap.keys() == want.keys(), k
        for key, value in cap.items():
            ref = np.asarray(want[key])
            assert value.shape == ref.shape, (k, key)
            if key in ULP_FIELDS:
                np.testing.assert_allclose(value, ref, rtol=0,
                                           atol=ULP_FIELDS[key],
                                           err_msg=f"step {k}: {key}")
            else:
                np.testing.assert_array_equal(value, ref,
                                              err_msg=f"step {k}: {key}")
    infos = type(steps[0][0])(*(np.stack(f) for f in zip(
        *(info for info, _ in steps))))
    compare_golden("commonroad_03veh", ExperimentResult(
        options=cfg, infos=infos, final_state=None))


def test_capture_refuses_what_it_cannot_record():
    from pdmpc_torch.parallel.comm import LocalComm

    cfg = tc.Config(scenario_type=tc.ScenarioType.circle, amount=2,
                    T_end=0.4, beam_width=8).validate()
    mpa = build_mpa(cfg)
    mpa_t = mpa.to_tensors_for(cfg, "cpu")
    sc_t = create_scenario(cfg, mpa).to_tensors("cpu")
    with pytest.raises(ValueError, match="debug_capture"):
        make_prioritized_step(
            replace(cfg, priority=tc.PriorityStrategies.optimal_priority),
            mpa_t, sc_t, debug_capture=True)
    with pytest.raises(ValueError, match="debug_capture"):
        make_prioritized_step(cfg, mpa_t, sc_t, LocalComm(2),
                              debug_capture=True)
    step = make_prioritized_step(cfg, mpa_t, sc_t, debug_capture=True)
    with pytest.raises(ValueError, match="batch of one"):
        step(batched_initial_state(sc_t, cfg.Hp, 2), 0)
    _, _, cap = step(batched_initial_state(sc_t, cfg.Hp, 1), 0)
    assert "bnd_segs" not in cap and cap["obs_polys"].shape[:2] == (2, 6)


def oracle_inputs(cfg, cap, v):
    obs_polys = cap["obs_polys"][v]                  # [n_obs, Hp, VO, 2]
    return dict(
        x0=cap["pose0"][v], trim0=int(cap["trim0"][v]),
        ref_points=cap["ref_points"][v], v_ref=cap["v_ref"][v],
        obs_polys=obs_polys,
        obs_mask=np.broadcast_to(cap["obs_mask"][v][:, None],
                                 (obs_polys.shape[0], cfg.Hp)),
        dt=cfg.dt_seconds, boundary_segments=cap["bnd_segs"][v],
        boundary_mask=cap["bnd_mask"][v], non_convex=True)


def test_every_plan_is_oracle_optimal():
    """Per (step, vehicle): the beam plan's cost equals the independent
    A* optimum over the identical constraint set, with the same trims."""
    mpa, cfg, steps = port_replay()
    checked = 0
    for k, (info, cap) in enumerate(steps):
        for v in range(cfg.amount):
            if info.needs_fallback[v] or info.is_exhausted[v]:
                continue
            oracle = astar_plan(mpa, **oracle_inputs(cfg, cap, v))
            assert not oracle.is_exhausted, (k, v)
            beam_cost = float(info.cost[v])
            # the f64 exhaustive oracle is never worse than the f32 beam;
            # beam 64 on the 12-trim lattice finds the optimum
            assert oracle.cost <= beam_cost * (1 + 1e-4) + 1e-6, (k, v)
            assert (beam_cost - oracle.cost) / max(oracle.cost, 1e-9) \
                <= 1e-3, (k, v)
            np.testing.assert_array_equal(info.trims[v], oracle.trims,
                                          err_msg=f"step {k} vehicle {v}")
            checked += 1
    assert checked >= 40, checked


def test_native_oracle_agrees_on_road_path():
    mpa, cfg, steps = port_replay()
    info, cap = steps[5]
    for v in range(cfg.amount):
        if info.needs_fallback[v] or info.is_exhausted[v]:
            continue
        kw = oracle_inputs(cfg, cap, v)
        assert_same_plan(astar_plan_native(mpa, **kw), astar_plan(mpa, **kw),
                         exact=False)
