"""The port's graft entry and tools on the CPU: ``graft_entry`` (one step
of the 8-vehicle circle at B = 4, and the sharded dry run on two gloo
ranks), ``tools.axis_sweep`` (two cases, and a case that raises),
``tools.nonconvex_delta`` at smoke size, ``tools.speed_of_light``'s counts
(by hand, and chip_smoke.py phase 2's bounds on its seeded inputs) and its
refusal of a card it has no peaks for, and ``utils.filenames``'
``mpa_library_dir``.

Exact where the port is held to itself: the entry's records equal
``run_experiment``'s first step of the same configuration bit for bit;
the bounds equal hand counts to float rounding (rel 1e-12) and phase 2's
printed bounds to their printed digits.
"""

import json
import os
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pdmpc_torch import Config, ScenarioType
from pdmpc_torch.ops import collision as coll
from pdmpc_torch.tools import axis_sweep, nonconvex_delta
from pdmpc_torch.tools import speed_of_light as sol

torch.set_num_threads(1)

H100 = sol.PEAKS["NVIDIA H100 80GB HBM3"]


def test_graft_entry_step_equals_run_experiment():
    from pdmpc_torch import graft_entry
    from pdmpc_torch.experiment import run_experiment

    fn, (states, k, mpa_t, sc_t) = graft_entry.entry(device="cpu")
    assert states.pose.shape == (4, 8, 3) and k == 0
    _, info = fn(states, k, mpa_t, sc_t)
    cfg = Config(scenario_type=ScenarioType.circle, amount=8, T_end=2.0,
                 beam_width=256)
    res = run_experiment(replace(cfg, T_end=cfg.dt_seconds), device="cpu")
    for field in info._fields:
        got = getattr(info, field).numpy()
        want = getattr(res.infos, field)[0]
        assert got.shape == (4, *want.shape), field
        for b in range(4):
            np.testing.assert_array_equal(got[b], want, err_msg=field)


def test_dryrun_multichip_on_two_cpu_ranks():
    from pdmpc_torch import graft_entry

    assert graft_entry._mesh_shape(2, 4) == (1, 2)
    assert graft_entry._mesh_shape(8, 4) == (2, 4)
    assert graft_entry._mesh_shape(3, 4) == (3, 1)
    graft_entry.dryrun_multichip(2, device="cpu")


def test_dryrun_multichip_never_shares_a_card_unasked(monkeypatch):
    """Fewer cards than ranks: NCCL is refused and gloo is not picked
    unasked; no rank starts."""
    from pdmpc_torch import graft_entry
    from pdmpc_torch.parallel import multihost

    def no_spawn(*args, **kwargs):
        raise AssertionError("a rank started")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(multihost, "spawn", no_spawn)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="a card a rank"):
        graft_entry.dryrun_multichip(2, backend="nccl")


def sweep_lines(capsys):
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    return {k: v for line in lines for k, v in line.items()}


def test_axis_sweep_cases_on_the_cpu(capsys):
    names = ["triple_cr3", "centralized_circle3"]
    assert len(axis_sweep.sweep_cases()) == 13
    assert axis_sweep.main(["--cases", ",".join(names), "--device",
                            "cpu"]) == 0
    out = sweep_lines(capsys)
    assert out["summary"] == {"cases": 2, "failures": 0, "device": "cpu"}
    for name in names:
        rec = out[name]
        assert rec["ok"] and rec["steps"] == 5, rec
        assert 0.0 <= rec["fallback_rate"] <= 1.0
        # a kernel counts only its launches on the card
        assert rec["launches"] == {k: 0 for k in axis_sweep.KERNELS}
        assert rec["lattice_launches"] == {k: 0 for k in axis_sweep.FORMS}
        assert rec["warnings"] == []


def test_axis_sweep_reports_a_failing_case(capsys, monkeypatch):
    def run(cfg, device):
        if cfg.amount == 8:
            raise RuntimeError("injected failure")
        return SimpleNamespace(infos=SimpleNamespace(
            needs_fallback=np.zeros((5, cfg.amount), dtype=bool)),
            n_steps=5)

    monkeypatch.setattr(axis_sweep, "run_experiment", run)
    assert axis_sweep.main(["--cases", "mixed8,triple_cr3", "--device",
                            "cpu"]) == 1
    out = sweep_lines(capsys)
    assert out["mixed8"]["ok"] is False
    assert out["mixed8"]["error"] == "RuntimeError"
    assert "injected failure" in out["mixed8"]["detail"]
    assert out["triple_cr3"]["ok"] is True
    assert out["summary"]["failures"] == 1
    with pytest.raises(SystemExit):
        axis_sweep.main(["--cases", "no_such_case", "--device", "cpu"])


def test_nonconvex_delta_at_smoke_size(capsys):
    assert nonconvex_delta.main(["--amount", "3", "--t-end", "0.4",
                                 "--beam-width", "16", "--device",
                                 "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"convex", "non_convex", "device"}
    for geometry in nonconvex_delta.GEOMETRIES:
        rec = out[geometry]
        assert set(rec) == {
            "couplings_mean_per_step", "fallback_rate", "exhausted_rate",
            "mean_cost", "mean_distance_traveled_m", "wall_s_incl_setup",
            "steps", "launches"}
        assert rec["steps"] == 2
        assert rec["mean_distance_traveled_m"] > 0.0
        assert rec["launches"] == {k: 0 for k in nonconvex_delta.KERNELS
                                   + nonconvex_delta.FORMS}


def test_speed_of_light_counts_by_hand():
    peak = sol.Peak(f32_ops=1e6, bytes_per_s=2e6)
    # roofline: 3,000 operations (3 ms) against 4,000 bytes (2 ms)
    assert sol.roofline(3000, 4000, peak) == (3.0, "operations")
    assert sol.roofline(1000, 4000, peak) == (2.0, "bytes")

    # crossing: 3 live candidates, one without a hit (4 edges x 10 active
    # segments), two with one (one pair each): (40 + 2) x 25 operations;
    # 1,000 bytes read and a byte a candidate written
    live = torch.tensor([[True, True, True, False]])
    free = torch.tensor([[True, False, False, False]])
    ms, by = sol.crossing_bound(live, free, torch.tensor([10]), 4, 1000,
                                peak)
    assert (ms, by) == (pytest.approx(42 * 25 / 1e3, rel=1e-12),
                        "operations")

    # SAT: a triangle (3 distinct vertices) without a hit, a square (4)
    # with one, against one active box of 4 distinct vertices padded to 6
    # (4 non-zero axes) and one masked obstacle. Own axes k * (8 + 4k):
    # 60 and 96; the free one's test on one axis of the box: 3 * 4 + 4 =
    # 16; the hit's full test: 4 * (4 * 4 + 4) + 4 * (4 * 4 + 4) = 160.
    tri = [[0, 0], [1, 0], [0, 1], [0, 1]]
    sq = [[5, 5], [6, 5], [6, 6], [5, 6]]
    cand = torch.tensor([[tri, sq]], dtype=torch.float32)   # [1, 2, 4, 2]
    box = [[5.5, 5.5], [7, 5.5], [7, 7], [5.5, 7], [5.5, 7], [5.5, 7]]
    pre = coll.precompute_obstacles(
        torch.tensor([[box, box]], dtype=torch.float32),
        torch.tensor([[True, False]]))
    verts = sol.distinct_vertices(cand[..., 0], cand[..., 1])
    assert verts.tolist() == [[3, 4]]
    live = torch.tensor([[True, True]])
    free = torch.tensor([[True, False]])
    ms, by = sol.sat_bound(live, free, verts, pre, 0, peak)
    assert ms == pytest.approx((60 + 96 + 16 + 160) / 1e3, rel=1e-12)
    # bytes: the mask (32 slots of i32) and 6 fields x 6 vertices x 4
    # bytes of the active obstacle
    assert sol.sat_bundle_bytes(pre) == 32 * 4 + 6 * 6 * 4

    # expansion: 1 vehicle x 2 parents x 3 trims x 4 vertices, 7
    # operations a vertex; bytes: the table (3 x 3 x 4 x 2 f32), trims
    # (i64), poses (3 f32), c and s, then cx and cy written
    lat = coll.Lattice(torch.zeros(3, 3, 4, 2), torch.zeros(1, 2,
                                                            dtype=torch.long),
                       torch.zeros(1, 2, 3), torch.ones(1, 2, 1),
                       torch.zeros(1, 2, 1))
    n_bytes = 3 * 3 * 4 * 2 * 4 + 2 * (8 + 12 + 8) + 24 * 2 * 4
    assert sol.expansion_bound(lat, peak) == (
        pytest.approx(n_bytes / 2e3, rel=1e-12), "bytes")
    assert sol.layer_candidates(256, 12, 6) == [12, 144, 1728, 3072, 3072,
                                                3072]


def test_chip_smoke_phase2_bounds_unchanged():
    """The yardstick chip_smoke.py reads: phase 2's bounds on its seeded
    inputs, from the plain versions' masks here, equal the bounds it
    printed on the H100 (PERF.md, Findings) to their printed digits."""
    import chip_smoke as cs

    cx, cy, obs, obs_mask, segs, seg_mask = cs.kernel_inputs(torch, "cpu")
    out_pre = coll.precompute_outline(obs, obs_mask)
    seg_pre = coll.precompute_segments(segs, seg_mask)
    sx, sy, s_obs, s_mask = cs.sat_inputs(torch, "cpu")
    sat_pre = coll.precompute_obstacles(s_obs, s_mask)
    hit = coll.outline_hits_plain(cx, cy, out_pre)
    live = torch.ones_like(hit)
    got = sol.crossing_bound(live, ~hit, out_pre.edge_ok.sum(dim=(1, 2)),
                             cs.VA, 4 * (cx.numel() * 2
                                         + out_pre.ox.numel() * 3), H100)
    assert (round(got[0], 7), got[1]) == (0.0037561, "operations")
    hit = coll.boundary_hits_plain(cx, cy, seg_pre)
    got = sol.crossing_bound(live, ~hit, seg_pre.mask.sum(dim=1), cs.VA,
                             4 * (cx.numel() * 2 + seg_pre.packed.numel()
                                  + seg_pre.mask.numel()), H100)
    assert (round(got[0], 8), got[1]) == (0.00069830, "operations")
    hit = coll.sat_hits_plain(sx, sy, sat_pre)
    got = sol.sat_bound(torch.ones_like(hit), ~hit, sol.distinct_vertices(
        sx.transpose(1, 2), sy.transpose(1, 2)), sat_pre,
        4 * sx.numel() * 2 + sol.sat_bundle_bytes(sat_pre), H100)
    assert (round(got[0], 8), got[1]) == (0.00015494, "bytes")


def test_speed_of_light_inputs_at_production_shapes():
    """The cr20 production shapes the tool times, built here on the CPU,
    and each kernel's plain version on them: some live candidates hit,
    most do not."""
    inp = sol.build_inputs("cpu")
    assert inp.live.shape == (2, 256, 12)
    assert 0.2 < float(inp.live.float().mean()) < 0.6
    assert inp.road.table.shape[:2] == (12, 12)
    assert inp.outline_pre.mask.shape[-1] % 8 == 0
    assert (inp.obstacles_pre.mask.sum(dim=1) == 38).all()   # own masked
    assert (inp.segments_pre.mask.sum(dim=1) > 0).all()
    for fn, lat, pre in (
            (coll.outline_hits_lattice_plain, inp.road, inp.outline_pre),
            (coll.boundary_hits_lattice_plain, inp.boundary,
             inp.segments_pre),
            (coll.sat_hits_lattice_plain, inp.convex, inp.obstacles_pre)):
        feasible = fn(lat, inp.live, pre)
        assert 0 < int(feasible.sum()) < int(inp.live.sum())


def test_speed_of_light_refuses_unknown_cards_and_the_cpu():
    with pytest.raises(ValueError, match="no published peaks"):
        sol.card_peak("NVIDIA GeForce RTX 4090")
    assert sol.card_peak("NVIDIA H100 80GB HBM3") == H100
    with pytest.raises(RuntimeError, match="times the card"):
        sol.measure(device="cpu")


def test_mpa_library_dir_is_the_ports():
    import pdmpc_torch.models.mpa as tmpa
    from pdmpc_torch.utils.filenames import mpa_library_dir
    from pdmpc_tpu.utils.filenames import mpa_library_dir as jax_dir

    got = mpa_library_dir()
    assert got == os.path.join(os.path.dirname(tmpa.__file__), "library")
    assert got != jax_dir()
    assert os.path.basename(jax_dir()) == os.path.basename(got)
