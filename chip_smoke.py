#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pdmpc_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, any failure exits non-zero:
1. identify the card, build the CUDA kernels from pdmpc_torch/csrc/;
2. hold each kernel against its plain PyTorch version (exact mask
   equality) and time both with CUDA events (device time: calls queued
   behind a sleep kernel; also the time a call with its host part): the
   outline and boundary kernels' (cx, cy) form on random polygons with
   exact touches at the road path's widths, all candidates live (as the
   kernels' earlier designs were timed) and with a live mask at the road
   MPA's 37.5%; the SAT kernel's (cx, cy) form at the circle path's
   shapes, all live and 37.5% live, and its lattice form on a layer of
   512 parents x 12 successors, all live and 37.5% live;
3. road path — run_experiment on the default 20-vehicle CommonRoad
   configuration (beam 512, 20 steps) — with every kernel's launch counter
   zeroed just before and read just after: the outline and boundary
   kernels must launch, the SAT kernel must not; the run must be
   collision-free, moving and mostly fallback-free;
4. road golden gate: the beam-64 run against tests/expected_results/
   commonroad_20veh.npz (same fallback pattern, total cost within 1%, and
   an exact match: trims and levels equal, poses within 1e-4);
5. convex path — run_experiment on the 10-vehicle circle (beam 512, Hp 6,
   40 steps, the largest point of the reference's circle sweep), counters
   zeroed again: the SAT kernel must launch and the road kernels must not;
   collision-free, every vehicle moves more than 0.3 m;
6. convex golden gate: circle_03veh_hp10 (Hp 10, beam 128) against its
   golden, the same gate;
7. plan level: one recorded planning chunk of each path planned twice,
   with the kernels and with their plain versions swapped in; the trims,
   costs and poses must be equal;
8. path shapes: every search layer's lattice-form call of the outline
   and boundary kernels in phase 7's road plan, and of the SAT kernel in
   its circle plan, held bit for bit against its plain version on the
   same inputs and timed beside it;
9. headline: cr20 with coloring priorities at beam 256 (20 steps), the
   repo's headline configuration, counters zeroed: the road kernels must
   launch and SAT must not; collision-free, on the road, every vehicle
   moves more than 0.3 m, fallback share < 0.5; then bench.py's gate
   against tests/expected_results/commonroad_20veh_coloring_tpu.npz
   (same fallback pattern, total cost within 1%), with whether trims and
   levels match exactly printed;
10. mixed fleet: 64 vehicles (40 road, 24 free-space), beam 128, 10
   steps, bench.py's configuration: collision-free, every vehicle moves
   more than 0.2 m, road vehicles on the road, the road kernels launch;
   then its fullest chunk planned with kernels and with plain versions,
   and every layer's lattice-form call of the road kernels held bit for
   bit (the outline kernel's whole 3,072-edge stage; free-space vehicles
   with no active boundary segment);
11. strategy goldens: the gate of phase 4 for the matrix cells mx01
   (coloring), mx06 (optimal voting, full coupling, realistic MPA), mx07
   (explorative voting), mx08 (FCA, distance coupling) and mixed_16veh,
   with each run's launches checked (road kernels on road and mixed runs,
   SAT on circle runs);
12. voting: cr20 at beam 512 for 10 steps with constant, optimal (16
   orientations a step) and explorative priorities: collision-free; the
   step medians and the optimal and explorative ones' factors over the
   constant one printed;
13. stage rounds: phase 2's comparison on bundles past one 48 KB stage
   (outline 256 and 1,024 obstacles of 16 vertices, boundary 4,096 and
   16,384 segments, SAT 128 and 640 obstacles), bit for bit at three
   stage budgets and timed at each; then the 40-vehicle circle (120 SAT
   obstacles, 128 padded) at beam 128, collision-free, and its fullest
   chunk planned with kernels and with plain versions, every layer held;
14. the slice at full width: cr20 with random priorities and weights
   (beam 512, 20 steps; the lattice forms launch), cr20 with the sampled
   search (256 rollouts, 20 steps; the road kernels' (cx, cy) forms
   launch, their lattice forms do not) and the 10-vehicle circle sampled
   (40 steps; SAT's (cx, cy) form): collision-free, every vehicle moves
   more than 0.3 m, road vehicles on the road; then one sampled chunk of
   each path with kernels and with plain versions, every layer's (cx, cy)
   call held bit for bit and timed;
15. the matrix goldens with random strategies or the sampled search:
   mx03, mx10, mx11 and mx13 must match exactly, the six sampled cells
   (mx02, mx04, mx05, mx09, mx12, mx14) must meet the gate and whether
   they match exactly is printed; each run's launches checked;
16. batched rollouts, B scenarios planned in one merged chunk loop a
   step: (a) bench.py's headline shape, 32 identical starts of phase 9's
   configuration, every entry equal to entry 0 and entry 0 to phase 9's
   run bit for bit, phase 9's gate; (b) ``monte_carlo_sweep`` of the
   same configuration, 32 starts shifted up to 1 m along their paths,
   every entry collision-free, moving and on the map's lanelets (but a
   pair whose shifted starts overlap, and the vehicles that the
   reference too drives off the map, KNOWN_OFF_MAP), at least two level
   sequences, four entries run alone and held bit for bit; (c)
   bench.py's curve shape (cr20 coloring, beam 256, 5 steps, chunk 3) at
   B = 32, 128, 512 and 1024 and (d) its Monte-Carlo point (circle, 4
   vehicles, beam 64, 5 steps, B = 4096), each with solves/s, launches,
   device ms of one profiled step, peak memory and the host ms of the
   coloring and the merged schedule printed; (e) the fullest merged chunk
   of (b) planned with kernels and with plain versions, every layer's
   lattice-form call held bit for bit and timed;
17. the planning modes of the eighth slice: (a) HDVs on the road, cr20
   with vehicles 3 and 11 human-driven (beam 512, 20 steps; the road
   kernels with four obstacle families) and (b) on the circle, circle-10
   with vehicle 0 human-driven (40 steps; SAT), each held with the exact
   gate to the JAX package's own CPU run of its configuration
   (``tests/torch_fixtures/reference_*.npz``, ``python -m
   tests.test_torch_reference_records``): collision-free and road
   vehicles on the map but where the reference's run is not (an HDV
   does not yield: it hits CAVs that fall back into its path, and a CAV
   dodging one leaves the map, there too), every vehicle moving more
   than 0.3 m,
   each HDV following its path more than 2 m, outside the coupling graph
   and never falling back; (c) one chunk of each with HDV obstacles planned
   with kernels and with plain versions, every layer's lattice-form call
   held bit for bit and timed; (d) centralized planning on circle-3
   (beam 2,048: 12^3 x 2,048 joint candidates a layer), 20 steps, and
   (e) centralized cr3 (beam 1,024), 10 steps, its boundary checks
   through ``boundary_hits``' (cx, cy) form: each held to the reference's
   CPU run as (a) is (circle-3's joint search exhausts from step 7 on
   there too: the three vehicles meet at the center and hold their
   poses), then cr3 again with every boundary call held against
   ``boundary_hits_plain`` on the same inputs and the first step's timed;
   (f) optimal and explorative voting in a batch, cr20 at beam 256, 5
   steps, ``monte_carlo_sweep`` of 4 scenarios (1 m of arc): every entry
   equal to its run alone in every field, the batch's step median and
   vehicle-solves/s printed against the four single runs';
18. the parallel computation modes, vehicles sharded over the ranks of a
   ``torch.distributed`` group (``MeshComm``, the dense level loop): (a)
   phase 3's run under ``make_sharded_run`` on one rank, NCCL; (b) the
   same through ``python -m pdmpc_torch.parallel.multihost`` in two
   processes sharing the card, gloo (NCCL refuses two ranks on one card),
   the (1, 2) mesh ``main`` picks, rank 0's saved result read back; (c)
   phase 5's circle on a (2, 2) mesh of four processes, two identical
   starts, and rank 0's widest dense level planned with kernels and with
   plain versions, every SAT call of it held bit for bit and timed; each
   equal to its sequential run (phase 3 or 5) in every record, with
   launches a step on each rank and step medians printed; (d) the
   vehicle group's collectives timed on each backend (the traffic
   bundle's gather, one level's areas, the voting costs' psum) and
   ``python -m pdmpc_torch.parallel.scaling --device cuda --ranks 2``;
19. the host-driven loop, the plants and the evaluation (counters zeroed
   before each run and read after it): (a) phase 3's configuration
   through ``hlc.run_with_plant`` with the simulation plant, equal to
   phase 3's run in every record with its launches; (b) the headline
   through it, equal to phase 9's run, ``compute_values`` and a
   ``values.txt`` in a temporary directory; (c) phase 5's circle against
   ``ExternalPlant`` fed by ``python -m pdmpc_torch.plant_bridge`` (a
   clock 37.5 s ahead), equal to phase 5's run, one command sent and
   received a step, the offset recovered by ``normalize_timing_results``
   within 1 s; (d) a failure injected at step 4 reaches the phase and
   leaves a partial save, in a temporary results root, that
   ``load_latest`` does not serve; (e) ``eval_prioritization`` and
   ``eval_bounding`` at smoke size (commonroad 10 vehicles, beam 128, one
   seed, 2 s, bounds (1, 99)) into a temporary root, every run
   collision-free (the figures need matplotlib, which the card's hosts
   lack: tests/test_torch_viz.py draws every one on the CPU); (f)
   ``profile_trace`` around a road and a circle step names the three
   kernels; (g) cr3 (the golden configuration) with ``debug_capture``:
   every plan oracle-optimal under the numpy and the native A*;
20. the geometry API, the graft entry and the tools (counters zeroed
   before each run and read after it): (a) ``ops.geometry``'s SAT, InterX,
   sorted-vertex area, bounding boxes, masked area and ``k_dirs`` corridor
   bound on the card against the same inputs on the CPU (masks and boxes
   equal, areas within rtol 1e-6 and atol 1e-7, corridor bounds within
   4e-5 m, and the card's cos and sin of the fit's directions read
   against the CPU's); (b) ``graft_entry.entry()`` (the 8-vehicle circle at beam 256,
   4 scenarios), each scenario equal to ``run_experiment``'s first step,
   the SAT kernel launching, then ``dryrun_multichip(2, backend="gloo")``,
   two ranks on the card; (c) ``tools.axis_sweep``'s 13 cases, each ok,
   centralized circle-3 launching no kernel, the circle cases SAT only,
   the road and mixed cases outline and boundary only, no unmapped vote
   shape; (d) ``tools.nonconvex_delta`` at cr20 (beam 64, 10 steps): both
   geometries collision-free, the convex run launching SAT and boundary,
   the non-convex run outline and boundary; (e) ``tools.speed_of_light``
   at the cr20 production shapes with one profiled road step's device ms
   (beam 256): every kernel equal to its plain version, every share of
   the bound at or below 1.05.

The last line of standard output is the device JSON; before it come the
card's name and power limit (as nvidia-smi prints them) and the kernels'
JSON: per kernel the keys of the port's contract (phase 2's all-live
numbers, launches from phases 3 and 5), ``live_mask``, ``path`` (phase 8,
per layer and per plan; for the road kernels also ``path_mixed64``,
phase 10's chunk; for SAT ``path_circle40``, phase 13's chunk),
``path_sampled`` (phase 14's sampled chunk, (cx, cy) form),
``path_batch`` (for the road kernels: phase 16e's merged chunk),
``path_hdv`` (phase 17c's chunk; road kernels on the road, SAT on the
circle), ``path_centralized`` (boundary: phase 17e's first step), ``oversize``
(phase 13, per size and budget), ``launches_per_step`` and
``launches_by_path`` (launches, launches a step and lattice-form launches
of every driven run of phases 3, 5 and 9 to 20; a sharded run's summed
over its ranks), ``speed_of_light`` (phase 20e: the kernel at the cr20
production shapes, its ms, bound and share); for SAT also
``path_sharded`` (phase 18c's level) and
``lattice``
(phase 2's lattice form) and ``rollout_noise`` (phase 14: launches, host
and device ms of one step's threefry noise at cr20's sampled shape).

Whether the phases pass or fail, the script stops every process it
started before it exits (``stop_children``).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import replace
from functools import partial
from types import SimpleNamespace

import numpy as np

from pdmpc_torch.tools.speed_of_light import (
    crossing_bound,
    crossing_path_bound,
    device_ms,
    distinct_vertices,
    sat_bound,
    sat_bundle_bytes,
    sat_path_bound,
)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(HERE, "tests", "expected_results")
SEED = 0
# road-path shapes: chunk of 2 vehicles, 6-vertex maneuver areas, beam 512
# x 12 trims, 3 obstacle families x 20 vehicles of 16 vertices, 8 predicted
# lanelets x 22 boundary segments
V, VA, C, N_OBS, VO, N_SEG = 2, 6, 512 * 12, 60, 16, 176
# circle-path shapes of the SAT kernel: 5-vertex convex areas, 3 obstacle
# families x 10 vehicles (padded to 32), 12 trims
VA_SAT, N_OBS_SAT, N_TRIMS_SAT = 5, 30, 12
# share of live candidates in phase 2's masked run: the road MPA allows
# 37.5% of the 12 x 12 transitions in layers 1 to 5
LIVE_SHARE = 0.375
# phase 20a's limit (m) on the card's corridor bounds against the CPU's:
# cos and sin off by up to 2 ulps move phase 20a's bounds, at coordinates
# up to 25 m, by less (tests/test_torch_geometry_api.py)
CORRIDOR_ATOL = 4e-5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def rand_polys(rng, n, v, radius):
    """n convex polygons of v vertices (sorted angles) at map scale."""
    centers = rng.uniform([0.0, 0.0], [4.5, 4.0], size=(n, 1, 2))
    ang = np.sort(rng.uniform(0, 2 * np.pi, size=(n, v)), axis=1)
    r = rng.uniform(0.5, 1.0, size=(n, 1)) * radius
    return centers + np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1)


def pad_obstacles(rng, cand, n_obs, share_every=3, radius=0.3):
    """[V, n_obs, VO, 2] obstacles padded by repeating the last vertex:
    every ``share_every``-th is a candidate polygon (exact touches, as on
    the trim lattice), the others random polygons of 4 to 6 vertices and
    ``radius`` m."""
    v_count, c_count, va = cand.shape[:3]
    obs = np.zeros((v_count, n_obs, VO, 2))
    n_real = rng.integers(4, 7, size=(v_count, n_obs))
    for v in range(v_count):
        for o in range(n_obs):
            if o % share_every == 0:
                poly = cand[v, rng.integers(c_count)]
                n_real[v, o] = va
            else:
                poly = rand_polys(rng, 1, n_real[v, o], radius)[0]
            obs[v, o, :n_real[v, o]] = poly[:n_real[v, o]]
            obs[v, o, n_real[v, o]:] = poly[n_real[v, o] - 1]
    return obs


def tensor(torch, a, dev, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype or torch.float32,
                           device=dev)


def vertex_major(torch, cand, dev):
    """[V, C, VA, 2] -> cx, cy [V, VA, C] contiguous on ``dev``."""
    cxy = tensor(torch, cand, dev).permute(0, 3, 2, 1)
    return cxy[:, 0].contiguous(), cxy[:, 1].contiguous()


def kernel_inputs(torch, dev, n_obs=N_OBS, n_seg=N_SEG):
    """Road-path inputs: candidates [V, VA, C], obstacles [V, NO, VO],
    segments [V, S, 2, 2]: random polygons near each other, exact touches
    (shared vertices and edges, as on the trim lattice) and padded
    degenerate edges. Past the road path's counts (phase 13) the random
    obstacles shrink and the segments shorten with their count, so that
    the candidates meet about as many as at phase 2's."""
    rng = np.random.default_rng(SEED)
    cand = rand_polys(rng, V * C, VA, 0.15).reshape(V, C, VA, 2)
    obs = pad_obstacles(rng, cand, n_obs,
                        radius=0.3 * min(1.0, (N_OBS / n_obs) ** 0.5))
    obs_mask = rng.random((V, n_obs)) < 0.5
    segs = rng.uniform([0.0, 0.0], [4.5, 4.0], size=(V, n_seg, 2, 2))
    shrink = min(1.0, N_SEG / n_seg)
    if n_seg > N_SEG:
        segs[:, :, 1] = segs[:, :, 0] + rng.normal(0, 0.3 * shrink,
                                                   (V, n_seg, 2))
    # every 4th segment is a candidate edge or starts at a candidate vertex
    for v in range(V):
        for s in range(0, n_seg, 4):
            p = cand[v, rng.integers(C)]
            segs[v, s, 0] = p[1]
            segs[v, s, 1] = p[2] if s % 8 == 0 else p[1] + rng.normal(
                0, 0.2 * shrink, 2)
    seg_mask = rng.random((V, n_seg)) < 0.8
    return (*vertex_major(torch, cand, dev), tensor(torch, obs, dev),
            tensor(torch, obs_mask, dev, torch.bool), tensor(torch, segs, dev),
            tensor(torch, seg_mask, dev, torch.bool))


def sat_obstacles(rng, cand, n_obs=N_OBS_SAT):
    """``n_obs`` convex obstacles [V, n_obs, VO, 2] a vehicle for
    candidates ``cand`` [V, C, VA, 2]: every third a candidate, every
    third an edge-sharing box (an exact touch), the rest random (smaller
    past phase 2's count, as in ``kernel_inputs``); and a mask with half
    of them off."""
    v_count, c_count = cand.shape[:2]
    obs = pad_obstacles(rng, cand, n_obs,
                        radius=0.3 * min(1.0, (N_OBS_SAT / n_obs) ** 0.5))
    for v in range(v_count):
        for o in range(1, n_obs, 3):
            poly = cand[v, rng.integers(c_count)]
            a, b = poly[0], poly[1]
            normal = np.array([b[1] - a[1], a[0] - b[0]])
            normal *= 0.2 / max(np.linalg.norm(normal), 1e-9)
            if np.dot(normal, a - poly.mean(0)) < 0:
                normal = -normal
            box = np.stack([a, a + normal, b + normal, b])
            obs[v, o, :4] = box
            obs[v, o, 4:] = box[-1]
    return obs, rng.random((v_count, n_obs)) < 0.5


def sat_inputs(torch, dev, n_obs=N_OBS_SAT):
    """Circle-path inputs of the SAT kernel: convex candidates [V, 5, C]
    (every other one a 4-vertex area with its last vertex repeated, as the
    straight maneuvers are) and ``sat_obstacles`` for them."""
    rng = np.random.default_rng(SEED + 1)
    cand = rand_polys(rng, V * C, VA_SAT, 0.15).reshape(V, C, VA_SAT, 2)
    cand[:, ::2, -1] = cand[:, ::2, -2]
    obs, mask = sat_obstacles(rng, cand, n_obs)
    return (*vertex_major(torch, cand, dev), tensor(torch, obs, dev),
            tensor(torch, mask, dev, torch.bool))


def sat_lattice_inputs(torch, coll, dev):
    """A search layer for the SAT kernel's lattice form at the circle
    path's widths: V = 2 vehicles of 512 parents x 12 successors, a table
    of random convex areas [12, 12, 5, 2] (every other one with its last
    vertex repeated) ahead of the parent, parents spread over the map, and
    ``sat_obstacles`` drawn from the lattice's own candidates, as the
    kernel builds them (exact touches). Returns (lattice, bundle)."""
    rng = np.random.default_rng(SEED + 2)
    n, b = N_TRIMS_SAT, C // N_TRIMS_SAT
    table = rand_polys(rng, n * n, VA_SAT, 0.15)
    table += (rng.uniform([0.0, -0.05], [0.2, 0.05], size=(n * n, 1, 2))
              - table.mean(axis=1, keepdims=True))
    table[::2, -1] = table[::2, -2]
    pose = np.concatenate([rng.uniform([0.5, 0.5], [4.0, 3.5], (V, b, 2)),
                           rng.uniform(-np.pi, np.pi, (V, b, 1))], -1)
    pose = tensor(torch, pose, dev)
    lat = coll.Lattice(
        tensor(torch, table.reshape(n, n, VA_SAT, 2), dev),
        tensor(torch, rng.integers(0, n, (V, b)), dev, torch.int64), pose,
        torch.cos(pose[..., 2:]), torch.sin(pose[..., 2:]))
    cx, cy = coll.candidate_polys(*lat)
    cand = torch.stack([cx, cy], -1).permute(0, 2, 1, 3).cpu().numpy()
    obs, mask = sat_obstacles(rng, cand)
    return lat, coll.precompute_obstacles(
        tensor(torch, obs, dev), tensor(torch, mask, dev, torch.bool))


def time_ms(torch, fn, reps=20, warmup=3):
    """Median time of ``fn`` in ms over ``reps`` CUDA-event-timed calls,
    each call's host time included (how the kernels' earlier designs were
    timed)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def compare(torch, name, got, want):
    """Exact equality of two masks; returns the max abs error (0)."""
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    print(f"kernel {name}: {mismatches} mismatches of {want.numel()}",
          flush=True)
    if mismatches:
        raise AssertionError(f"{name} disagrees with its plain version")
    return float((got.int() - want.int()).abs().max())


def kernel_row(torch, name, fn, plain, cx, cy, pre, bound, src_line):
    """Hold ``fn`` against ``plain`` (exact masks) on all-live inputs, time
    both and return the kernel's JSON row; ``bound(live, feasible,
    live_bytes)`` gives the least time these inputs need and what bounds
    it."""
    want = plain(cx, cy, pre)
    max_abs_err = compare(torch, name, fn(cx, cy, pre), want)
    hit_share = float(want.float().mean())
    print(f"kernel {name}: hit share {hit_share:.4f}", flush=True)
    if not 0.0 < hit_share < 1.0:
        raise AssertionError(f"{name}: degenerate test input")
    bound_ms, bound_by = bound(torch.ones_like(want), ~want, 0)
    row = {
        "name": name, "route": "cuda",
        "source": "pdmpc_torch/csrc/collision.cu",
        "replaces": src_line,
        "launches": None, "max_abs_err": max_abs_err,
        "ms": device_ms(lambda: fn(cx, cy, pre)),
        "plain_ms": device_ms(lambda: plain(cx, cy, pre), reps=10),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "event_ms": time_ms(torch, lambda: fn(cx, cy, pre)),
    }
    print(f"kernel {name}: {row['ms']:.5f} ms ({row['event_ms']:.5f} ms a "
          f"call with the host), plain {row['plain_ms']:.4f} ms, bound "
          f"{bound_ms:.6f} ms", flush=True)
    return row


def live_run(torch, label, fn, plain, live, bound):
    """``fn(live)`` against ``plain(live)``, exact; the live candidates
    must be neither all hit nor all free. Returns the live share, the
    feasible share, both versions' device ms and the bound (over the live
    candidates)."""
    want = plain(live)
    compare(torch, label, fn(live), want)
    n_live, n_free = int(live.sum()), int(want.sum())
    if not 0 < n_free < n_live:
        raise AssertionError(f"{label}: degenerate test input")
    got = {
        "live_share": n_live / live.numel(),
        "feasible_share": n_free / live.numel(),
        "ms": device_ms(lambda: fn(live)),
        "plain_ms": device_ms(lambda: plain(live), reps=10),
        "bound_ms": bound(live, want, live.numel())[0],
    }
    print(f"kernel {label}: live share {got['live_share']:.4f}, feasible "
          f"{got['feasible_share']:.4f}: {got['ms']:.5f} ms, plain "
          f"{got['plain_ms']:.4f} ms, bound {got['bound_ms']:.6f} ms",
          flush=True)
    return got


def random_live(torch, shape, dev):
    """A live mask of ``shape`` at the road MPA's share of allowed
    transitions, from the seed."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return torch.rand(shape, generator=gen, device=dev) < LIVE_SHARE


def check_kernels(torch, coll, dev, extras=True):
    """Phase 2: each kernel's (cx, cy) form against its plain version,
    exact masks, on all-live inputs; with ``extras`` also with a live
    mask, and the SAT kernel's lattice form all live and with a live
    mask."""
    cx, cy, obs, obs_mask, segs, seg_mask = kernel_inputs(torch, dev)
    out_pre = coll.precompute_outline(obs, obs_mask)
    seg_pre = coll.precompute_segments(segs, seg_mask)
    sx, sy, s_obs, s_mask = sat_inputs(torch, dev)
    sat_pre = coll.precompute_obstacles(s_obs, s_mask)
    rows = {}
    for name, (ax, ay), pre, bound_of, in_bytes, src_line in (
        ("outline_hits", (cx, cy), out_pre,
         partial(crossing_bound, n_active=out_pre.edge_ok.sum(dim=(1, 2)),
                 va=VA),
         4 * (cx.numel() * 2 + out_pre.ox.numel() * 3),
         "pdmpc_tpu/ops/pallas_collision.py:530"),
        ("boundary_hits", (cx, cy), seg_pre,
         partial(crossing_bound, n_active=seg_pre.mask.sum(dim=1), va=VA),
         4 * (cx.numel() * 2 + seg_pre.packed.numel() + seg_pre.mask.numel()),
         "pdmpc_tpu/ops/pallas_collision.py:374"),
        ("sat_hits", (sx, sy), sat_pre,
         partial(sat_bound, pre=sat_pre, cand_verts=distinct_vertices(
             sx.transpose(1, 2), sy.transpose(1, 2))),
         4 * sx.numel() * 2 + sat_bundle_bytes(sat_pre),
         "pdmpc_tpu/ops/pallas_collision.py:234"),
    ):
        fn, plain = getattr(coll, name), getattr(coll, name + "_plain")

        def bound(live, feasible, live_bytes, bound_of=bound_of,
                  in_bytes=in_bytes):
            return bound_of(live, feasible, in_bytes=in_bytes + live_bytes)

        row = kernel_row(torch, name, fn, plain, ax, ay, pre, bound,
                         src_line)
        if extras:
            row["live_mask"] = live_run(
                torch, name + " (live mask)",
                lambda live: fn(ax, ay, pre, live),
                lambda live: plain(ax, ay, pre, live),
                random_live(torch, (ax.shape[0], ax.shape[2]), dev), bound)
        rows[name] = row
    if extras:
        rows["sat_hits"]["lattice"] = sat_lattice_run(torch, coll, dev)
    return list(rows.values())


def sat_lattice_run(torch, coll, dev):
    """Phase 2's SAT lattice form (``sat_lattice_inputs``), all live and
    with a live mask, each held exact against its plain version and
    timed."""
    lat, pre = sat_lattice_inputs(torch, coll, dev)
    shape = (*lat.trim.shape, lat.table.shape[0])

    def bound(live, feasible, _):
        return sat_path_bound(lat, live, feasible, pre)

    return {key: live_run(
                torch, f"sat_hits lattice ({key})",
                lambda live: coll.sat_hits_lattice(lat, live, pre),
                lambda live: coll.sat_hits_lattice_plain(lat, live, pre),
                live, bound)
            for key, live in (
                ("all_live", torch.ones(shape, dtype=torch.bool,
                                        device=dev)),
                ("live_mask", random_live(torch, shape, dev)))}


# phase 13's oversize bundles: obstacles of 16 vertices (outline), boundary
# segments, SAT obstacles; each set holds one stage past 47 KB that opts
# in, and one that takes more than one round
OVERSIZE = {"outline_hits": (256, 1024), "boundary_hits": (4096, 16384),
            "sat_hits": (128, 640)}
# stage budgets (bytes a round) timed on them, the wrappers' default
# (ops.collision.STAGE_BYTES, 48 KB) first
STAGE_BUDGETS = (48 * 1024, 96 * 1024, 200 * 1024)


def oversize_bundles(torch, coll, dev):
    """Phase 13, kernels: each kernel's (cx, cy) form on bundles past one
    48 KB stage (``OVERSIZE``), all live, held bit for bit against its
    plain version and timed at every budget of ``STAGE_BUDGETS`` (the
    stage plan of each printed). Returns, per kernel, one record a size."""
    out = {name: [] for name in KERNELS}
    default = coll.STAGE_BYTES
    for name in KERNELS:
        fn, plain = getattr(coll, name), getattr(coll, name + "_plain")
        for size in OVERSIZE[name]:
            if name == "sat_hits":
                cx, cy, obs, mask = sat_inputs(torch, dev, size)
                pre = coll.precompute_obstacles(obs, mask)
                entries, entry_bytes = pre.ox.shape[1], coll.sat_stage_bytes(
                    pre.ox.shape[2])
                bound = partial(sat_bound, pre=pre,
                                cand_verts=distinct_vertices(
                                    cx.transpose(1, 2), cy.transpose(1, 2)),
                                in_bytes=4 * cx.numel() * 2
                                + sat_bundle_bytes(pre))
            else:
                inputs = kernel_inputs(torch, dev, n_obs=size
                                       if name == "outline_hits" else N_OBS,
                                       n_seg=size if name == "boundary_hits"
                                       else N_SEG)
                cx, cy = inputs[:2]
                if name == "outline_hits":
                    pre = coll.precompute_outline(*inputs[2:4])
                    entries = pre.ox.shape[1] * pre.ox.shape[2]
                    n_active = pre.edge_ok.sum(dim=(1, 2))
                    in_bytes = 4 * (cx.numel() * 2 + pre.ox.numel() * 3)
                else:
                    pre = coll.precompute_segments(*inputs[4:6])
                    entries = pre.packed.shape[-1]
                    n_active = pre.mask.sum(dim=1)
                    in_bytes = 4 * (cx.numel() * 2 + pre.packed.numel()
                                    + pre.mask.numel())
                entry_bytes = coll.SEG_STAGE_BYTES
                bound = partial(crossing_bound, n_active=n_active, va=VA,
                                in_bytes=in_bytes)
            want = plain(cx, cy, pre)
            hit_share = float(want.float().mean())
            if not 0.0 < hit_share < 1.0:
                raise AssertionError(f"{name} oversize {size}: degenerate "
                                     f"test input")
            rec = {"size": size, "entries": entries,
                   "hit_share": hit_share, "by_budget": {},
                   "plain_ms": device_ms(lambda: plain(cx, cy, pre),
                                         reps=3, warmup=1)}
            rec["bound_ms"], rec["bound_by"] = bound(
                torch.ones_like(want), ~want)
            try:
                for budget in STAGE_BUDGETS:
                    coll.STAGE_BYTES = budget
                    plan = coll.stage_plan(entries, entry_bytes, budget)
                    label = (f"{name} oversize {size} (budget {budget} B: "
                             f"{plan.cap} a round, {plan.bytes} B, at most "
                             f"{plan.rounds} rounds)")
                    compare(torch, label, fn(cx, cy, pre), want)
                    rec["by_budget"][budget] = {
                        **plan._asdict(),
                        "ms": device_ms(lambda: fn(cx, cy, pre))}
                    print(f"kernel {label}: "
                          f"{rec['by_budget'][budget]['ms']:.5f} ms",
                          flush=True)
            finally:
                coll.STAGE_BYTES = default
            rec["ms"] = rec["by_budget"][default]["ms"]
            print(f"kernel {name} oversize {size}: hit share "
                  f"{hit_share:.4f}, plain {rec['plain_ms']:.4f} ms, bound "
                  f"{rec['bound_ms']:.6f} ms", flush=True)
            out[name].append(rec)
    return out


def vehicle_collisions(poses, length, width):
    """(step, i, j) where applied vehicle rectangles (no offset) overlap:
    SAT with touching counted as a collision, as tests/test_controller.py
    pairwise_vehicle_collisions does."""
    def rect(p):
        c, s = np.cos(p[2]), np.sin(p[2])
        hx, hy = length / 2.0, width / 2.0
        local = np.array([[-hx, -hy], [hx, -hy], [hx, hy], [-hx, hy]])
        return local @ np.array([[c, s], [-s, c]]) + p[:2]

    def separated(a, b):
        for poly in (a, b):
            e = np.roll(poly, -1, axis=0) - poly
            axes = np.stack([-e[:, 1], e[:, 0]], axis=-1)
            pa, pb = a @ axes.T, b @ axes.T
            if ((pa.min(0) - pb.max(0) > 0) | (pb.min(0) - pa.max(0) > 0)
                    ).any():
                return True
        return False

    hits = []
    for k in range(poses.shape[0]):
        for i in range(poses.shape[1]):
            for j in range(i + 1, poses.shape[1]):
                if np.linalg.norm(poses[k, i, :2] - poses[k, j, :2]) > 0.5:
                    continue
                if not separated(rect(poses[k, i]), rect(poses[k, j])):
                    hits.append((k, i, j))
    return hits


KERNELS = ("outline_hits", "boundary_hits", "sat_hits")
# each kernel's lattice form, counted also on its own
FORMS = tuple(name + "_lattice" for name in KERNELS)
# golden of phase 9's headline run (cr20, coloring priorities, beam 256)
HEADLINE_GOLDEN = "commonroad_20veh_coloring_tpu"


def road_offroad(res, cfg, n_road, route=True):
    """(step, vehicle) pairs among the first ``n_road`` vehicles whose
    applied pose center leaves the drivable corridor of its own
    reference-loop lanelets (tests/golden.py vehicle_centers_offroad on
    the port's own road tables) or, with ``route`` False, of every lanelet
    of the map; for a batch result, (entry, step, vehicle). A vehicle
    still at its start pose is not counted: that pose is the first point
    of its centerline, on the edge where its first lanelet's corridor
    begins, which the crossing-number test may count either way."""
    import torch

    from pdmpc_torch.experiment import create_scenario
    from pdmpc_torch.models.mpa import build_mpa
    from pdmpc_torch.ops.geometry import point_in_ring
    from pdmpc_torch.scenarios.scenario import road_to_tensors

    cfg = cfg.validate()
    sc = create_scenario(cfg, build_mpa(cfg))
    rings = road_to_tensors(sc.road, "cpu").corridor_rings
    poses = res.infos.poses
    batch = poses.ndim == 5
    bad = []
    for e, entry in enumerate(poses if batch else poses[None]):
        centers = torch.as_tensor(entry[:, :, 0, :2])         # [k, N, 2]
        for v in range(n_road):
            ids = (sorted(set(int(i) for i in sc.lanelet_indices[v]))
                   if route else list(range(rings.shape[0])))
            inside = point_in_ring(centers[:, v, None],
                                   rings[ids][None]).any(-1)
            start = torch.as_tensor(sc.start_poses[v, :2],
                                    dtype=centers.dtype)
            at_start = (centers[:, v] - start).abs().amax(dim=-1) < 1e-6
            bad += [((e, k, v) if batch else (k, v)) for k in
                    (~inside & ~at_start).nonzero().flatten().tolist()]
    return bad


def step_line(res, launches):
    """Step median and p95 (ms) of a run and its launches a step."""
    steps = np.asarray(res.timings["step_seconds"]) * 1e3
    return (f"step median {np.median(steps):.3f} ms, p95 "
            f"{np.percentile(steps, 95):.3f} ms, first step {steps[0]:.3f} "
            f"ms, launches per step " + ", ".join(
                f"{k} {v / res.n_steps:.2f}" for k, v in launches.items()))


def counts(coll):
    """Every kernel's and lattice form's launch counter."""
    return {name: getattr(coll, name).launches for name in KERNELS + FORMS}


def zero_counts(coll):
    for name in KERNELS + FORMS:
        getattr(coll, name).launches = 0


def counted_run(coll, run_experiment, cfg, label, launched, lattice=None):
    """Run ``cfg`` on the card with every launch counter zeroed first;
    require the kernels in ``launched`` to launch and the others not to,
    and, where ``lattice`` is given, their lattice forms to launch (True)
    or not (False: the sampled search's (cx, cy) forms only). Returns
    (launch counts, result); each form's count stays on its counter."""
    zero_counts(coll)
    res = run_experiment(cfg, device="cuda")
    launches = {name: getattr(coll, name).launches for name in KERNELS}
    forms = {name: getattr(coll, name).launches for name in FORMS}
    print(f"{label} launches: {launches}, of them lattice form {forms}",
          flush=True)
    for name in KERNELS:
        if (launches[name] > 0) != (name in launched):
            raise AssertionError(f"{label}: {name} launched "
                                 f"{launches[name]} times")
        if (lattice is not None and name in launched
                and (forms[name + "_lattice"] > 0) != lattice):
            raise AssertionError(f"{label}: {name}'s lattice form launched "
                                 f"{forms[name + '_lattice']} times")
    if not np.isfinite(res.infos.poses).all():
        raise AssertionError(f"{label}: non-finite poses")
    return launches, res


def drive(coll, run_experiment, cfg, card, label, launched, dims,
          min_moved=0.3, max_fallback_share=0.5, n_road=0, lattice=None,
          route=True):
    """``counted_run`` of ``cfg``, then check it: collision-free, every
    vehicle moves more than ``min_moved`` m (None: printed only), the
    fallback share below ``max_fallback_share`` (None: printed only) and
    the first ``n_road`` vehicles on the road: on their own route's
    lanelets or, with ``route`` False, on the map's (the steps off the
    route are then printed); print its step times. Returns the launch
    counts and the result."""
    launches, res = counted_run(coll, run_experiment, cfg, label, launched,
                                lattice)
    poses = res.infos.poses[:, :, 0]                      # [k, N, 3]
    collisions = vehicle_collisions(poses, *dims)
    if collisions:
        raise AssertionError(f"{label}: vehicle collisions: "
                             f"{collisions[:10]}")
    moved = np.linalg.norm(poses[-1, :, :2] - poses[0, :, :2], axis=-1)
    if min_moved is not None and not (moved > min_moved).all():
        raise AssertionError(f"{label}: stuck vehicles: moved {moved}")
    fb_share = float(res.infos.needs_fallback.mean())
    if max_fallback_share is not None and fb_share >= max_fallback_share:
        raise AssertionError(f"{label}: fallback share {fb_share}")
    offroad = road_offroad(res, cfg, n_road, route) if n_road else []
    if offroad:
        raise AssertionError(f"{label}: off the road: {offroad[:10]}")
    if n_road and not route:
        print(f"{label}: (step, vehicle) off its own route's lanelets, on "
              f"the map's: {road_offroad(res, cfg, n_road)}", flush=True)
    solves = cfg.amount * res.n_steps / res.timings["control_loop"]
    print(f"{label} ({card}): beam {cfg.beam_width}, Hp {cfg.Hp}, "
          f"{res.n_steps} steps, {cfg.amount} vehicles, "
          f"{step_line(res, launches)}, {solves:.1f} vehicle-solves/s, "
          f"fallback share {fb_share:.4f}, min distance moved "
          f"{moved.min():.3f} m, on the road: {n_road} vehicles checked",
          flush=True)
    return launches, res


def golden_gate(run_experiment, cfg, name, coll=None, launched=None,
                exact_required=True, lattice=None):
    """The gate bench.py holds the TPU to (same fallback pattern as the CPU
    golden, total cost within 1%), and beyond it an exact match: trims
    and levels equal, poses within 1e-4 (printed only unless
    ``exact_required``). With ``coll``, the run's launch counts are
    checked as ``counted_run`` does and returned."""
    if coll is None:
        gold, launches = run_experiment(cfg, device="cuda"), None
    else:
        launches, gold = counted_run(coll, run_experiment, cfg, name,
                                     launched, lattice)
    ref = load_golden(name)
    rel = behavior_gate(gold, ref, name)
    exact = (np.allclose(gold.infos.poses, ref["poses"], rtol=1e-7,
                         atol=1e-4)
             and (gold.infos.trims == ref["trims"]).all()
             and (gold.infos.levels == ref["levels"]).all())
    print(f"golden gate {name}: fallbacks match, total cost rel diff "
          f"{rel:.3e}, exact match {exact}"
          + (f"; {step_line(gold, launches)}" if launches else ""),
          flush=True)
    if exact_required and not exact:
        raise AssertionError(f"{name}: trims, levels or poses differ from "
                             f"the golden")
    return launches, gold


def load_golden(name):
    with np.load(os.path.join(GOLDEN_DIR, name + ".npz")) as g:
        return {k: g[k] for k in g.files}


def behavior_gate(res, ref, name):
    """bench.py's gate: the same fallback pattern as ``ref`` and total
    cost within 1% of it. Returns the cost's relative difference."""
    if not (res.infos.needs_fallback == ref["needs_fallback"]).all():
        raise AssertionError(f"{name}: fallback pattern differs from golden")
    cost, cost_ref = float(res.infos.cost.sum()), float(ref["cost"].sum())
    rel = abs(cost - cost_ref) / max(abs(cost_ref), 1e-9)
    if rel > 0.01:
        raise AssertionError(f"{name}: total cost off by {rel:.4%}")
    return rel


# search-module names of the collision checks that have a plain twin in
# ops.collision, and the kernel each launches: the beam search calls the
# lattice forms, the sampled search the (cx, cy) forms
LATTICE = {"outline_hits_lattice": "outline_hits",
           "boundary_hits_lattice": "boundary_hits",
           "sat_hits_lattice": "sat_hits"}
CXCY = {name: name for name in KERNELS}
SWAPPED = KERNELS + tuple(LATTICE)


def active_slots(args, kwargs):
    """Active obstacle slots of a recorded planning chunk."""
    return int(args[5].mask.sum())


def plans_with_plain_versions(torch, coll, run_experiment, cfg, label,
                              rank=active_slots, planner="plan_trajectory",
                              forms=LATTICE):
    """Phase 7: record the planning chunks of a short run (calls of the
    search's ``planner``), take the one ranked highest by ``rank(args,
    kwargs)`` (by default: the most active obstacles), and plan it again
    twice: with the kernels, and with their plain versions swapped into
    the search. The plans must be equal. Returns the calls of the
    collision checks ``forms`` (search-module name -> kernel) in the plan
    with the kernels: (kernel name, layer, form name, call arguments)."""
    import pdmpc_torch.controller as ctl
    from pdmpc_torch.ops import search

    calls = []
    plan = getattr(search, planner)

    def recording(*args, **kwargs):
        calls.append((args, kwargs))
        return plan(*args, **kwargs)

    setattr(ctl, planner, recording)
    try:
        run_experiment(cfg, device="cuda")
    finally:
        setattr(ctl, planner, plan)
    args, kwargs = max(calls, key=lambda c: rank(*c))
    if not args[5].mask.any():
        raise AssertionError(f"{label}: no chunk planned against obstacles")

    form_calls = []
    swapped = {name: getattr(search, name) for name in SWAPPED}

    def recorder(name, fn):
        def call(*a):
            layer = sum(c[0] == forms[name] for c in form_calls)
            form_calls.append((forms[name], layer, name, tuple(
                x.clone() if torch.is_tensor(x) else x for x in a)))
            return fn(*a)
        return call

    for name in forms:
        setattr(search, name, recorder(name, swapped[name]))
    try:
        with_kernels = plan(*args, **kwargs)
    finally:
        for name in forms:
            setattr(search, name, swapped[name])
    for name in SWAPPED:
        setattr(search, name, getattr(coll, name + "_plain"))
    try:
        launches = {name: getattr(coll, name).launches for name in KERNELS}
        plain = plan(*args, **kwargs)
        if launches != {name: getattr(coll, name).launches
                        for name in KERNELS}:
            raise AssertionError(f"{label}: a kernel ran in the plain plan")
    finally:
        for name, fn in swapped.items():
            setattr(search, name, fn)
    for field in ("trims", "cost", "poses", "is_exhausted", "n_expanded"):
        a, b = getattr(with_kernels, field), getattr(plain, field)
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: {field} differs between the "
                                 f"kernels and the plain versions")
    print(f"plan level {label}: chunk of {args[1].shape[0]} vehicles, "
          f"{int(args[5].mask.sum())} active obstacle slots: trims, costs "
          f"and poses equal with kernels and plain versions", flush=True)
    return form_calls


# per kernel: its active segments or obstacles a vehicle, from its bundle,
# and the bound of a lattice-form call
PATH_BOUNDS = {
    "outline_hits": (lambda pre: pre.edge_ok.sum(dim=(1, 2)),
                     crossing_path_bound),
    "boundary_hits": (lambda pre: pre.mask.sum(dim=1), crossing_path_bound),
    "sat_hits": (lambda pre: pre.mask.sum(dim=1), sat_path_bound),
}


def cxcy_bound(name, cx, cy, pre, live, feasible):
    """The bound of a (cx, cy)-form call of kernel ``name`` on candidates
    cx, cy [V, VA, C] with live mask ``live`` [V, C]."""
    cand_bytes = 4 * cx.numel() * 2
    if name == "sat_hits":
        return sat_bound(live, feasible, distinct_vertices(
            cx.transpose(1, 2), cy.transpose(1, 2)), pre,
            cand_bytes + sat_bundle_bytes(pre))
    return crossing_bound(live, feasible, PATH_BOUNDS[name][0](pre),
                          cx.shape[1], cand_bytes + sum(
                              t.numel() * t.element_size() for t in pre))


def path_shapes(torch, coll, form_calls, rows, names, label,
                row_key="path"):
    """Phase 8: every recorded call of the kernels ``names`` in a plan (a
    lattice-form call of the beam search, a (cx, cy)-form call of the
    sampled search), held bit for bit against its plain version on the
    same inputs and timed beside it, bound over the live candidates (for
    the boundary kernel: those the obstacle test left live). Adds each
    kernel's per-layer and per-plan numbers to its row under
    ``row_key``."""
    if not {c[0] for c in form_calls} >= set(names):
        raise AssertionError(f"the {label} made no call of each of {names}")
    for name in names:
        active_of, bound_of = PATH_BOUNDS[name]
        layers = []
        for _, layer, form, args in (c for c in form_calls if c[0] == name):
            fn = getattr(coll, form)
            plain = getattr(coll, form + "_plain")
            want = plain(*args)
            compare(torch, f"{form} layer {layer}", fn(*args), want)
            n_active = active_of(args[2])          # the bundle, both forms
            if form in LATTICE:
                lat, live, pre = args
                bound_ms, bound_by = bound_of(lat, live, want, pre, n_active)
            else:
                cx, cy, pre, live = args
                bound_ms, bound_by = cxcy_bound(name, cx, cy, pre, live,
                                                want)
            layers.append({
                "layer": layer, "candidates": live.numel(),
                "live": int(live.sum()), "feasible": int(want.sum()),
                "active": n_active.tolist(),
                "ms": device_ms(lambda: fn(*args)),
                "plain_ms": device_ms(lambda: plain(*args), reps=10),
                "bound_ms": bound_ms, "bound_by": bound_by,
            })
        path = {"plan": label, "layers": layers}
        for key in ("ms", "plain_ms", "bound_ms"):
            path[key + "_per_plan"] = sum(x[key] for x in layers)
        rows[name][row_key] = path
        print(f"path shapes {name} ({label}): {len(layers)} layers, "
              f"{path['ms_per_plan']:.5f} ms a plan, plain "
              f"{path['plain_ms_per_plan']:.4f} ms, bound "
              f"{path['bound_ms_per_plan']:.6f} ms; by layer "
              + ", ".join(f"{x['live']}/{x['candidates']} live "
                          f"{x['ms']:.5f} ms" for x in layers), flush=True)


def free_space_first(args, kwargs):
    """Rank of a recorded mixed-fleet chunk: one with a free-space vehicle
    (no active boundary segment) first, then the most active obstacles."""
    no_segments = bool((kwargs["segments_pre"].mask.sum(dim=1) == 0).any())
    return (no_segments, active_slots(args, kwargs))


def headline_gate(res):
    """Phase 9's gate: bench.py's (same fallback pattern, total cost within
    1%) against the TPU golden of the headline configuration; whether
    trims and levels match it exactly is printed."""
    ref = load_golden(HEADLINE_GOLDEN)
    rel = behavior_gate(res, ref, HEADLINE_GOLDEN)
    trims = bool((res.infos.trims == ref["trims"]).all())
    levels = bool((res.infos.levels == ref["levels"]).all())
    print(f"golden gate {HEADLINE_GOLDEN}: fallbacks match, total cost rel "
          f"diff {rel:.3e}, trims equal {trims}, levels equal {levels}",
          flush=True)


def strategy_goldens(Config):
    """(golden name, configuration) of phase 11: tests/test_matrix.py's
    cells mx01, mx06, mx07 and mx08 at its scale, and mixed_16veh
    (tests/test_system_commonroad.py)."""
    from pdmpc_torch import (
        CouplingStrategies as Co,
        MpaType as M,
        PriorityStrategies as P,
        ScenarioType as S,
        WeightStrategies as W,
    )

    cells = {
        "mx01": (S.commonroad, M.single_speed, Co.reachable_set_coupling,
                 P.coloring_priority, W.constant_weight),
        "mx06": (S.circle, M.realistic, Co.full_coupling,
                 P.optimal_priority, W.distance_weight),
        "mx07": (S.commonroad, M.single_speed, Co.no_coupling,
                 P.explorative_priority, W.distance_weight),
        "mx08": (S.circle, M.single_speed, Co.distance_coupling,
                 P.FCA_priority, W.constant_weight),
    }
    for name, (sc, mpa, co, pr, w) in cells.items():
        yield name, Config(scenario_type=sc, amount=3, T_end=1.0,
                           beam_width=64, mpa_type=mpa, coupling=co,
                           priority=pr, weight=w, mcts_n_rollouts=128)
    yield "mixed_16veh", Config(scenario_type=S.mixed, amount=16, T_end=1.0,
                                beam_width=64)


def noise_cost(torch):
    """What one step's Gumbel noise costs on the card at cr20's sampled
    shape (20 vehicles, Hp 6, 256 rollouts, 12 trims: one threefry pass in
    int64 tensor ops, drawn once a step): kernel launches (profiler), the
    host ms of the call and its device ms."""
    from torch.profiler import ProfilerActivity, profile

    from pdmpc_torch.ops.search import rollout_noise

    def draw():
        return rollout_noise(0, 3, 20, 6, 256, 12, "cuda")

    draw()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        draw()
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages() if e.key in {
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx"})
    t0 = time.perf_counter()
    draw()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    got = {"launches": launches, "host_ms": host_ms,
           "device_ms": device_ms(draw, reps=10)}
    print(f"threefry noise of a cr20 sampled step: {got}", flush=True)
    return got


def matrix_goldens(Config):
    """(golden name, configuration, exact) of phase 15: the cells of
    tests/test_matrix.py with random strategies or the sampled optimizer,
    at its scale. The four that draw only integers and uniforms (random
    priorities and weights) must match exactly; the six sampled ones draw
    Gumbel noise through the card's ``log``, an ulp from XLA's in some
    values, so they are held to the gate and whether they match exactly
    is printed."""
    from pdmpc_torch import (
        CouplingStrategies as Co,
        MpaType as M,
        OptimizerType as O,
        PriorityStrategies as P,
        ScenarioType as S,
        WeightStrategies as W,
    )

    cells = {
        "mx02": (S.circle, M.single_speed, O.TpuSampled, Co.full_coupling,
                 P.constant_priority, W.random_weight),
        "mx03": (S.commonroad, M.triple_speed, O.TpuOptimal,
                 Co.distance_coupling, P.random_priority,
                 W.distance_weight),
        "mx04": (S.circle, M.triple_speed, O.TpuSampled, Co.no_coupling,
                 P.coloring_priority, W.constant_weight),
        "mx05": (S.commonroad, M.realistic, O.TpuSampled,
                 Co.reachable_set_coupling, P.FCA_priority,
                 W.random_weight),
        "mx09": (S.commonroad, M.triple_speed, O.TpuSampled,
                 Co.full_coupling, P.explorative_priority,
                 W.constant_weight),
        "mx10": (S.circle, M.triple_speed, O.TpuOptimal,
                 Co.reachable_set_coupling, P.optimal_priority,
                 W.random_weight),
        "mx11": (S.commonroad, M.realistic, O.TpuOptimal, Co.full_coupling,
                 P.random_priority, W.constant_weight),
        "mx12": (S.circle, M.realistic, O.TpuSampled, Co.distance_coupling,
                 P.constant_priority, W.distance_weight),
        "mx13": (S.mixed, M.single_speed, O.TpuOptimal,
                 Co.reachable_set_coupling, P.random_priority,
                 W.distance_weight),
        "mx14": (S.mixed, M.triple_speed, O.TpuSampled, Co.full_coupling,
                 P.coloring_priority, W.constant_weight),
    }
    for name, (sc, mpa, opt, co, pr, w) in cells.items():
        yield name, Config(scenario_type=sc, amount=3, T_end=1.0,
                           beam_width=64, mpa_type=mpa, optimizer_type=opt,
                           coupling=co, priority=pr, weight=w,
                           mcts_n_rollouts=128), opt.is_optimal


def voting(coll, run_experiment, Config, card, dims, record):
    """Phase 12: cr20 at beam 512 for 10 steps with constant, optimal and
    explorative priorities; each collision-free and on the road, its step
    median and p95 printed with its factor over the constant run's."""
    from pdmpc_torch import PriorityStrategies as P

    medians = {}
    for priority in (P.constant_priority, P.optimal_priority,
                     P.explorative_priority):
        label = f"voting {priority.value}"
        launches, res = drive(coll, run_experiment,
                              Config(amount=20, T_end=2.0, priority=priority),
                              card, label, ("outline_hits", "boundary_hits"),
                              dims, min_moved=0.1, max_fallback_share=None,
                              n_road=20)
        record(label, launches, res)
        medians[priority] = float(np.median(res.timings["step_seconds"]))
        print(f"{label}: largest level count "
              f"{res.max_number_of_computation_levels}, step median "
              f"{medians[priority] / medians[P.constant_priority]:.2f} "
              f"times the constant run's", flush=True)


def batch_entry(res, i):
    """Entry ``i`` of a batch result as a single run's result."""
    return replace(res, infos=type(res.infos)(*(x[i] for x in res.infos)))


def differing_fields(a, b):
    """The record fields of infos ``a`` and ``b`` that are not equal."""
    return [f for f, x, y in zip(a._fields, a, b)
            if not np.array_equal(np.asarray(x), np.asarray(y))]


# (entry, vehicle) of phase 16b's batch that leave the map's lanelets: the
# reference's step does the same from that entry's start (a vehicle
# shifted along its path takes a branch off its route whose lanelet ends
# open at the map's edge; tests/test_torch_sweep_offmap.py)
KNOWN_OFF_MAP = {(24, 9), (30, 10), (30, 14)}


def check_entries(res, cfg, label, dims, n_road, starts, min_moved=0.3):
    """Each entry of a batch collision-free, every vehicle moving more
    than ``min_moved`` m, the first ``n_road`` vehicles on the map's
    lanelets but those of KNOWN_OFF_MAP (the steps off the map and off
    their own route are printed). A pair whose
    start poses ``starts`` [B, N, 3] already overlap with the planning
    offset ``cfg.offset`` added (a start shifted onto the vehicle ahead:
    neither can plan a move) is exempt from the collision check and its
    vehicles from the move check; those pairs are printed."""
    overlapping = {}
    grown = [d + 2 * cfg.offset for d in dims]
    for i in range(res.infos.poses.shape[0]):
        pairs = {(a, b) for _, a, b in vehicle_collisions(starts[i][None],
                                                          *grown)}
        if pairs:
            overlapping[i] = sorted(pairs)
        exempt = {v for pair in pairs for v in pair}
        poses = res.infos.poses[i, :, :, 0]
        collisions = [c for c in vehicle_collisions(poses, *dims)
                      if (c[1], c[2]) not in pairs]
        if collisions:
            raise AssertionError(f"{label} entry {i}: vehicle collisions: "
                                 f"{collisions[:10]}")
        moved = np.linalg.norm(poses[-1, :, :2] - poses[0, :, :2], axis=-1)
        stuck = [v for v in np.flatnonzero(moved <= min_moved)
                 if v not in exempt]
        if stuck:
            raise AssertionError(f"{label} entry {i}: stuck vehicles "
                                 f"{stuck}: moved {moved}")
    print(f"{label}: (entry: vehicle pairs) overlapping at their shifted "
          f"starts, exempt: {overlapping}", flush=True)
    if n_road:
        offroad = road_offroad(res, cfg, n_road, route=False)
        unknown = [x for x in offroad if (x[0], x[2]) not in KNOWN_OFF_MAP]
        if unknown:
            raise AssertionError(f"{label}: off the road: {unknown[:10]}")
        print(f"{label}: (entry, step, vehicle) off the map's lanelets, as "
              f"the reference: {offroad}; off its own route's lanelets: "
              f"{road_offroad(res, cfg, n_road)}", flush=True)


def batch_tensors(cfg, dev="cuda"):
    """(validated configuration, MPA tensors, scenario tensors) on
    ``dev``."""
    from pdmpc_torch.experiment import create_scenario
    from pdmpc_torch.models.mpa import build_mpa

    cfg = cfg.validate()
    mpa = build_mpa(cfg)
    return (cfg, mpa.to_tensors_for(cfg, dev),
            create_scenario(cfg, mpa).to_tensors(dev))


def profiled_step(cfg, state, k):
    """One batched step of ``cfg`` from ``state`` (the batch's final state)
    at step ``k`` under torch.profiler: its launches, device ms and traced
    host ms."""
    from pdmpc_torch.controller import StepState, make_prioritized_step
    from pdmpc_torch.profile_step import LAUNCHES, device_events, traced

    cfg, mpa_t, sc_t = batch_tensors(cfg)
    step = make_prioritized_step(cfg, mpa_t, sc_t)
    state = StepState(*(x.to("cuda") for x in state))
    _, _, events, traced_ms = traced(step, state, k, 1)
    return {"launches": sum(e.count for e in events if e.key in LAUNCHES),
            "device_ms": sum(e.self_device_time_total
                             for e in device_events(events)) / 1e3,
            "traced_ms": traced_ms}


def batch_curve(torch, coll, cfg, batches, launched, label, dims, record):
    """Phase 16c and d: ``run_experiment_batch`` of ``cfg`` at each batch
    size of ``batches`` (identical starts): every entry equal to entry 0,
    which must be collision-free; solves/s, launches, one profiled step's
    launches and device ms, the peak device memory and the host ms a step
    of the coloring and the merged schedule printed."""
    from pdmpc_torch.experiment import run_experiment_batch
    from pdmpc_torch.profile_step import HOST_LOOPS, host_clocks

    for b in batches:
        name = f"{label} B={b}"
        torch.cuda.reset_peak_memory_stats()
        with host_clocks(HOST_LOOPS) as spent:
            launches, res = counted_run(
                coll, partial(run_experiment_batch, n_scenarios=b), cfg,
                name, launched)
        peak = torch.cuda.max_memory_allocated()
        record(name, launches, res)
        entry0 = batch_entry(res, 0)
        for i in range(1, b):
            if differing_fields(batch_entry(res, i).infos, entry0.infos):
                raise AssertionError(f"{name}: entry {i} differs from "
                                     f"entry 0")
        collisions = vehicle_collisions(entry0.infos.poses[:, :, 0], *dims)
        if collisions:
            raise AssertionError(f"{name}: vehicle collisions "
                                 f"{collisions[:10]}")
        point = {"batch": b,
                 "vehicle_solves_per_s":
                     res.timings["vehicle_solves_per_second"],
                 "step_ms": [x * 1e3 for x in res.timings["step_seconds"]],
                 "kernel_launches_per_step": {
                     k: v / res.n_steps for k, v in launches.items()},
                 "max_memory_allocated": peak,
                 "host_ms_per_step": {k: v[1] * 1e3 / res.n_steps
                                      for k, v in spent.items()},
                 "profiled_step": profiled_step(cfg, res.final_state,
                                                res.n_steps)}
        print(f"{name}: {json.dumps(point)}", flush=True)


def batched_rollouts(torch, coll, Config, card, dims, record, headline,
                     headline_res, rows):
    """Phase 16: the batched rollouts (see the module docstring)."""
    from pdmpc_torch import PriorityStrategies, ScenarioType
    from pdmpc_torch.controller import StepState, make_run
    from pdmpc_torch.eval.experiments import (
        monte_carlo_sweep,
        perturbed_states,
    )
    from pdmpc_torch.experiment import run_experiment_batch

    road_kernels = ("outline_hits", "boundary_hits")
    # (a) bench.py's headline shape: 32 identical starts
    launches, res = counted_run(
        coll, partial(run_experiment_batch, n_scenarios=32), headline,
        "batch headline", road_kernels)
    record("batch32 headline", launches, res)
    entry0 = batch_entry(res, 0)
    for i in range(1, 32):
        bad = differing_fields(batch_entry(res, i).infos, entry0.infos)
        if bad:
            raise AssertionError(f"batch headline: entry {i} differs from "
                                 f"entry 0 in {bad}")
    bad = differing_fields(entry0.infos, headline_res.infos)
    if bad:
        raise AssertionError(f"batch headline: entry 0 differs from phase "
                             f"9's run in {bad}")
    headline_gate(entry0)
    print(f"batch headline ({card}): 32 entries equal, entry 0 equal to "
          f"phase 9's run in every field; "
          f"{res.timings['vehicle_solves_per_second']:.1f} vehicle-solves/s, "
          f"{step_line(res, launches)}", flush=True)

    # (b) the perturbed Monte-Carlo batch
    n_mc, arc = 32, 1.0
    launches, res = counted_run(
        coll, partial(monte_carlo_sweep, n_scenarios=n_mc,
                      perturb_start_arc=arc), headline,
        "batch monte carlo", road_kernels)
    record("batch32 monte carlo", launches, res)
    cfg, mpa_t, sc_t = batch_tensors(headline)
    states = perturbed_states(sc_t, cfg, n_mc, arc)
    check_entries(res, headline, "batch monte carlo", dims, headline.amount,
                  states.pose.cpu().numpy())
    sequences = {}
    for i in range(n_mc):
        sequences.setdefault(res.infos.levels[i].tobytes(), []).append(i)
    if len(sequences) < 2:
        raise AssertionError("batch monte carlo: every entry has the same "
                             "level sequence")
    # one entry of each level sequence first, then the others
    picks = ([group[0] for group in sequences.values()]
             + [i for group in sequences.values() for i in group[1:]])[:4]
    for i in picks:
        _, alone = make_run(cfg)(StepState(*(x[i:i + 1] for x in states)),
                                 mpa_t, sc_t)
        bad = differing_fields(type(alone)(*(x[0].cpu() for x in alone)),
                               batch_entry(res, i).infos)
        if bad:
            raise AssertionError(f"batch monte carlo: entry {i} alone "
                                 f"differs in {bad}")
    print(f"batch monte carlo ({card}): {n_mc} entries, {len(sequences)} "
          f"distinct level sequences, collision-free, moving, on the map; "
          f"entries {picks} alone equal to their batch entries; "
          f"{res.timings['vehicle_solves_per_second']:.1f} vehicle-solves/s, "
          f"{step_line(res, launches)}", flush=True)

    # (c) bench.py's curve shape and (d) its Monte-Carlo point
    coloring = PriorityStrategies.coloring_priority
    batch_curve(
        torch, coll, Config(amount=20, T_end=1.0, beam_width=256,
                            priority=coloring, level_chunk=3),
        (32, 128, 512, 1024), road_kernels, "curve cr20", dims, record)
    batch_curve(
        torch, coll, Config(scenario_type=ScenarioType.circle, amount=4,
                            T_end=1.0, beam_width=64, priority=coloring),
        (4096,), ("sat_hits",), "monte carlo circle4", dims, record)

    # (e) the fullest merged chunk of (b), with kernels and plain versions
    calls = plans_with_plain_versions(
        torch, coll, partial(monte_carlo_sweep, n_scenarios=n_mc,
                             perturb_start_arc=arc),
        Config(amount=20, T_end=1.0, beam_width=256, priority=coloring),
        "batch chunk", rank=lambda a, kw: (a[1].shape[0],
                                           active_slots(a, kw)))
    path_shapes(torch, coll, calls, rows, road_kernels, "batch chunk",
                row_key="path_batch")


def hdv_slots(cfg):
    """Rank of a recorded planning chunk of an HDV run: its active slots
    in the HDV family (after the predecessors', the parallel and the
    successor families), then all its active slots."""
    from pdmpc_torch import ConstraintFromSuccessor

    n = cfg.amount
    first = (2 + (cfg.constraint_from_successor
                  != ConstraintFromSuccessor.none)) * n

    def rank(args, kwargs):
        return (int(args[5].mask[:, first:first + n].sum()),
                active_slots(args, kwargs))
    return rank


def reference_gate(res, cfg, label, name, dims, n_road):
    """Hold a run to the JAX package's own CPU run of its configuration
    (``tests/torch_fixtures/reference_<name>.npz``, written by ``python
    -m tests.test_torch_reference_records``) with the exact gate: trims,
    levels, fallbacks and adjacency equal, poses within 1e-4, cost within
    rtol 1e-6. Then the behavior checks, where the reference's own run is
    the measure: no collision and (for the first ``n_road`` vehicles) no
    step off the map's lanelets that the reference's run does not have
    too; every vehicle moves more than 0.3 m. Prints what the reference
    shares."""
    from types import SimpleNamespace

    with np.load(os.path.join(HERE, "tests", "torch_fixtures",
                              f"reference_{name}.npz")) as f:
        ref = {k: f[k] for k in f.files}
    for field in ("trims", "levels", "needs_fallback", "is_exhausted",
                  "adjacency"):
        if not np.array_equal(getattr(res.infos, field), ref[field]):
            raise AssertionError(f"{label}: {field} differs from the "
                                 f"reference's run")
    pose_err = float(np.abs(res.infos.poses - ref["poses"]).max())
    # cost as np.testing.assert_allclose(rtol=1e-6, atol=1e-6) holds it
    got_cost, ref_cost = res.infos.cost, ref["cost"]
    finite = np.isfinite(ref_cost)
    if not (np.array_equal(finite, np.isfinite(got_cost))
            and np.all(np.abs(got_cost[finite] - ref_cost[finite])
                       <= 1e-6 + 1e-6 * np.abs(ref_cost[finite]))):
        raise AssertionError(f"{label}: cost off the reference's run")
    cost_rel = float(np.max(np.abs(got_cost[finite] - ref_cost[finite])
                            / np.maximum(np.abs(ref_cost[finite]), 1e-9),
                            initial=0.0))
    if pose_err > 1e-4:
        raise AssertionError(f"{label}: poses {pose_err:.3e} off the "
                             f"reference's run")
    poses = res.infos.poses[:, :, 0]
    ref_res = SimpleNamespace(infos=SimpleNamespace(poses=ref["poses"]))
    shared = set(vehicle_collisions(ref["poses"][:, :, 0], *dims))
    collisions = vehicle_collisions(poses, *dims)
    if set(collisions) - shared:
        raise AssertionError(f"{label}: vehicle collisions the reference "
                             f"has not: {sorted(set(collisions) - shared)}")
    off = road_offroad(res, cfg, n_road, route=False) if n_road else []
    ref_off = (set(road_offroad(ref_res, cfg, n_road, route=False))
               if n_road else set())
    if set(off) - ref_off:
        raise AssertionError(f"{label}: off the road where the reference "
                             f"is not: {sorted(set(off) - ref_off)}")
    moved = np.linalg.norm(poses[-1, :, :2] - poses[0, :, :2], axis=-1)
    if not (moved > 0.3).all():
        raise AssertionError(f"{label}: stuck vehicles: moved {moved}")
    print(f"{label}: equal to the reference's CPU run (trims, levels, "
          f"fallbacks, adjacency; poses within {pose_err:.3e}, cost rel "
          f"{cost_rel:.3e}); (step, i, j) collisions, as in the reference's "
          f"run: {collisions}; (step, vehicle) off the map, as in the "
          f"reference's run: {off}; min distance moved {moved.min():.3f} m",
          flush=True)


def check_hdvs(res, label, hdv_ids):
    """Each HDV follows its path (more than 2 m), stays outside the
    coupling graph and never falls back."""
    infos = res.infos
    poses = infos.poses[:, :, 0]
    for h in hdv_ids:
        moved = float(np.linalg.norm(poses[-1, h, :2] - poses[0, h, :2]))
        if moved <= 2.0:
            raise AssertionError(f"{label}: HDV {h} moved {moved:.3f} m")
        if infos.adjacency[:, h].any() or infos.adjacency[:, :, h].any():
            raise AssertionError(f"{label}: HDV {h} in the coupling graph")
        if infos.needs_fallback[:, h].any():
            raise AssertionError(f"{label}: HDV {h} fell back")
    moved = np.linalg.norm(poses[-1, :, :2] - poses[0, :, :2], axis=-1)
    print(f"{label}: HDVs {hdv_ids} followed their paths "
          f"({np.round(moved[list(hdv_ids)].astype(float), 3).tolist()} m), "
          f"outside the coupling graph, never fell back", flush=True)


def human_driven(torch, coll, Config, card, dims, record, rows):
    """Phase 17a to c: HDVs on the road and on the circle, and one HDV
    chunk of each held with kernels and plain versions."""
    from pdmpc_torch import ManualControlConfig, ScenarioType
    from pdmpc_torch.experiment import run_experiment

    road_kernels = ("outline_hits", "boundary_hits")
    cases = (
        ("hdv road", dict(amount=20), (3, 11), road_kernels, 4.0, 1.0),
        ("hdv circle", dict(scenario_type=ScenarioType.circle, amount=10),
         (0,), ("sat_hits",), 8.0, 3.0))
    for label, kw, hdv_ids, launched, t_end, t_chunk in cases:
        mcc = ManualControlConfig(is_active=True, amount=len(hdv_ids),
                                  hdv_ids=hdv_ids)
        cfg = Config(T_end=t_end, manual_control_config=mcc, **kw)
        road = launched == road_kernels
        launches, res = counted_run(coll, run_experiment, cfg, label,
                                    launched, lattice=True)
        record(label, launches, res)
        # an HDV does not yield: where CAVs fall back into its path it
        # hits them, and a CAV dodging it can leave the map, in the
        # reference's run too, which the run is held to
        reference_gate(res, cfg, label, label.replace(" ", "_"), dims,
                       cfg.amount if road else 0)
        check_hdvs(res, label, hdv_ids)
        print(f"{label} ({card}): {step_line(res, launches)}, "
              f"{cfg.amount * res.n_steps / res.timings['control_loop']:.1f}"
              f" vehicle-solves/s, fallback share "
              f"{float(res.infos.needs_fallback.mean()):.4f}", flush=True)
        short = replace(cfg, T_end=t_chunk)
        rank = hdv_slots(short)
        calls = plans_with_plain_versions(torch, coll, run_experiment, short,
                                          f"{label} chunk", rank=rank)
        path_shapes(torch, coll, calls, rows, launched, f"{label} chunk",
                    row_key="path_hdv")


def centralized(torch, coll, Config, card, dims, record, rows):
    """Phase 17d and e: centralized planning on circle-3 and on cr3, the
    road run's boundary calls held against the plain version."""
    from pdmpc_torch import ScenarioType
    from pdmpc_torch.experiment import run_experiment
    from pdmpc_torch.ops import search_centralized as scm

    circle3 = Config(scenario_type=ScenarioType.circle, amount=3, T_end=4.0,
                     beam_width=2048, is_prioritized=False)
    cr3 = Config(amount=3, T_end=2.0, beam_width=1024, is_prioritized=False)
    # circle-3 has no boundary and no static obstacle: no kernel launches
    for label, cfg, launched, n_road in (
            ("centralized circle3", circle3, (), 0),
            ("centralized cr3", cr3, ("boundary_hits",), 3)):
        launches, res = counted_run(coll, run_experiment, cfg, label,
                                    launched, lattice=False)
        record(label, launches, res)
        reference_gate(res, cfg, label, label.replace(" ", "_"), dims,
                       n_road)
        print(f"{label} ({card}): {step_line(res, launches)}, "
              f"{cfg.amount * res.n_steps / res.timings['control_loop']:.1f}"
              f" vehicle-solves/s; the joint search exhausted (the fleet "
              f"holding its poses), as in the reference's run, at steps "
              f"{np.flatnonzero(res.infos.is_exhausted[:, 0]).tolist()}",
              flush=True)
    # the same run again, every boundary call held against the plain
    # version on its inputs; the first step's calls recorded and timed
    checked = {"calls": 0, "candidates": 0, "live": 0}
    form_calls = []
    kernel = scm.boundary_hits

    def holding(cx, cy, pre, live):
        out = kernel(cx, cy, pre, live)
        if not torch.equal(out, coll.boundary_hits_plain(cx, cy, pre, live)):
            raise AssertionError(f"centralized cr3: boundary call "
                                 f"{checked['calls']} disagrees with "
                                 f"boundary_hits_plain")
        if len(form_calls) < cr3.Hp:
            form_calls.append(("boundary_hits", len(form_calls),
                               "boundary_hits", tuple(
                                   x.clone() if torch.is_tensor(x) else x
                                   for x in (cx, cy, pre, live))))
        checked["calls"] += 1
        checked["candidates"] = max(checked["candidates"], cx.shape[-1])
        checked["live"] += int(live.sum())
        return out

    scm.boundary_hits = holding
    try:
        run_experiment(cr3, device="cuda")
    finally:
        scm.boundary_hits = kernel
    print(f"centralized cr3 ({card}): {checked['calls']} boundary calls "
          f"equal to boundary_hits_plain, up to {checked['candidates']} "
          f"candidates a row, {checked['live']} live row-candidates in all",
          flush=True)
    path_shapes(torch, coll, form_calls, rows, ("boundary_hits",),
                "centralized cr3 step", row_key="path_centralized")


def voting_batch(torch, coll, Config, card, record):
    """Phase 17f: optimal and explorative voting as a sweep of 4 cr20
    scenarios, every entry held to its run alone, the batch's step times
    and vehicle-solves/s against the single runs'."""
    from pdmpc_torch import PriorityStrategies as P
    from pdmpc_torch.controller import StepState, make_run
    from pdmpc_torch.eval.experiments import (
        monte_carlo_sweep,
        perturbed_states,
    )

    b, arc = 4, 1.0
    for priority in (P.optimal_priority, P.explorative_priority):
        label = f"voting batch {priority.value}"
        cfg = Config(amount=20, T_end=1.0, beam_width=256, priority=priority)
        launches, res = counted_run(
            coll, partial(monte_carlo_sweep, n_scenarios=b,
                          perturb_start_arc=arc), cfg, label,
            ("outline_hits", "boundary_hits"))
        record(label, launches, res)
        cfg, mpa_t, sc_t = batch_tensors(cfg)
        states = perturbed_states(sc_t, cfg, b, arc)
        alone_seconds = []
        for i in range(b):
            _, alone = make_run(cfg)(StepState(*(x[i:i + 1] for x in states)),
                                     mpa_t, sc_t, alone_seconds)
            bad = differing_fields(type(alone)(*(x[0].cpu() for x in alone)),
                                   batch_entry(res, i).infos)
            if bad:
                raise AssertionError(f"{label}: entry {i} alone differs in "
                                     f"{bad}")
        steps = np.asarray(res.timings["step_seconds"]) * 1e3
        alone_ms = np.asarray(alone_seconds) * 1e3
        print(f"{label} ({card}): {b} entries equal to their runs alone; "
              f"batch step median {np.median(steps):.3f} ms, "
              f"{res.timings['vehicle_solves_per_second']:.1f} "
              f"vehicle-solves/s; single runs step median "
              f"{np.median(alone_ms):.3f} ms, "
              f"{b * cfg.amount * cfg.k_end / alone_ms.sum() * 1e3:.1f} "
              f"vehicle-solves/s; {step_line(res, launches)}; vote rows "
              f"chosen {np.unique(res.infos.priority_permutation).tolist()}",
              flush=True)


def record_counts(by_path, label, launched, n_steps):
    """Phase 18's rows of ``launches_by_path``: ``launched`` holds the
    counts of every kernel and form over the run's ranks."""
    for name in KERNELS:
        by_path[name][label] = {
            "launches": launched[name],
            "per_step": launched[name] / n_steps,
            "lattice_launches": launched[name + "_lattice"]}


def sharded_block_run(cfg, mesh_shape, batch, step_seconds=None):
    """The records of ``cfg`` under ``make_sharded_run`` on a mesh of the
    initialized group's ranks, each rank's block of ``batch`` identical
    starts; every rank returns the whole batch [B, k, N, ...] as numpy."""
    from pdmpc_torch.parallel import sharded

    cfg, mpa_t, sc_t = batch_tensors(cfg)
    mesh = sharded.make_mesh(*mesh_shape)
    run = sharded.make_sharded_run(cfg, mpa_t, sc_t, mesh)
    states = sharded.place_batched_state(
        sharded.batched_initial_state(sc_t, cfg.Hp, batch), mesh)
    _, infos = run(states, mpa_t, sc_t, step_seconds)
    return type(infos)(*(x.cpu().numpy() for x in infos))


def hold_entries(infos, ref, label, batch):
    """Raise unless every entry of the batch ``infos`` equals the single
    run ``ref`` in every record."""
    for b in range(batch):
        bad = differing_fields(type(infos)(*(x[b] for x in infos)),
                               ref.infos)
        if bad:
            raise AssertionError(f"{label}: entry {b} differs from the "
                                 f"sequential run in {bad}")


def collective_ms(device, reps=20):
    """18d, on every rank of the initialized group: host ms (the work
    synchronized) of the vehicle group's collectives at cr20's shapes, as
    tests/_multihost_worker.py times the JAX package's: ``gather_tree`` of
    the traffic bundle, ``gather_veh`` of one level's planned areas, and
    ``psum`` of the 16 optimal-voting costs of every vehicle."""
    import torch
    import torch.distributed as dist

    from pdmpc_torch import Config
    from pdmpc_torch.models.mpa import build_mpa
    from pdmpc_torch.parallel.comm import MeshComm
    from pdmpc_torch.scenarios.scenario import VO

    cfg = Config(amount=20).validate()
    k = build_mpa(cfg).to_tensors_for(cfg, device).local_reachable_sets
    hp, k = k.shape[1], k.shape[2]
    comm = MeshComm(cfg.amount)
    nl = comm.n_local

    def f32(*shape):
        return torch.rand((1, nl, *shape), device=device)

    traffic = (f32(3), torch.zeros((1, nl), dtype=torch.int64, device=device),
               f32(hp, k, 2), f32(hp, 2), f32(4, 2), f32(hp, VO, 2),
               torch.ones((1, nl), dtype=torch.bool, device=device),
               torch.zeros((1, nl, 8), dtype=torch.int64, device=device))
    level, costs = f32(hp, VO, 2), f32(16)
    out = {"backend": dist.get_backend(), "ranks": dist.get_world_size(),
           "device": str(device),
           "traffic_floats_a_vehicle": sum(x[0, 0].numel() for x in traffic)}
    for name, fn in (("all_gather_traffic", lambda: comm.gather_tree(traffic)),
                     ("all_gather_level", lambda: comm.gather_veh(level)),
                     ("psum_costs", lambda: comm.psum(costs))):
        for _ in range(3):
            fn()
        dist.barrier()
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            r = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        out[name + "_ms"] = (time.perf_counter() - t0) / reps * 1e3
        del r
    return out


def sharded_circle_rank(device):
    """18c, one rank of four: phase 5's circle-10 (40 steps) on a (2, 2)
    mesh, two identical starts; then a recorded run of the first 15 steps
    in which rank 0 plans the dense level with the most vehicles (then the
    most active obstacles) again with the kernels and with their plain
    versions, and holds and times every SAT call of that plan. Returns
    the records, the launches of the first run and rank 0's path rows."""
    import torch
    import torch.distributed as dist

    from pdmpc_torch import Config, ScenarioType
    from pdmpc_torch.ops import collision as coll

    circle = Config(scenario_type=ScenarioType.circle, amount=10, T_end=8.0)
    zero_counts(coll)
    step_seconds = []
    infos = sharded_block_run(circle, (2, 2), 2, step_seconds)
    launched = counts(coll)

    def sharded_run(cfg, device):
        sharded_block_run(cfg, (2, 2), 2)

    rows = {"sat_hits": {}}
    short = replace(circle, T_end=3.0)
    if dist.get_rank() == 0:
        calls = plans_with_plain_versions(
            torch, coll, sharded_run, short, "sharded circle level",
            rank=lambda args, kw: (args[1].shape[0], active_slots(args, kw)))
        path_shapes(torch, coll, calls, rows, ("sat_hits",),
                    "sharded circle level", row_key="path_sharded")
    else:
        sharded_run(short, device)
    return {"infos": infos, "launches": launched,
            "step_seconds": step_seconds, "rows": rows}


def distributed_modes(torch, coll, Config, card, by_path, rows, road_res,
                      circle_res):
    """Phase 18: the parallel computation modes on the card."""
    import tempfile

    import torch.distributed as dist

    from pdmpc_torch.experiment import ExperimentResult
    from pdmpc_torch.parallel import multihost

    road = Config(amount=20, T_end=4.0)
    road_ms = np.median(road_res.timings["step_seconds"]) * 1e3
    # ---- 18a: the dense level loop on one rank, NCCL --------------------
    multihost.initialize_distributed(f"127.0.0.1:{multihost.free_port()}",
                                     1, 0, "nccl", "cuda")
    try:
        zero_counts(coll)
        step_seconds = []
        infos = sharded_block_run(road, (1, 1), 1, step_seconds)
        launched = counts(coll)
        nccl = collective_ms(torch.device("cuda"))
    finally:
        dist.destroy_process_group()
    hold_entries(infos, road_res, "18a sharded road (1, 1) nccl", 1)
    n_steps = road_res.n_steps
    record_counts(by_path, "sharded road 1x1 nccl", launched, n_steps)
    print(f"18a sharded road, mesh (1, 1), NCCL ({card}): equal to phase "
          f"3's run in every record; step median "
          f"{np.median(step_seconds) * 1e3:.3f} ms (phase 3 "
          f"{road_ms:.3f} ms); launches per step "
          + ", ".join(f"{k} {launched[k] / n_steps:.2f}" for k in KERNELS),
          flush=True)
    # ---- 18b: two processes on the card through the multihost entry ----
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=HERE,
                   PDMPC_RESULTS_DIR=os.path.join(tmp, "results"))
        address = f"127.0.0.1:{multihost.free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "pdmpc_torch.parallel.multihost",
             "--coordinator", address, "--num-processes", "2",
             "--process-id", str(i), "--backend", "gloo", "--device",
             "cuda", "--", "--amount", "20", "--t-end", "4.0"], cwd=tmp,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for i in range(2)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for i, (p, out) in enumerate(zip(procs, outs)):
            print(f"18b rank {i}: " + " | ".join(out.strip().splitlines()[
                -2:]), flush=True)
            if p.returncode != 0:
                raise AssertionError(f"18b rank {i} failed:\n{out[-3000:]}")
        saved = [os.path.join(d, f) for d, _, files in os.walk(tmp)
                 for f in files if f.endswith(".json")
                 and f != "Config.json"]
        res = ExperimentResult.load(saved[0][:-len(".json")])
    bad = differing_fields(res.infos, road_res.infos)
    if len(saved) != 1 or bad or res.timings["mesh"] != [1, 2]:
        raise AssertionError(f"18b: {len(saved)} results, mesh "
                             f"{res.timings['mesh']}, differing {bad}")
    launched = {k: sum(r[k] for r in res.timings["launches_by_rank"])
                for k in KERNELS + FORMS}
    record_counts(by_path, "sharded road 1x2 gloo", launched, n_steps)
    print(f"18b sharded road, mesh (1, 2), 2 processes on one card, gloo "
          f"({card}): equal to phase 3's run in every record; step median "
          f"{np.median(res.timings['step_seconds']) * 1e3:.3f} ms (phase 3 "
          f"{road_ms:.3f} ms); launches per step and rank "
          + "; ".join(", ".join(f"{k} {r[k] / n_steps:.2f}" for k in KERNELS)
                      for r in res.timings["launches_by_rank"]), flush=True)
    # ---- 18c: four ranks, B = 2, the circle; one level with plain ------
    ranks = multihost.spawn(sharded_circle_rank, 4, backend="gloo",
                            device="cuda", timeout=600)
    for i, r in enumerate(ranks):
        hold_entries(r["infos"], circle_res, f"18c rank {i}", 2)
    launched = {k: sum(r["launches"][k] for r in ranks)
                for k in KERNELS + FORMS}
    n_steps = circle_res.n_steps
    record_counts(by_path, "sharded circle 2x2 gloo", launched, n_steps)
    rows["sat_hits"]["path_sharded"] = ranks[0]["rows"]["sat_hits"][
        "path_sharded"]
    circle_ms = np.median(circle_res.timings["step_seconds"]) * 1e3
    print(f"18c sharded circle, mesh (2, 2), B = 2, 4 processes on one "
          f"card, gloo ({card}): both entries of every rank equal to phase "
          f"5's run; step median "
          f"{np.median(ranks[0]['step_seconds']) * 1e3:.3f} ms (phase 5 "
          f"{circle_ms:.3f} ms); sat_hits launches per step and rank "
          + ", ".join(f"{r['launches']['sat_hits'] / n_steps:.2f}"
                      for r in ranks), flush=True)
    # ---- 18d: the collectives' time, and the scaling line ---------------
    gloo = multihost.spawn(collective_ms, 2, backend="gloo", device="cuda",
                           timeout=300)[0]
    for line in (nccl, gloo):
        print(f"18d collectives ({card}): {json.dumps(line)}", flush=True)
    scaling = subprocess.run(
        [sys.executable, "-m", "pdmpc_torch.parallel.scaling", "--device",
         "cuda", "--ranks", "2"], cwd=HERE, capture_output=True, text=True,
        timeout=600)
    if scaling.returncode != 0:
        raise AssertionError(f"18d scaling failed:\n{scaling.stdout}"
                             f"{scaling.stderr[-3000:]}")
    print(f"18d scaling ({card}): {scaling.stdout.strip().splitlines()[-1]}",
          flush=True)


def hold_host_run(res, ref, label):
    """Raise unless a host-loop result equals a run_experiment result in
    every record."""
    bad = differing_fields(res.infos, ref.infos)
    if res.n_steps != ref.n_steps or bad:
        raise AssertionError(f"{label}: {res.n_steps} steps against "
                             f"{ref.n_steps}, differing {bad}")


def span_medians(res):
    """Medians (ms) of the host loop's measure, plan and apply spans."""
    return {span: float(np.median(np.asarray(res.timings[span])[1]) * 1e3)
            for span in ("measure", "plan", "apply")}


def replay_oracle(torch, coll, Config, card, record):
    """19g: the cr3 golden configuration on the card, step by step with
    ``debug_capture``: every plan oracle-optimal under the numpy and the
    native A* (tests/test_oracle_replay.py's checks on the CPU)."""
    from pdmpc_torch.controller import make_prioritized_step
    from pdmpc_torch.experiment import create_scenario
    from pdmpc_torch.models.mpa import build_mpa
    from pdmpc_torch.native import astar_plan_native
    from pdmpc_torch.parallel.sharded import batched_initial_state
    from pdmpc_torch.utils.astar_oracle import astar_plan

    cfg = Config(amount=3, T_end=4.0, beam_width=64).validate()
    mpa = build_mpa(cfg)
    mpa_t = mpa.to_tensors_for(cfg, "cuda")
    sc_t = create_scenario(cfg, mpa).to_tensors("cuda")
    step = make_prioritized_step(cfg, mpa_t, sc_t, debug_capture=True)
    state = batched_initial_state(sc_t, cfg.Hp, 1)
    zero_counts(coll)
    steps = []
    for k in range(cfg.k_end):
        state, info, cap = step(state, k)
        steps.append((type(info)(*(x[0].cpu().numpy() for x in info)),
                      {key: v.cpu().numpy() for key, v in cap.items()}))
    launches = {name: getattr(coll, name).launches for name in KERNELS}
    if not (launches["outline_hits"] and launches["boundary_hits"]) \
            or launches["sat_hits"]:
        raise AssertionError(f"19g: launches {launches}")
    checked, gaps, native_s, numpy_s = 0, [], 0.0, 0.0
    for k, (info, cap) in enumerate(steps):
        for v in range(cfg.amount):
            if info.needs_fallback[v] or info.is_exhausted[v]:
                continue
            obs = cap["obs_polys"][v]
            kw = dict(x0=cap["pose0"][v], trim0=int(cap["trim0"][v]),
                      ref_points=cap["ref_points"][v], v_ref=cap["v_ref"][v],
                      obs_polys=obs, obs_mask=np.broadcast_to(
                          cap["obs_mask"][v][:, None], (obs.shape[0],
                                                        cfg.Hp)),
                      dt=cfg.dt_seconds, boundary_segments=cap["bnd_segs"][v],
                      boundary_mask=cap["bnd_mask"][v], non_convex=True)
            t0 = time.perf_counter()
            oracle = astar_plan(mpa, **kw)
            numpy_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            native = astar_plan_native(mpa, **kw)
            native_s += time.perf_counter() - t0
            beam = float(info.cost[v])
            gap = (beam - oracle.cost) / max(oracle.cost, 1e-9)
            if (oracle.is_exhausted or oracle.cost > beam * (1 + 1e-4) + 1e-6
                    or gap > 1e-3 or not (info.trims[v]
                                          == oracle.trims).all()):
                raise AssertionError(f"19g step {k} vehicle {v}: beam "
                                     f"{beam} {info.trims[v]}, oracle "
                                     f"{oracle.cost} {oracle.trims}")
            if (native.is_exhausted or not (native.trims == oracle.trims).all()
                    or abs(native.cost - oracle.cost)
                    > 1e-9 * abs(oracle.cost)):
                raise AssertionError(f"19g step {k} vehicle {v}: native "
                                     f"{native.cost} {native.trims}, numpy "
                                     f"{oracle.cost} {oracle.trims}")
            gaps.append(gap)
            checked += 1
    if checked < 40:
        raise AssertionError(f"19g: only {checked} plans checked")
    print(f"19g oracle replay, cr3 beam 64 with debug_capture ({card}): "
          f"{checked} plans oracle-optimal under the numpy and the native "
          f"A* (largest relative gap {max(gaps):.3e}); oracle seconds a "
          f"plan: numpy {numpy_s / checked:.4f}, native "
          f"{native_s / checked:.6f}; launches per step "
          + ", ".join(f"{k} {v / cfg.k_end:.2f}" for k, v in
                      launches.items()), flush=True)
    record("cr3 debug_capture", launches, SimpleNamespace(n_steps=cfg.k_end))


def host_loop_and_evaluation(torch, coll, Config, card, dims, record,
                             road, road_res, circle_res, headline,
                             headline_res):
    """Phase 19: the host-driven loop, the plants and the evaluation."""
    import tempfile

    from pdmpc_torch import ScenarioType, hlc
    from pdmpc_torch.eval import experiments, phd
    from pdmpc_torch.eval.processing import normalize_timing_results
    from pdmpc_torch.experiment import (
        ExperimentResult,
        create_scenario,
        run_experiment,
    )
    from pdmpc_torch.models.mpa import build_mpa
    from pdmpc_torch.plant import ExternalPlant
    from pdmpc_torch.plant_bridge import PlantBridgeClient, launch_server
    from pdmpc_torch.utils import filenames
    from pdmpc_torch.utils.timing import profile_trace

    road_kernels = ("outline_hits", "boundary_hits")
    road_cfg = Config(amount=20, T_end=4.0)
    circle_cfg = Config(scenario_type=ScenarioType.circle, amount=10,
                        T_end=8.0)
    device_name = torch.cuda.get_device_name(0)
    t_phase = time.perf_counter()
    # ---- 19a: phase 3's run through the host loop -----------------------
    # phase 3's run again first: the host-bound step's time drifts over
    # the phases of one process, so the spans are compared with a step
    # median taken just before them
    again = run_experiment(road_cfg, device="cuda")
    launches, host_road = counted_run(coll, hlc.run_with_plant, road_cfg,
                                      "19a host loop road", road_kernels)
    hold_host_run(host_road, road_res, "19a")
    hold_host_run(again, road_res, "19a phase 3 again")
    if launches != road:
        raise AssertionError(f"19a: launches {launches}, phase 3 {road}")
    record("host loop road", launches, host_road)
    print(f"19a host loop, phase 3's cr20 with the simulation plant "
          f"({card}): equal to phase 3's run in every record, launches per "
          f"step " + ", ".join(f"{k} {v / host_road.n_steps:.2f}"
                               for k, v in launches.items())
          + f" (phase 3's); span medians ms {span_medians(host_road)}; "
          f"step median of phase 3's run just before "
          f"{np.median(again.timings['step_seconds']) * 1e3:.3f} ms "
          f"(phase 3: "
          f"{np.median(road_res.timings['step_seconds']) * 1e3:.3f} ms)",
          flush=True)
    # ---- 19b: the headline through the host loop; values.txt ------------
    launches, host_headline = counted_run(
        coll, hlc.run_with_plant, headline, "19b host loop headline",
        road_kernels)
    hold_host_run(host_headline, headline_res, "19b")
    record("host loop headline", launches, host_headline)
    values = phd.compute_values(host_headline, i_step_start=1)
    with tempfile.TemporaryDirectory() as tmp:
        path = phd.write_values_txt(
            host_headline, path=os.path.join(tmp, "values.txt"),
            i_step_start=1, label=f"{device_name} cr20 coloring (host loop)")
        with open(path) as f:
            line = f.read().strip()
    print(f"19b host loop, the headline ({card}): equal to phase 9's run in "
          f"every record; compute_values {values}; values.txt: {line}; span "
          f"medians ms {span_medians(host_headline)}", flush=True)
    # ---- 19c: phase 5's circle against a plant in another process -------
    offset_s = 37.5
    scenario = create_scenario(circle_cfg.validate(),
                               build_mpa(circle_cfg.validate()))
    with tempfile.TemporaryDirectory() as tmp:
        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump({"start_poses": scenario.start_poses.tolist(),
                       "clock_offset_s": offset_s}, f)
        proc, port = launch_server(spec, 60.0)
        try:
            client = PlantBridgeClient("127.0.0.1", port, timeout_s=60.0)
            plant = ExternalPlant(circle_cfg, measure_fn=client.measure_fn,
                                  command_fn=client.command_fn)
            launches, bridged = counted_run(
                coll, partial(hlc.run_with_plant, plant=plant), circle_cfg,
                "19c bridge circle", ("sat_hits",))
            server = client.finish()
            if proc.wait(timeout=60) != 0:
                raise AssertionError(f"19c: server exit {proc.returncode}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    hold_host_run(bridged, circle_res, "19c")
    record("bridge circle", launches, bridged)
    send = np.asarray(client.command_send_times)
    recv = np.asarray(server["command_recv_times"])
    if len(send) != bridged.n_steps or len(recv) != bridged.n_steps:
        raise AssertionError(f"19c: {len(send)} commands sent, {len(recv)} "
                             f"received in {bridged.n_steps} steps")
    normed = normalize_timing_results(
        [{"receive_from_others": np.stack([t, np.zeros_like(t)]),
          "controller_start_time": float(t[0])} for t in (send, recv)])
    recovered = normed[1]["offset"] - normed[0]["offset"]
    if abs(recovered - offset_s) >= 1.0:
        raise AssertionError(f"19c: offset {recovered} recovered")
    print(f"19c bridge, phase 5's circle through ExternalPlant and python -m "
          f"pdmpc_torch.plant_bridge ({card}): equal to phase 5's run in "
          f"every record; one command sent and received a step; clock "
          f"offset {offset_s} s recovered as {recovered:.6f} s; span "
          f"medians ms {span_medians(bridged)}; sat_hits launches per step "
          f"{launches['sat_hits'] / bridged.n_steps:.2f}", flush=True)
    # ---- 19d: a failure mid-run leaves a partial save -------------------
    saved_root = filenames.RESULTS_ROOT
    with tempfile.TemporaryDirectory() as tmp:
        filenames.RESULTS_ROOT = tmp
        try:
            def fail_at_4(k, info):
                if k == 4:
                    raise RuntimeError("injected failure at step 4")
            try:
                hlc.run_with_plant(circle_cfg, on_step=fail_at_4,
                                   device="cuda")
                raised = False
            except RuntimeError as err:
                if "injected failure" not in str(err):
                    raise
                raised = True
            metas = [os.path.join(d, f) for d, _, files in os.walk(tmp)
                     for f in files if f.endswith(".json")]
            served = filenames.load_latest(circle_cfg.validate())
        finally:
            filenames.RESULTS_ROOT = saved_root
        truncated = ExperimentResult.load(metas[0][:-len(".json")]) \
            if len(metas) == 1 else None
    if not raised or served is not None or truncated is None:
        raise AssertionError(f"19d: raised {raised}, {len(metas)} saves, "
                             f"served {served is not None}")
    head = type(circle_res.infos)(*(x[:5] for x in circle_res.infos))
    if truncated.n_steps != 5 or differing_fields(truncated.infos, head):
        raise AssertionError(f"19d: the partial save's {truncated.n_steps} "
                             f"steps differ from phase 5's")
    print(f"19d save on error ({card}): the failure at step 4 reached the "
          f"phase, the partial result (5 steps, equal to phase 5's first "
          f"5) is saved and not served", flush=True)
    # ---- 19e: the sweeps at smoke size, and the figures -----------------
    base = Config(amount=10, T_end=2.0, beam_width=128)
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(n_vehicles_list=(10,), seeds=(1,), root=tmp,
                  device="cuda")
        t0 = time.perf_counter()
        sweeps = {"prioritization": experiments.eval_prioritization(base,
                                                                    **kw),
                  "bounding": experiments.eval_bounding(base, bounds=(1, 99),
                                                        **kw)}
        sweep_s = time.perf_counter() - t0
        runs = [ExperimentResult.load(os.path.join(d, f)[:-len(".json")])
                for d, _, files in os.walk(tmp) for f in files
                if f.endswith(".json")]
        for res in runs:
            hits = vehicle_collisions(res.infos.poses[:, :, 0], *dims)
            if hits:
                raise AssertionError(f"19e {res.options.priority.value} "
                                     f"max_num_CLs {res.options.max_num_CLs}"
                                     f": collisions {hits[:5]}")
        for name, cells in sweeps.items():
            for key, summary in cells.items():
                print(f"19e {name} {key}: fallback rate "
                      f"{summary['fallback_rate']:.4f}, levels max "
                      f"{summary['max_levels']} median "
                      f"{summary['median_levels']}, total cost "
                      f"{summary['total_cost']:.6f}, step mean "
                      f"{summary['step_time_mean_ms']:.3f} ms", flush=True)
    if len(runs) != 6:
        raise AssertionError(f"19e: {len(runs)} runs saved, not 6")
    print(f"19e sweeps ({card}): commonroad 10 vehicles, beam 128, 1 seed, "
          f"T_end 2.0, bounds (1, 99): {len(runs)} runs collision-free in "
          f"{sweep_s:.1f} s (the figures need matplotlib, which this host "
          f"may lack: tests/test_torch_viz.py draws them)", flush=True)
    # ---- 19f: profile_trace names the three kernels ---------------------
    from pdmpc_torch.controller import make_prioritized_step
    from pdmpc_torch.parallel.sharded import batched_initial_state

    with tempfile.TemporaryDirectory() as tmp:
        steps = []
        for cfg in (road_cfg.validate(), circle_cfg.validate()):
            mpa = build_mpa(cfg)
            sc_t = create_scenario(cfg, mpa).to_tensors("cuda")
            step = make_prioritized_step(cfg, mpa.to_tensors_for(cfg, "cuda"),
                                         sc_t)
            state, _ = step(batched_initial_state(sc_t, cfg.Hp, 1), 0)
            steps.append((step, state))
        torch.cuda.synchronize()
        with profile_trace(tmp) as prof:
            for step, state in steps:
                step(state, 1)
            torch.cuda.synchronize()
        with open(os.path.join(tmp, "trace.json")) as f:
            trace = f.read()
        trace_mb = len(trace) / 1e6
    names = {e.key: e.count for e in prof.key_averages()}
    missing = [k for k in KERNELS if f'"{k}"' not in trace]
    device_kernels = {frag: sum(c for key, c in names.items() if frag in key)
                      for frag in ("OutlineSegs", "BoundarySegs",
                                   "sat_hits_kernel")}
    if missing or not all(device_kernels.values()):
        raise AssertionError(f"19f: trace lacks {missing}, device kernels "
                             f"{device_kernels}")
    print(f"19f profile_trace of a road and a circle step ({card}): a "
          f"{trace_mb:.1f} MB Chrome trace naming "
          + ", ".join(f"{k} ({names.get(k, 0)} ranges)" for k in KERNELS)
          + f"; their device kernels {device_kernels}", flush=True)
    # ---- 19g: the oracle replay on the card -----------------------------
    replay_oracle(torch, coll, Config, card, record)
    print(f"phase 19 ({card}): {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def geometry_inputs():
    """Phase 20a's inputs (numpy, from the seed): random convex polygons,
    boxes with integer corners (exact touches), paths and their masks,
    padded polygons and their vertex masks, a corridor of two rings, and
    blobs of 16 vertices against it (the last 8 some 20 m away)."""
    rng = np.random.default_rng(SEED + 20)
    a, b = rand_polys(rng, 256, 6, 1.0), rand_polys(rng, 192, 5, 1.0)
    # integer boxes: exact touches along edges and at corners
    lo = rng.integers(0, 6, (128, 1, 2))
    size = rng.integers(1, 3, (128, 1, 2))
    unit = np.array([[0, 0], [1, 0], [1, 1], [0, 1]])
    boxes = lo + unit * size
    paths_a = rng.uniform(0, 4, (512, 7, 2))
    paths_b = rng.uniform(0, 4, (512, 5, 2))
    paths_b[::4, 1] = paths_a[::4, 2]
    mask_a, mask_b = rng.random((512, 6)) < 0.4, rng.random((512, 4)) < 0.6
    n_valid = rng.integers(3, 7, (256, 1))
    vertex_mask = np.arange(6) < n_valid
    padded = np.where(vertex_mask[..., None], a,
                      rng.uniform(-9, 9, a.shape))
    strip = [[0, 0], [6, 0], [6, 1], [0, 1], [0, 0], [0, 0]]
    box = [[2, 1], [3, 1], [3, 3], [2, 3], [2, 1], [2, 1]]
    rings = np.array([strip, box], dtype=float)
    segs = np.stack([np.stack([r[:4], r[1:5]], axis=1) for r in rings]
                    ).reshape(-1, 2, 2)
    blobs = rand_polys(rng, 128, 16, 0.8)
    blobs[-8:] += 20.0                               # away from the corridor
    return dict(a=a, b=b, boxes=boxes, paths_a=paths_a, paths_b=paths_b,
                mask_a=mask_a, mask_b=mask_b, vertex_mask=vertex_mask,
                padded=padded, rings=rings, segs=segs, blobs=blobs)


def ulps(torch, got, want):
    """|got - want| in units of the last place of ``want`` (f32)."""
    up = torch.nextafter(want.abs(), torch.tensor(float("inf")))
    return (got - want).abs() / (up - want.abs())


def geometry_api(torch, card):
    """20a: the geometry API (``ops.geometry``) on the card against the
    same inputs on the CPU: masks and boxes equal; areas within rtol 1e-6
    and atol 1e-7 m2 (a sum's order and the angle sort's atan2 may round a
    last bit apart); corridor bounds within ``CORRIDOR_ATOL``. Of the
    support fit's ops (``outer_poly_approx``) only cos and sin are not
    correctly rounded on both devices: their readings on the fit's 24
    directions print, and the fit of the same points on both devices."""
    from pdmpc_torch.ops import geometry as geo

    inputs = geometry_inputs()
    segs = inputs["segs"]

    def on(dev):
        t = {k: tensor(torch, v, dev, torch.bool if v.dtype == bool else
                       torch.float32) for k, v in inputs.items()}
        seg_mask = torch.ones(segs.shape[0], dtype=torch.bool, device=dev)
        return {
            "sat_collide_pairwise": geo.sat_collide_pairwise(t["a"], t["b"]),
            "sat_collide_pairwise (touching boxes)":
                geo.sat_collide_pairwise(t["boxes"], t["boxes"]),
            "segments_intersect_any": geo.segments_intersect_any(
                t["paths_a"], t["paths_b"], t["mask_a"], t["mask_b"]),
            "polygon_bbox": torch.stack(geo.polygon_bbox(t["a"])),
            "bboxes_overlap": geo.bboxes_overlap(
                tuple(x[:, None] for x in geo.polygon_bbox(t["a"])),
                tuple(x[None] for x in geo.polygon_bbox(t["b"]))),
            "convex_intersection_area": geo.convex_intersection_area(
                t["a"][:192], t["b"]),
            "polygon_area (mask)": geo.polygon_area(t["padded"],
                                                    t["vertex_mask"]),
            "bound_convex_to_corridor (k_dirs 24)":
                geo.bound_convex_to_corridor(t["blobs"], t["rings"],
                                             t["segs"], seg_mask, k_dirs=24),
        }

    cpu, cuda = on("cpu"), on("cuda")
    theta = (2.0 * np.pi * torch.arange(24, dtype=torch.float32) / 24)
    for fn in (torch.cos, torch.sin):
        off = ulps(torch, fn(theta.cuda()).cpu(), fn(theta))
        print(f"20a {fn.__name__} of the 24 directions ({card}): "
              f"{int((off > 0).sum())} of 24 differ from the CPU's, "
              f"at most {float(off.max()):.3g} ulp", flush=True)
    blobs = tensor(torch, inputs["blobs"], "cpu", torch.float32)
    full = torch.ones(blobs.shape[:-1], dtype=torch.bool)
    fit = geo.outer_poly_approx(blobs, full, 24)
    err = (geo.outer_poly_approx(blobs.cuda(), full.cuda(), 24).cpu()
           - fit).abs()
    print(f"20a outer_poly_approx of the same blobs ({card}): max abs "
          f"difference {float(err.max()):.3e} m, at |x| "
          f"{float(fit.flatten()[err.argmax()].abs()):.3g} m", flush=True)
    for name, want in cpu.items():
        got = cuda[name].cpu()
        if want.dtype == torch.bool or name == "polygon_bbox":
            bad = int((got != want).sum())
            shares = (f", {float(want.float().mean()):.4f} true"
                      if want.dtype == torch.bool else "")
            print(f"20a {name} ({card}): {bad} mismatches of "
                  f"{want.numel()}{shares}", flush=True)
            if bad or (want.dtype == torch.bool
                       and not 0 < int(want.sum()) < want.numel()):
                raise AssertionError(f"20a {name}: {bad} mismatches")
            continue
        tol = ((0.0, CORRIDOR_ATOL) if name.startswith("bound_convex")
               else (1e-6, 1e-7))
        err = (got - want).abs()
        print(f"20a {name} ({card}): max abs difference "
              f"{float(err.max()):.3e}, at |x| "
              f"{float(want.flatten()[err.argmax()].abs()):.3g} "
              f"(rtol {tol[0]}, atol {tol[1]})", flush=True)
        torch.testing.assert_close(got, want, rtol=tol[0], atol=tol[1])


def last_slice(torch, coll, Config, card, dims, by_path, rows):
    """Phase 20: the geometry API, the graft entry and the tools."""
    from pdmpc_torch import ScenarioType, graft_entry
    from pdmpc_torch.experiment import run_experiment
    from pdmpc_torch.parallel.sharded import batched_initial_state
    from pdmpc_torch.tools import axis_sweep, nonconvex_delta, speed_of_light

    t_phase = time.perf_counter()
    # ---- 20a: the geometry API, card against CPU ------------------------
    geometry_api(torch, card)
    # ---- 20b: the graft entry and its dry run ---------------------------
    zero_counts(coll)
    fn, args = graft_entry.entry()
    states, info = fn(*args)
    torch.cuda.synchronize()
    launched = counts(coll)
    record_counts(by_path, "graft entry (B = 4)", launched, 1)
    one = run_experiment(Config(scenario_type=ScenarioType.circle, amount=8,
                                T_end=0.2, beam_width=256), device="cuda")
    info = type(info)(*(x.cpu().numpy() for x in info))
    for b in range(4):
        bad = differing_fields(type(info)(*(x[b][None] for x in info)),
                               one.infos)
        if bad:
            raise AssertionError(f"20b entry(): scenario {b} differs from "
                                 f"run_experiment's first step in {bad}")
    if not launched["sat_hits"] or launched["outline_hits"]:
        raise AssertionError(f"20b entry(): launches {launched}")
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(2, backend="gloo")
    print(f"20b graft_entry ({card}): entry() steps the 8-vehicle circle at "
          f"beam 256 for 4 scenarios, each equal to run_experiment's first "
          f"step; launches {launched}; dryrun_multichip(2, gloo, two ranks "
          f"on the card) in {time.perf_counter() - t0:.1f} s", flush=True)
    # ---- 20c: the axis sweep --------------------------------------------
    road_pair = {"outline_hits", "boundary_hits"}
    failed = []
    cases = axis_sweep.sweep_cases()
    for name, cfg in cases.items():
        rec = axis_sweep.run_case(cfg, "cuda")
        print(f"20c {json.dumps({name: rec})}", flush=True)
        if not rec["ok"]:
            failed.append(f"{name}: {rec['error']}")
            continue
        want = (set() if not cfg.is_prioritized
                else {"sat_hits"} if cfg.scenario_type == ScenarioType.circle
                else road_pair)
        got = {k for k, v in rec["launches"].items() if v}
        if got != want:
            failed.append(f"{name}: launched {sorted(got)}, not "
                          f"{sorted(want)}")
        unmapped = [w for w in rec["warnings"] if "summation order" in w]
        if unmapped:
            failed.append(f"{name}: an unmapped vote shape: {unmapped}")
        record_counts(by_path, f"sweep {name}",
                      {**rec["launches"], **rec["lattice_launches"]},
                      rec["steps"])
    if failed:
        raise AssertionError(f"20c axis sweep: {failed}")
    print(f"20c axis sweep ({card}): {len(cases)} cases ok, each with the "
          f"kernels of its path", flush=True)
    # ---- 20d: convex against non-convex obstacles at cr20 ---------------
    delta, results = nonconvex_delta.measure(device="cuda")
    for geometry, res in results.items():
        hits = vehicle_collisions(res.infos.poses[:, :, 0], *dims)
        launches = delta[geometry]["launches"]
        want = ({"sat_hits", "boundary_hits"} if geometry == "convex"
                else road_pair)
        if hits or {k for k in KERNELS if launches[k]} != want:
            raise AssertionError(f"20d {geometry}: collisions {hits[:5]}, "
                                 f"launches {launches}")
        record_counts(by_path, f"nonconvex_delta {geometry}", launches,
                      res.n_steps)
    print(f"20d nonconvex_delta ({card}): {json.dumps(delta)}", flush=True)
    # ---- 20e: speed of light at the cr20 production shapes --------------
    cfg, mpa_t, sc_t = batch_tensors(Config(amount=20, T_end=4.0,
                                            beam_width=256))
    from pdmpc_torch.controller import make_prioritized_step

    state, _ = make_prioritized_step(cfg, mpa_t, sc_t)(
        batched_initial_state(sc_t, cfg.Hp, 1), 0)
    step = profiled_step(cfg, state, 1)
    sol = speed_of_light.measure(step_device_ms=step["device_ms"])
    print(f"20e speed_of_light ({card}): {json.dumps(sol)}", flush=True)
    if not sol["ok"]:
        raise AssertionError("20e: a share above "
                             f"{speed_of_light.MAX_SHARE} or a mismatch")
    for name in KERNELS:
        rows[name]["speed_of_light"] = sol["kernels"][name]
    print(f"phase 20 ({card}): {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# keys of a kernel's row in the JSON line, and their types
CONTRACT = {"name": str, "route": str, "source": str, "replaces": str,
            "launches": int, "max_abs_err": float, "ms": float,
            "plain_ms": float, "bound_ms": float, "bound_by": str,
            "library_ms": type(None)}


def check_contract(rows):
    """Raise unless every kernel row has each key of CONTRACT with a value
    of its type."""
    for row in rows:
        for key, kind in CONTRACT.items():
            if not isinstance(row.get(key), kind):
                raise AssertionError(f"{row['name']}: {key} = "
                                     f"{row.get(key)!r}, not {kind.__name__}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from pdmpc_torch import (
        Config,
        OptimizerType,
        PriorityStrategies,
        ScenarioType,
        WeightStrategies,
    )
    from pdmpc_torch.experiment import run_experiment
    from pdmpc_torch.models.bicycle import VEHICLE_LENGTH, VEHICLE_WIDTH
    from pdmpc_torch.ops import collision as coll

    dims = (VEHICLE_LENGTH, VEHICLE_WIDTH)
    circle = ScenarioType.circle
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    coll.build_kernels(verbose=True)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32

    # ---- 2. kernels vs plain ----------------------------------------------
    rows = {row["name"]: row for row in check_kernels(torch, coll, "cuda")}

    # launches and launches a step of every driven run, per kernel
    by_path = {name: {} for name in KERNELS}

    def record(label, launches, res):
        """The run's launches of each kernel, in all and a step, and of
        its lattice form (still on the counters ``counted_run`` read)."""
        for name, count in launches.items():
            by_path[name][label] = {
                "launches": count, "per_step": count / res.n_steps,
                "lattice_launches": getattr(coll, name + "_lattice").launches}

    # ---- 3. road path -----------------------------------------------------
    road_kernels = ("outline_hits", "boundary_hits")
    road, road_res = drive(coll, run_experiment,
                           Config(amount=20, T_end=4.0), card, "road path",
                           road_kernels, dims)
    record("road", road, road_res)
    # ---- 4. road golden gate ----------------------------------------------
    golden_gate(run_experiment, Config(amount=20, T_end=4.0, beam_width=64),
                "commonroad_20veh")
    # ---- 5. convex path ---------------------------------------------------
    convex, circle_res = drive(
        coll, run_experiment,
        Config(scenario_type=circle, amount=10, T_end=8.0), card,
        "circle path", ("sat_hits",), dims)
    record("circle", convex, circle_res)
    for name in road_kernels:
        rows[name]["launches"] = road[name]
        rows[name]["launches_per_step"] = road[name] / road_res.n_steps
    rows["sat_hits"]["launches"] = convex["sat_hits"]
    rows["sat_hits"]["launches_per_step"] = (convex["sat_hits"]
                                             / circle_res.n_steps)
    # ---- 6. convex golden gate --------------------------------------------
    golden_gate(run_experiment,
                Config(scenario_type=circle, amount=3, T_end=2.0, Hp=10,
                       beam_width=128), "circle_03veh_hp10")
    # ---- 7. plan level: kernels against plain versions --------------------
    road_calls = plans_with_plain_versions(
        torch, coll, run_experiment, Config(amount=20, T_end=1.0),
        "road chunk")
    circle_calls = plans_with_plain_versions(
        torch, coll, run_experiment,
        Config(scenario_type=circle, amount=10, T_end=3.0), "circle chunk")
    # ---- 8. the kernels at the recorded chunks' own shapes ---------------
    path_shapes(torch, coll, road_calls, rows, road_kernels, "road chunk")
    path_shapes(torch, coll, circle_calls, rows, ("sat_hits",),
                "circle chunk")
    # ---- 9. headline: cr20 coloring at beam 256 ---------------------------
    headline = Config(amount=20, T_end=4.0, beam_width=256,
                      priority=PriorityStrategies.coloring_priority)
    launches, headline_res = drive(coll, run_experiment, headline, card,
                                   "headline", road_kernels, dims,
                                   n_road=headline.amount)
    record("headline", launches, headline_res)
    headline_gate(headline_res)
    # ---- 10. mixed fleet --------------------------------------------------
    mixed64 = Config(scenario_type=ScenarioType.mixed, amount=64, T_end=2.0,
                     beam_width=128)
    launches, res = drive(coll, run_experiment, mixed64, card, "mixed64",
                          road_kernels, dims, min_moved=0.2,
                          max_fallback_share=None, n_road=40)
    record("mixed64", launches, res)
    # a chunk with a free-space vehicle (no active boundary segment),
    # planned with kernels and with plain versions, and every layer's
    # lattice-form call held bit for bit (3 families x 64 vehicles: the
    # outline kernel's whole 3,072-edge stage)
    mixed_calls = plans_with_plain_versions(
        torch, coll, run_experiment,
        Config(scenario_type=ScenarioType.mixed, amount=64, T_end=0.4,
               beam_width=128), "mixed64 chunk", rank=free_space_first)
    path_shapes(torch, coll, mixed_calls, rows, road_kernels,
                "mixed64 chunk", row_key="path_mixed64")
    # ---- 11. strategy goldens --------------------------------------------
    for name, cfg in strategy_goldens(Config):
        launched = (("sat_hits",) if cfg.scenario_type == circle
                    else road_kernels)
        launches, res = golden_gate(run_experiment, cfg, name, coll,
                                    launched)
        record(name, launches, res)
    # ---- 12. voting: optimal and explorative against constant -----------
    voting(coll, run_experiment, Config, card, dims, record)
    # ---- 13. stage rounds: bundles past one 48 KB stage ------------------
    oversize = oversize_bundles(torch, coll, "cuda")
    for name in KERNELS:
        rows[name]["oversize"] = oversize[name]
    # 3 families x 40 vehicles: 120 SAT obstacles, 128 once padded
    launches, res = drive(
        coll, run_experiment,
        Config(scenario_type=circle, amount=40, T_end=2.0, beam_width=128),
        card, "circle40", ("sat_hits",), dims, min_moved=None,
        max_fallback_share=None)
    record("circle40", launches, res)
    circle40_calls = plans_with_plain_versions(
        torch, coll, run_experiment,
        Config(scenario_type=circle, amount=40, T_end=0.4, beam_width=128),
        "circle40 chunk")
    path_shapes(torch, coll, circle40_calls, rows, ("sat_hits",),
                "circle40 chunk", row_key="path_circle40")
    # ---- 14. the random strategies and the sampled search at full width --
    sampled = OptimizerType.TpuSampled
    for label, cfg, launched, lattice in (
            ("cr20 random", Config(
                amount=20, T_end=4.0,
                priority=PriorityStrategies.random_priority,
                weight=WeightStrategies.random_weight), road_kernels, True),
            ("cr20 sampled", Config(amount=20, T_end=4.0,
                                    optimizer_type=sampled),
             road_kernels, False),
            ("circle sampled", Config(scenario_type=circle, amount=10,
                                      T_end=8.0, optimizer_type=sampled),
             ("sat_hits",), False)):
        # on the road: on some lanelet of the map. With other priorities
        # than the reference's goldens a vehicle can leave its route at a
        # fork through the open end of its lanelet (PERF.md, Findings, PR
        # 6); those steps are printed
        launches, res = drive(coll, run_experiment, cfg, card, label,
                              launched, dims, max_fallback_share=None,
                              n_road=cfg.amount if launched == road_kernels
                              else 0, lattice=lattice, route=False)
        record(label, launches, res)
    rows["sat_hits"]["rollout_noise"] = noise_cost(torch)
    # one sampled chunk of each path, with kernels and with plain versions,
    # and every layer's (cx, cy)-form call held bit for bit and timed
    for cfg, names, label in (
            (Config(amount=20, T_end=1.0, optimizer_type=sampled),
             road_kernels, "cr20 sampled chunk"),
            (Config(scenario_type=circle, amount=10, T_end=3.0,
                    optimizer_type=sampled), ("sat_hits",),
             "circle sampled chunk")):
        calls = plans_with_plain_versions(
            torch, coll, run_experiment, cfg, label,
            planner="plan_trajectory_sampled", forms=CXCY)
        path_shapes(torch, coll, calls, rows, names, label,
                    row_key="path_sampled")
    # ---- 15. the random and sampled matrix goldens -----------------------
    for name, cfg, exact in matrix_goldens(Config):
        launched = (("sat_hits",) if cfg.scenario_type == circle
                    else road_kernels)
        launches, res = golden_gate(run_experiment, cfg, name, coll,
                                    launched, exact_required=exact,
                                    lattice=exact)
        record(name, launches, res)
    # ---- 16. batched rollouts: one merged chunk loop for B scenarios -----
    batched_rollouts(torch, coll, Config, card, dims, record, headline,
                     headline_res, rows)
    # ---- 17. HDVs, centralized planning and voting in a batch -----------
    human_driven(torch, coll, Config, card, dims, record, rows)
    centralized(torch, coll, Config, card, dims, record, rows)
    voting_batch(torch, coll, Config, card, record)
    # ---- 18. the parallel computation modes -----------------------------
    distributed_modes(torch, coll, Config, card, by_path, rows, road_res,
                      circle_res)
    # ---- 19. the host loop, the plants and the evaluation ---------------
    host_loop_and_evaluation(torch, coll, Config, card, dims, record, road,
                             road_res, circle_res, headline, headline_res)
    # ---- 20. the geometry API, the graft entry and the tools ------------
    last_slice(torch, coll, Config, card, dims, by_path, rows)

    for name in KERNELS:
        rows[name]["launches_by_path"] = by_path[name]
    check_contract(rows.values())
    print(card, flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def live_children() -> list[int]:
    """Pids of this process's children that have not been reaped."""
    me = str(os.getpid())
    pids = []
    for entry in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the fields after the command's closing parenthesis: state, ppid
        if stat[stat.rindex(")") + 2:].split()[1] == me:
            pids.append(int(entry))
    return pids


def stop_children() -> None:
    """Stop every process the run started that is still there: any child
    killed, then the resource tracker that the spawned ranks' start left
    (it ends when no process holds its pipe any more, else only a moment
    after this process has exited); each is reaped before this returns.
    The ranks' result queues are collected first, so that the tracker
    ends with nothing registered to clean up."""
    import gc
    from multiprocessing import resource_tracker

    gc.collect()
    tracker = resource_tracker._resource_tracker
    for pid in live_children():
        if pid != tracker._pid:
            try:
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
            except (ProcessLookupError, ChildProcessError):
                pass
    tracker._stop()


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_children()
    sys.exit(code)
