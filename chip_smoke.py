#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pdmpc_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, any failure exits non-zero:
1. identify the card, build the CUDA kernels from pdmpc_torch/csrc/;
2. hold each kernel against its plain PyTorch version at the main path's
   shapes (exact mask equality) and time both with CUDA events;
3. drive the main path — run_experiment on the default 20-vehicle
   CommonRoad configuration (beam 512, 20 steps) — with the kernels'
   launch counters zeroed just before and read just after, and check the
   run is collision-free, moving and mostly fallback-free;
4. golden gate: the beam-64 run against tests/expected_results/
   commonroad_20veh.npz (same fallback pattern, total cost within 1%).

The last line of standard output is the device JSON; before it come the
card's name and power limit (as nvidia-smi prints them) and the kernels'
JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "expected_results",
                      "commonroad_20veh.npz")
SEED = 0
# main-path shapes: chunk of 2 vehicles, 6-vertex maneuver areas, beam 512
# x 12 trims, 3 obstacle families x 20 vehicles of 16 vertices, 8 predicted
# lanelets x 22 boundary segments
V, VA, C, N_OBS, VO, N_SEG = 2, 6, 512 * 12, 60, 16, 176
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# f32 operations per (candidate edge, segment) pair of the crossing test:
# qp (2), d, A, B (3 each), |d|, t_lim (2), m_lim, A*d, B*d, |A|, |B| and
# five comparisons
OPS_PER_PAIR = 25


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def rand_polys(rng, n, v, radius):
    """n polygons of v vertices (sorted angles) at map scale."""
    centers = rng.uniform([0.0, 0.0], [4.5, 4.0], size=(n, 1, 2))
    ang = np.sort(rng.uniform(0, 2 * np.pi, size=(n, v)), axis=1)
    r = rng.uniform(0.5, 1.0, size=(n, 1)) * radius
    return centers + np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1)


def kernel_inputs(torch, dev):
    """Candidates [V, VA, C], obstacles [V, NO, VO], segments [V, S, 2, 2]:
    random polygons near each other, exact touches (shared vertices and
    edges, as on the trim lattice) and padded degenerate edges."""
    rng = np.random.default_rng(SEED)
    cand = rand_polys(rng, V * C, VA, 0.15).reshape(V, C, VA, 2)
    obs = np.zeros((V, N_OBS, VO, 2))
    n_real = rng.integers(4, 7, size=(V, N_OBS))
    for v in range(V):
        for o in range(N_OBS):
            if o % 3 == 0:
                # shares every edge with a candidate (trim-lattice touch)
                poly = cand[v, rng.integers(C)]
                n_real[v, o] = VA
            else:
                poly = rand_polys(rng, 1, n_real[v, o], 0.3)[0]
            obs[v, o, :n_real[v, o]] = poly[:n_real[v, o]]
            obs[v, o, n_real[v, o]:] = poly[n_real[v, o] - 1]  # pad by repeat
    obs_mask = rng.random((V, N_OBS)) < 0.5
    segs = rng.uniform([0.0, 0.0], [4.5, 4.0], size=(V, N_SEG, 2, 2))
    # every 4th segment is a candidate edge or starts at a candidate vertex
    for v in range(V):
        for s in range(0, N_SEG, 4):
            p = cand[v, rng.integers(C)]
            segs[v, s, 0] = p[1]
            segs[v, s, 1] = p[2] if s % 8 == 0 else p[1] + rng.normal(
                0, 0.2, 2)
    seg_mask = rng.random((V, N_SEG)) < 0.8
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.asarray(a), dtype=dt, device=dev)
    cxy = t(cand).permute(0, 3, 2, 1)                 # [V, 2, VA, C]
    return (cxy[:, 0].contiguous(), cxy[:, 1].contiguous(), t(obs),
            t(obs_mask, torch.bool), t(segs), t(seg_mask, torch.bool))


def time_ms(torch, fn, reps=20, warmup=3):
    """Median time of ``fn`` in ms over ``reps`` CUDA-event-timed calls."""
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


def check_kernels(torch, coll, dev):
    """Phase 2: each kernel against its plain version, exact masks."""
    cx, cy, obs, obs_mask, segs, seg_mask = kernel_inputs(torch, dev)
    out_pre = coll.precompute_outline(obs, obs_mask)
    seg_pre = coll.precompute_segments(segs, seg_mask)
    rows = []
    for name, fn, plain, pre, n_active, in_bytes, src_line in (
        ("outline_hits", coll.outline_hits, coll.outline_hits_plain,
         out_pre, out_pre.edge_ok.sum(dim=(1, 2)),
         4 * (cx.numel() * 2 + out_pre.ox.numel() * 3),
         "pdmpc_tpu/ops/pallas_collision.py:530"),
        ("boundary_hits", coll.boundary_hits, coll.boundary_hits_plain,
         seg_pre, seg_pre.mask.sum(dim=1),
         4 * (cx.numel() * 2 + seg_pre.packed.numel() + seg_pre.mask.numel()),
         "pdmpc_tpu/ops/pallas_collision.py:374"),
    ):
        got = fn(cx, cy, pre)
        torch.cuda.synchronize()
        want = plain(cx, cy, pre)
        mismatches = int((got != want).sum())
        max_abs_err = float((got.int() - want.int()).abs().max())
        hit_share = float(want.float().mean())
        print(f"kernel {name}: {mismatches} mismatches of {want.numel()}, "
              f"hit share {hit_share:.4f}", flush=True)
        if mismatches:
            raise AssertionError(f"{name} disagrees with its plain version")
        if not 0.0 < hit_share < 1.0:
            raise AssertionError(f"{name}: degenerate test input")
        ms = time_ms(torch, lambda: fn(cx, cy, pre))
        plain_ms = time_ms(torch, lambda: plain(cx, cy, pre))
        # least work these inputs need: every pair of a candidate without
        # a hit, one pair of a candidate with one
        hits = want.sum(dim=1)
        pairs = float(((C - hits) * VA * n_active + hits).sum())
        ops_ms = pairs * OPS_PER_PAIR / PEAK_F32_OPS * 1e3
        bytes_ms = (in_bytes + want.numel()) / PEAK_BYTES * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "pdmpc_torch/csrc/collision.cu",
            "replaces": src_line,
            "launches": None, "max_abs_err": max_abs_err,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
        })
        print(f"kernel {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {max(ops_ms, bytes_ms):.4f} ms", flush=True)
    return rows


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from pdmpc_torch import Config
    from pdmpc_torch.experiment import run_experiment
    from pdmpc_torch.models.bicycle import VEHICLE_LENGTH, VEHICLE_WIDTH
    from pdmpc_torch.ops import collision as coll

    dev = torch.device("cuda")
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
    rows = check_kernels(torch, coll, dev)

    # ---- 3. main path -----------------------------------------------------
    cfg = Config(amount=20, T_end=4.0)
    coll.outline_hits.launches = 0
    coll.boundary_hits.launches = 0
    res = run_experiment(cfg, device="cuda")
    launches = {"outline_hits": coll.outline_hits.launches,
                "boundary_hits": coll.boundary_hits.launches}
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(f"main path launches: {launches}", flush=True)
    if min(launches.values()) == 0:
        raise AssertionError("a kernel of the main path was never launched")
    poses = res.infos.poses[:, :, 0]                      # [k, N, 3]
    if not np.isfinite(res.infos.poses).all():
        raise AssertionError("non-finite poses")
    collisions = vehicle_collisions(poses, VEHICLE_LENGTH, VEHICLE_WIDTH)
    if collisions:
        raise AssertionError(f"vehicle collisions: {collisions[:10]}")
    moved = np.linalg.norm(poses[-1, :, :2] - poses[0, :, :2], axis=-1)
    if not (moved > 0.3).all():
        raise AssertionError(f"stuck vehicles: moved {moved}")
    fb_share = float(res.infos.needs_fallback.mean())
    if fb_share >= 0.5:
        raise AssertionError(f"fallback share {fb_share}")
    steps = np.asarray(res.timings["step_seconds"]) * 1e3
    solves = cfg.amount * res.n_steps / res.timings["control_loop"]
    print(f"main path ({card}): beam 512, {res.n_steps} steps, "
          f"{cfg.amount} vehicles, step median {np.median(steps):.3f} ms, "
          f"p95 {np.percentile(steps, 95):.3f} ms, first step "
          f"{steps[0]:.3f} ms, {solves:.1f} vehicle-solves/s, fallback "
          f"share {fb_share:.4f}, min distance moved {moved.min():.3f} m",
          flush=True)

    # ---- 4. golden gate ---------------------------------------------------
    gold = run_experiment(Config(amount=20, T_end=4.0, beam_width=64),
                          device="cuda")
    with np.load(GOLDEN) as g:
        ref = {k: g[k] for k in g.files}
    if not (gold.infos.needs_fallback == ref["needs_fallback"]).all():
        raise AssertionError("beam-64 fallback pattern differs from golden")
    cost, cost_ref = float(gold.infos.cost.sum()), float(ref["cost"].sum())
    rel = abs(cost - cost_ref) / max(abs(cost_ref), 1e-9)
    if rel > 0.01:
        raise AssertionError(f"beam-64 total cost off by {rel:.4%}")
    exact = (np.allclose(gold.infos.poses, ref["poses"], rtol=1e-7,
                         atol=1e-4)
             and (gold.infos.trims == ref["trims"]).all()
             and (gold.infos.levels == ref["levels"]).all())
    print(f"golden gate commonroad_20veh: fallbacks match, total cost rel "
          f"diff {rel:.3e}, exact match {exact}", flush=True)

    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
