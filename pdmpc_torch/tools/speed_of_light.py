"""Speed of light of the port's collision kernels on the card: how close
each runs to the least time the card could take for its work.

    python -m pdmpc_torch.tools.speed_of_light [--step-device-ms MS]

Times the three CUDA kernels in the lattice form the beam search calls,
and the search's maneuver expansion (``collision.candidate_polys``), at
the cr20 production shapes: a planning chunk of 2 vehicles at their start
poses on the 20-vehicle CommonRoad scenario, 256 parents a vehicle
(spread about the start pose) x 12 successor trims, the transitions the
MPA allows at layer 2 live; 2 x 20 obstacles of 16 vertices (the
vehicles' occupied areas in two families, a vehicle's own masked off);
the boundary segments of the first lanelets of each vehicle's route, as
many as a step predicts. Each kernel is held to its plain version (exact
masks) on the same inputs. Then a whole-step floor: those bounds, scaled
by candidates to every layer of a step of all vehicles; given a step's
device ms (``python -m pdmpc_torch.profile_step --beam 256``'s
``device_ms_per_step``), that step's share of it.

Prints one JSON object. Exits 1 when a kernel disagrees with its plain
version or a share of the bound is above ``MAX_SHARE``: the bound is the
least time the work needs, so a kernel faster than it means a bad count.

The bounds (``roofline``, ``crossing_bound``, ``sat_bound`` and the
lattice-form ones) are the yardstick ``chip_smoke.py`` reads too: the
larger of the operations the inputs need over the card's f32 peak and
the bytes the call must move (each input read once, a byte a candidate
written) over its memory rate. Peaks are keyed by the card's name as
``torch.cuda.get_device_name`` reports it; an unknown card raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from pdmpc_torch import resolve_device


class Peak(NamedTuple):
    f32_ops: float          # operations/s in f32 outside the tensor cores
    bytes_per_s: float      # device memory rate


# published peaks (data sheets; dense rates at the card's full power
# limit): NVIDIA H100 SXM, f32 outside the tensor cores, HBM3
PEAKS = {"NVIDIA H100 80GB HBM3": Peak(67e12, 3.35e12)}

# f32 operations per (candidate edge, segment) pair of the crossing test:
# qp (2), d, A, B (3 each), |d|, t_lim (2), m_lim, A*d, B*d, |A|, |B| and
# five comparisons
OPS_PER_PAIR = 25
# f32 operations of the SAT test: a projection is a multiply, a fused
# multiply-add and a min and a max; an axis test adds two differences and
# two comparisons; a candidate's axes cost two differences, a multiply, a
# fused multiply-add, a square root, a max and two divisions each
OPS_PER_PROJECTION, OPS_PER_AXIS_TEST, OPS_PER_AXIS = 4, 4, 8
# f32 operations a candidate vertex of the maneuver expansion: x =
# fma(c, tx, -(s * ty)) + px (a multiply, a negation, an fma and an add),
# y = fma(s, tx, c * ty) + py (a multiply, an fma and an add)
OPS_PER_EXPANDED_VERTEX = 7
# a share of the bound above this means the count is wrong
MAX_SHARE = 1.05
# the production beam (parents a vehicle) and the seed of the parents'
# spread about their start poses
BEAM, SEED = 256, 0
# sleep-kernel cycles a second (H100 SXM boost clock, 1.98 GHz): enough
# to cover the host's enqueue time in ``device_ms``
SLEEP_CYCLES_PER_S = 2.0e9


def card_peak(name: str | None = None) -> Peak:
    """The published peaks of the card called ``name`` (default: the
    current CUDA device's name). Raises ``ValueError`` for a card this
    table does not know: a peak is never guessed."""
    if name is None:
        name = torch.cuda.get_device_name()
    try:
        return PEAKS[name]
    except KeyError:
        raise ValueError(f"no published peaks for the card {name!r}; add "
                         f"its data sheet's rates to PEAKS") from None


def roofline(ops, n_bytes, peak: Peak | None = None):
    """(bound ms, bound_by): the larger of ``ops`` f32 operations over the
    card's peak rate and ``n_bytes`` over its memory rate (``peak``:
    default the current card's)."""
    peak = card_peak() if peak is None else peak
    ops_ms = ops / peak.f32_ops * 1e3
    bytes_ms = n_bytes / peak.bytes_per_s * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def crossing_bound(live, feasible, n_active, va, in_bytes, peak=None):
    """(bound ms, bound_by) of a crossing mask: every (edge, active
    segment) pair of a live candidate without a hit, one pair of a live
    candidate with one; ``live``/``feasible`` [V, ...] bool, ``n_active``
    [V]; bytes: ``in_bytes`` read, one byte a candidate written."""
    v = live.shape[0]
    n_live = live.reshape(v, -1).sum(dim=1)
    free = feasible.reshape(v, -1).sum(dim=1)
    ops = float(((free * va * n_active + (n_live - free)).sum())
                * OPS_PER_PAIR)
    return roofline(ops, in_bytes + live.numel(), peak)


def distinct_vertices(x, y):
    """Vertices of polygons ``x, y`` [..., K] (vertex last) that differ
    from their predecessor, the first always: what is left of a polygon
    padded by repeated vertices, as the SAT kernel stages it. A polygon of
    k distinct vertices has k non-zero axes."""
    new = (x[..., 1:] != x[..., :-1]) | (y[..., 1:] != y[..., :-1])
    return 1 + new.sum(dim=-1)


def sat_bundle_bytes(pre):
    """Bytes of a SAT bundle the function must read: the mask and the six
    fields of every active obstacle."""
    n_active = int((pre.mask > 0).sum())
    return (pre.mask.numel() * pre.mask.element_size()
            + n_active * 6 * pre.ox.shape[-1] * pre.ox.element_size())


def sat_bound(live, feasible, cand_verts, pre, in_bytes, peak=None):
    """(bound ms, bound_by) of a SAT mask, over distinct vertices and
    non-zero axes only: every live candidate's own axes and extents; then
    one obstacle axis (the cheapest test) for every active obstacle of a
    live candidate without a hit, and every axis of the cheapest active
    obstacle for a live candidate with one; ``live``/``feasible`` [V, ...]
    bool, ``cand_verts`` [V, ...] the candidates' distinct vertices,
    ``pre`` the obstacle bundle; bytes: ``in_bytes`` read, one byte a
    candidate written."""
    v = live.shape[0]
    live, free = live.reshape(v, -1), feasible.reshape(v, -1)
    k = cand_verts.reshape(v, -1).double()                   # [V, C]
    active = pre.mask > 0                                    # [V, NO]
    o_verts = distinct_vertices(pre.ox, pre.oy).double()
    o_axes = ((pre.oax != 0) | (pre.oay != 0)).sum(dim=-1).double()
    own = k * (OPS_PER_AXIS + k * OPS_PER_PROJECTION)
    separated = (active.sum(dim=1, keepdim=True)
                 * (k * OPS_PER_PROJECTION + OPS_PER_AXIS_TEST))
    # one overlapping pair: the obstacle's axes on the candidate's
    # vertices, the candidate's axes on the obstacle's vertices
    pair = (o_axes[:, None] * (k[..., None] * OPS_PER_PROJECTION
                               + OPS_PER_AXIS_TEST)
            + k[..., None] * (o_verts[:, None] * OPS_PER_PROJECTION
                              + OPS_PER_AXIS_TEST))          # [V, C, NO]
    overlap = pair.masked_fill(~active[:, None], float("inf")).amin(dim=-1)
    per_cand = own + separated.where(free, overlap)
    ops = float(per_cand.where(live, 0.0).sum())
    return roofline(ops, in_bytes + live.numel(), peak)


def lattice_bytes(lat):
    """Bytes of the lattice a call reads: table, trims, poses, c and s."""
    v, b = lat.trim.shape
    return lat.table.numel() * 4 + v * b * (8 + 3 * 4 + 2 * 4)


def crossing_path_bound(lat, live, feasible, pre, n_active, peak=None):
    """The bound of a crossing kernel's lattice-form call, ``n_active``
    [V] its active segments a vehicle; bytes: the lattice, the live mask
    and the bundle read."""
    in_bytes = (lattice_bytes(lat) + live.numel()
                + sum(t.numel() * t.element_size() for t in pre))
    return crossing_bound(live, feasible, n_active, lat.table.shape[2],
                          in_bytes, peak)


def sat_path_bound(lat, live, feasible, pre, n_active=None, peak=None):
    """The bound of a SAT lattice-form call (the active obstacles come
    from ``pre``); the candidates' distinct vertices are their table
    areas'; bytes: the lattice, the live mask and the bundle read."""
    table = lat.table
    cand_verts = distinct_vertices(table[..., 0], table[..., 1])[lat.trim]
    in_bytes = lattice_bytes(lat) + live.numel() + sat_bundle_bytes(pre)
    return sat_bound(live, feasible, cand_verts, pre, in_bytes, peak)


def expansion_bound(lat, peak=None):
    """(bound ms, bound_by) of ``collision.candidate_polys`` on the
    lattice: every candidate vertex transformed; bytes: the lattice read
    (table, trims, poses, c and s), cx and cy written."""
    v, b = lat.trim.shape
    vertices = v * b * lat.table.shape[1] * lat.table.shape[2]
    return roofline(vertices * OPS_PER_EXPANDED_VERTEX,
                    lattice_bytes(lat) + vertices * 2 * 4, peak)


def device_ms(fn, reps=30, warmup=3):
    """Device time of one call of ``fn`` in ms: ``reps`` calls queued
    behind a sleep kernel long enough to hide the host's time to enqueue
    them, so the events see the device's work back to back."""
    host = 0.0
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host = max(host, time.perf_counter() - t0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2.0 * reps * host + 2e-3) * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class Inputs(NamedTuple):
    cfg: object             # the cr20 configuration (beam BEAM)
    n_vehicles: int
    road: object            # Lattice on the non-convex areas
    boundary: object        # Lattice on the areas without offset
    convex: object          # Lattice on the convex areas
    live: torch.Tensor      # [V, B, n] bool
    outline_pre: object
    segments_pre: object
    obstacles_pre: object


def build_inputs(device) -> Inputs:
    """The kernels' inputs at the cr20 production shapes (module
    docstring) on ``device``, from the port's own scenario and MPA."""
    from pdmpc_torch import Config
    from pdmpc_torch.controller import (
        _n_predicted_lanelets,
        _occupied_area,
        _unique_padded,
        initial_state,
    )
    from pdmpc_torch.experiment import create_scenario
    from pdmpc_torch.models.mpa import build_mpa
    from pdmpc_torch.ops import collision as coll
    from pdmpc_torch.ops.search import pad_polys_to_vo

    cfg = Config(amount=20, T_end=4.0, beam_width=BEAM).validate()
    mpa = build_mpa(cfg)
    scenario = create_scenario(cfg, mpa)
    mpa_t = mpa.to_tensors_for(cfg, device)
    convex_t = mpa.to_tensors_for(
        replace(cfg, obstacle_geometry="convex").validate(), device)
    sc_t = scenario.to_tensors(device)
    n, hp = cfg.amount, mpa_t.Hp
    chunk = min(n, cfg.level_chunk or 2)
    state = initial_state(sc_t, hp)

    # parents: BEAM a vehicle, spread 1 m and 0.3 rad about its start
    rng = np.random.default_rng(SEED)
    spread = rng.uniform([-1.0, -1.0, -0.3], [1.0, 1.0, 0.3],
                         size=(chunk, BEAM, 3))
    pose = state.pose[:chunk, None, :] + torch.as_tensor(
        spread, dtype=torch.float32, device=device)
    trim = torch.as_tensor(rng.integers(0, mpa_t.n_trims, (chunk, BEAM)),
                           device=device)
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    live = mpa_t.transition[2][trim]                         # [V, B, n]

    # obstacles: every vehicle's occupied area in two families, padded to
    # 16 vertices; a vehicle's own masked off
    occ = pad_polys_to_vo(_occupied_area(state.pose, cfg.offset))
    obs = torch.cat([occ, occ])[None].expand(chunk, -1, -1, -1)
    own = torch.arange(chunk, device=device)[:, None]
    idx = torch.arange(2 * n, device=device)[None]
    obs_mask = (idx != own) & (idx != own + n)

    # boundary: the first lanelets of each vehicle's route (1-based ids,
    # row 0 of the road tensors is no lanelet), as many as a step predicts
    n_pred = _n_predicted_lanelets(hp)
    ids = torch.as_tensor(np.stack([
        np.asarray(scenario.lanelet_indices[v][:n_pred])
        for v in range(chunk)]), device=device)
    lanes = _unique_padded(ids, n_pred)
    road = sc_t.road
    segs = road.boundary_segments[lanes].reshape(chunk, -1, 2, 2)
    seg_mask = road.boundary_seg_mask[lanes].reshape(chunk, -1)

    return Inputs(
        cfg=cfg, n_vehicles=n,
        road=coll.Lattice(mpa_t.area, trim, pose, c, s),
        boundary=coll.Lattice(mpa_t.area_no_offset, trim, pose, c, s),
        convex=coll.Lattice(convex_t.area, trim, pose, c, s),
        live=live,
        outline_pre=coll.precompute_outline(obs, obs_mask),
        segments_pre=coll.precompute_segments(segs, seg_mask),
        obstacles_pre=coll.precompute_obstacles(obs, obs_mask))


def layer_candidates(beam: int, n_trims: int, hp: int) -> list[int]:
    """Candidates a vehicle at each of a plan's ``hp`` layers: (parents)
    x ``n_trims``, the parents growing by ``n_trims`` a layer up to
    ``beam``."""
    out, parents = [], 1
    for _ in range(hp):
        out.append(parents * n_trims)
        parents = min(beam, parents * n_trims)
    return out


def measure(device=None, step_device_ms: float | None = None) -> dict:
    """Time the kernels and the expansion at the production shapes (on
    CUDA only: ``device`` default CUDA, and raises without it), hold each
    kernel to its plain version, and return the record (module
    docstring)."""
    from pdmpc_torch.ops import collision as coll

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"speed of light times the card; {device} has "
                           f"no device clock to read")
    name = torch.cuda.get_device_name(device)
    peak = card_peak(name)
    inp = build_inputs(device)
    live = inp.live
    v = live.shape[0]
    calls = {
        "outline_hits": (coll.outline_hits_lattice, inp.road,
                         inp.outline_pre,
                         inp.outline_pre.edge_ok.sum(dim=(1, 2)),
                         crossing_path_bound,
                         "pdmpc_tpu/ops/pallas_collision.py:530"),
        "boundary_hits": (coll.boundary_hits_lattice, inp.boundary,
                          inp.segments_pre, inp.segments_pre.mask.sum(dim=1),
                          crossing_path_bound,
                          "pdmpc_tpu/ops/pallas_collision.py:374"),
        "sat_hits": (coll.sat_hits_lattice, inp.convex, inp.obstacles_pre,
                     inp.obstacles_pre.mask.sum(dim=1), sat_path_bound,
                     "pdmpc_tpu/ops/pallas_collision.py:234"),
    }
    kernels = {}
    for kernel, (fn, lat, pre, n_active, bound_of, replaces) in \
            calls.items():
        plain = getattr(coll, fn.__name__ + "_plain")
        got, want = fn(lat, live, pre), plain(lat, live, pre)
        bound, bound_by = bound_of(lat, live, want, pre, n_active, peak=peak)
        ms = device_ms(lambda: fn(lat, live, pre))
        kernels[kernel] = {
            "replaces": replaces, "candidates": live.numel(),
            "live": int(live.sum()), "feasible": int(want.sum()),
            "active": n_active.tolist(),
            "mismatches": int((got != want).sum()),
            "ms": ms, "bound_ms": bound, "bound_by": bound_by,
            "share": bound / ms}
    lat = inp.road
    bound, bound_by = expansion_bound(lat, peak)
    ms = device_ms(lambda: coll.candidate_polys(*lat))
    kernels["candidate_polys"] = {
        "candidates": live.numel(), "ms": ms, "bound_ms": bound,
        "bound_by": bound_by, "share": bound / ms}

    # the step floor: every vehicle planned once, each layer's candidates
    # costing the production layer's bound a candidate, for the road
    # path's three calls (outline, boundary, expansion)
    n_trims, hp = inp.road.table.shape[0], inp.cfg.Hp
    layers = layer_candidates(BEAM, n_trims, hp)
    per_candidate = sum(kernels[k]["bound_ms"] for k in (
        "outline_hits", "boundary_hits", "candidate_polys")) / live.numel()
    floor = per_candidate * inp.n_vehicles * sum(layers)
    step = {"vehicles": inp.n_vehicles, "layer_candidates": layers,
            "floor_ms": floor}
    if step_device_ms is not None:
        step["device_ms"] = step_device_ms
        step["share"] = floor / step_device_ms
    shares = {k: r["share"] for k, r in kernels.items()}
    if "share" in step:
        shares["whole_step"] = step["share"]
    return {
        "device": name, "count": torch.cuda.device_count(),
        "peaks": peak._asdict(),
        "shapes": {"chunk": v, "beam": BEAM, "n_trims": n_trims, "Hp": hp,
                   "obstacles": inp.outline_pre.mask.shape[-1],
                   "obstacle_vertices": int(inp.outline_pre.ox.shape[-1]),
                   "segments": int(inp.segments_pre.mask.shape[-1])},
        "kernels": kernels, "whole_step": step,
        "ok": (max(shares.values()) <= MAX_SHARE
               and not any(r.get("mismatches") for r in kernels.values())),
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="pdmpc_torch.tools.speed_of_light")
    parser.add_argument("--step-device-ms", type=float, default=None,
                        help="a road step's device ms at beam 256 "
                             "(profile_step --beam 256's "
                             "device_ms_per_step)")
    args = parser.parse_args(argv)
    out = measure(step_device_ms=args.step_device_ms)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
