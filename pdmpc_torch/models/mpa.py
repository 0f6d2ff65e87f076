"""Motion-primitive automaton (MPA): the offline model layer.

TPU-native re-design of
hlc/model/motion_primitive_automaton/MotionPrimitiveAutomaton.m (819 LoC),
choose_trims.m, build_mpa.m, generate_trim.m, generate_maneuver.m.

Everything is precomputed offline in numpy into dense fixed-shape tensors
(the reference equivalently treats the MPA as an immutable disk-cached
artifact, MotionPrimitiveAutomaton.m:67-79) and frozen into device constants
(:class:`MpaTensors`) for the jitted planner:

- trims: (steering, speed) pairs, 3 trim-set families (single_speed 12+1,
  triple_speed 33+1, realistic accel-limited grid);
- maneuvers: dense ``[n, n]`` tensors of endpoint displacement (dx, dy,
  dyaw), center trajectories, and swept-area polygons in three offset
  variants x {convex (SAT path), non-convex (segment-test path)};
- time-varying transition matrices ``[Hp, n, n]`` enforcing recursive
  feasibility (equilibrium reachable in the remaining steps,
  MotionPrimitiveAutomaton.m:238-250);
- offline local reachable sets per (trim, step), convex conservative
  K-vertex outer approximations of the exact swept unions
  (MotionPrimitiveAutomaton.m:252-385; over-approximation is the safe
  direction for the parallel-planning avoidance they are used for).

Polygons follow the framework convention: fixed vertex count, padded by
repeating the last vertex.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from pdmpc_torch.config import Config, MpaType
from pdmpc_torch.models.bicycle import (
    LF,
    LR,
    VEHICLE_LENGTH,
    VEHICLE_WIDTH,
    integrate_rk4,
)

# Fixed vertex counts.
VM_CONVEX = 5       # convex maneuver area (straight: 4, turn: 5)
VM_NONCONVEX = 6    # non-convex maneuver area (straight: 4, turn: 6)
K_REACHABLE = 16    # outer-approximation vertex count of local reachable sets

# Reference: MotionPrimitiveAutomaton.m:38-39
MAX_ACCELERATION_M_S2 = 0.64
MAX_DECELERATION_M_S2 = 0.64

_LIBRARY_DIR = os.path.join(os.path.dirname(__file__), "library")


def choose_trims(mpa_type: MpaType, max_acceleration_per_dt: float,
                 max_deceleration_per_dt: float | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Trim inputs [n, 2] (steering, speed) + adjacency [n, n].

    Reference: choose_trims.m:11-135.
    """
    if max_deceleration_per_dt is None:
        max_deceleration_per_dt = max_acceleration_per_dt

    if mpa_type == MpaType.single_speed:
        # 12 trims: equilibrium + 11-point steering fan (choose_trims.m:13-35)
        n_half = 5
        steering = np.linspace(-0.6, 0.6, 2 * n_half + 1)
        v_profile = np.arange(0.0, 0.8 + 1e-9, 0.1)
        speed_left = v_profile[-n_half:]
        speed = np.concatenate([speed_left, [0.8], speed_left[::-1]])
        n_trims = steering.size + 1
        trim_inputs = np.concatenate(
            [np.zeros((1, 2)), np.stack([steering, speed], axis=1)]
        )
        adj = np.ones((n_trims, n_trims))
        band = np.ones((n_trims - 1, n_trims - 1))
        band -= np.triu(np.ones((n_trims - 1, n_trims - 1)), 2)
        band -= np.tril(np.ones((n_trims - 1, n_trims - 1)), -2)
        adj[1:, 1:] = band
        return trim_inputs, adj.astype(bool)

    if mpa_type == MpaType.triple_speed:
        # 34 trims: 3 speed rows x 11 steering + equilibrium
        # (choose_trims.m:37-83)
        n_sixth = 5
        steering = np.linspace(-0.6, 0.6, 2 * n_sixth + 1)
        n_third = steering.size

        def row(v):
            left = np.full(n_sixth, v)
            return np.concatenate([left, [v], left[::-1]])

        speed = np.concatenate([row(0.5), row(0.7), row(0.9)])
        n_trims = 3 * n_third + 1
        trim_inputs = np.concatenate(
            [
                np.zeros((1, 2)),
                np.stack([np.tile(steering, 3), speed], axis=1),
            ]
        )
        adj = np.ones((n_trims, n_trims))
        band = np.ones((n_trims - 1, n_trims - 1))
        band -= np.triu(np.ones((n_trims - 1, n_trims - 1)), 2)
        band -= np.tril(np.ones((n_trims - 1, n_trims - 1)), -2)
        adj[1:, 1:] = band
        # equilibrium only connects to the first (lowest-speed) third
        adj[0, n_third + 1:] = 0
        adj[n_third + 1:, 0] = 0
        # break the band link between speed rows
        for b in (n_third, 2 * n_third):
            adj[b, b + 1] = 0
            adj[b + 1, b] = 0
        # same-steering cross-speed links
        for i in range(1, 2 * n_third + 1):
            adj[i, i + n_third] = 1
            adj[i + n_third, i] = 1
        return trim_inputs, adj.astype(bool)

    if mpa_type == MpaType.realistic:
        # acceleration-limited speed grid with speed-dependent steering
        # (choose_trims.m:85-131)
        d_speed = min(max_acceleration_per_dt, max_deceleration_per_dt)
        acc_max = 1.05 * max_acceleration_per_dt
        dec_max = 1.05 * max_deceleration_per_dt
        speed_max = d_speed * round(0.8 / d_speed)
        speed_vec = np.arange(0.0, speed_max + 1e-9, d_speed)
        n_speeds = speed_vec.size

        d_steer = 0.5 * np.pi / 18
        steer_max_lo = d_steer * round((3 * np.pi / 18) / d_steer)
        steer_max_hi = d_steer * round((2 * np.pi / 18) / d_steer)
        d_steer_max = 1.05 * d_steer

        steer_cla: list[np.ndarray] = []
        steer_cla.append(np.arange(-steer_max_lo, steer_max_lo + 1e-9, d_steer))
        x_interp = np.array([speed_vec[0] + d_speed, speed_vec[2]])
        v_interp = np.array([steer_max_lo, steer_max_hi])
        for i_speed in (1, 2):
            max_steer = np.interp(speed_vec[i_speed], x_interp, v_interp)
            max_steer = d_steer * round(max_steer / d_steer)
            steer_cla.append(np.arange(-max_steer, max_steer + 1e-9, d_steer))
        for _ in range(3, n_speeds):
            steer_cla.append(
                np.arange(-steer_max_hi, steer_max_hi + 1e-9, d_steer)
            )

        # build_mpa.m: states = all (steer, speed) pairs; transitions limited
        # by accel/decel and steering-rate
        trims = []
        for i_speed, steers in enumerate(steer_cla):
            for s in steers:
                trims.append((s, speed_vec[i_speed]))
        trim_inputs = np.array(trims)
        n_trims = trim_inputs.shape[0]
        dsteer = np.abs(trim_inputs[:, 0][None, :] - trim_inputs[:, 0][:, None])
        dv = trim_inputs[:, 1][None, :] - trim_inputs[:, 1][:, None]
        adj = (dsteer <= d_steer_max) & (
            np.where(dv > 0, dv <= acc_max, -dv <= dec_max)
        )
        return trim_inputs, adj

    raise ValueError(f"unknown mpa trim type: {mpa_type}")


def _maneuver_area(x_rec1, y_rec1, x_rec2, y_rec2, signum, non_convex):
    """Swept-area polygon between start and end rectangles.

    Reference: generate_maneuver.m:68-105. Returns an open polygon
    [V, 2] padded by repeating the last vertex (V = VM_NONCONVEX if
    ``non_convex`` else VM_CONVEX). Rectangle corner order (1..4):
    LL, UL, UR, LR.
    """

    def pts(ix, which):
        xs = x_rec1 if which == 1 else x_rec2
        ys = y_rec1 if which == 1 else y_rec2
        return [(xs[i - 1], ys[i - 1]) for i in ix]

    if signum == 0:  # straight
        poly = pts([1, 2], 1) + pts([3, 4], 2)
    elif signum > 0:  # left turn
        if non_convex:
            poly = pts([1, 2], 1) + pts([2, 3, 4], 2) + pts([4], 1)
        else:
            last = (x_rec2[3], y_rec1[3])
            poly = pts([1, 2], 1) + pts([3, 4], 2) + [last]
    else:  # right turn
        if non_convex:
            poly = pts([1, 2, 3], 1) + pts([3, 4, 1], 2)
        else:
            last = (x_rec2[2], y_rec1[2])
            poly = pts([1, 2], 1) + [last] + pts([3, 4], 2)

    v = VM_NONCONVEX if non_convex else VM_CONVEX
    arr = np.array(poly)
    if arr.shape[0] < v:
        arr = np.concatenate(
            [arr, np.tile(arr[-1:], (v - arr.shape[0], 1))]
        )
    return arr


def _rot_translate(dyaw, dx, dy, xs, ys):
    c, s = np.cos(dyaw), np.sin(dyaw)
    return c * xs - s * ys + dx, s * xs + c * ys + dy


def _rect_corners(half_len, half_wid):
    """Corners LL, UL, UR, LR (generate_maneuver.m:40-41)."""
    return (
        np.array([-1.0, -1.0, 1.0, 1.0]) * half_len,
        np.array([-1.0, 1.0, 1.0, -1.0]) * half_wid,
    )


@dataclass
class Mpa:
    """Dense offline MPA tensors (numpy, float64 while building)."""

    mpa_type: MpaType
    Hp: int
    dt_seconds: float
    offset: float
    recursive_feasibility: bool

    trim_steering: np.ndarray       # [n]
    trim_speed: np.ndarray          # [n]
    adjacency: np.ndarray           # [n, n] bool
    transition: np.ndarray          # [Hp, n, n] bool (time-varying)
    distance_to_equilibrium: np.ndarray  # [n] int

    dx: np.ndarray                  # [n, n]
    dy: np.ndarray                  # [n, n]
    dyaw: np.ndarray                # [n, n]
    man_trajectory: np.ndarray      # [n, n, tick_per_step+1, 3] (x, y, yaw)

    # Swept areas, convex family (SAT collision path)
    area_conv: np.ndarray               # [n, n, VM_CONVEX, 2] with offset
    area_conv_no_offset: np.ndarray     # [n, n, VM_CONVEX, 2]
    area_conv_large_offset: np.ndarray  # [n, n, VM_CONVEX, 2]
    # Swept areas, non-convex family (segment-intersection path)
    area_nc: np.ndarray                 # [n, n, VM_NONCONVEX, 2]
    area_nc_no_offset: np.ndarray       # [n, n, VM_NONCONVEX, 2]
    area_nc_large_offset: np.ndarray    # [n, n, VM_NONCONVEX, 2]

    local_reachable_sets_conv: np.ndarray  # [n, Hp, K_REACHABLE, 2]
    # non-recursive-feasibility variant: used for HDV (human-driven vehicle)
    # reachability, whose MPA does not require stopping within the horizon
    # (scenarios/ManualVehicle.m:30-49 builds a non-recursive single-speed
    # MPA for this purpose)
    local_reachable_sets_nonrecursive: np.ndarray = None  # [n, Hp, K, 2]

    @property
    def n_trims(self) -> int:
        return self.trim_speed.shape[0]

    @property
    def trims_stop(self) -> np.ndarray:
        """Trims with zero speed. Reference: MotionPrimitiveAutomaton.m:117."""
        return self.trim_speed == 0.0

    def get_max_speed(self) -> float:
        """Reference: MotionPrimitiveAutomaton.m:182-185."""
        return float(np.max(self.trim_speed))

    def get_straight_speeds(self) -> np.ndarray:
        """Reference: MotionPrimitiveAutomaton.m:187-191.

        Tolerance instead of an exact zero test: the realistic family's
        steering grid comes from ``np.arange(-max, max, d)`` whose center
        value carries fp noise (~1e-16), which an exact ``== 0`` misses.
        """
        mask = (self.trim_speed > 0) & (np.abs(self.trim_steering) < 1e-9)
        return self.trim_speed[mask]

    def maximum_branching_factor(self) -> int:
        return int(self.transition.sum(axis=2).max())

    def trim_from_values(self, speed: float, steering: float) -> int:
        """Closest trim by normalized 2D distance.

        Reference: MotionPrimitiveAutomaton.m:193-236 (zero steering maps
        only onto zero-steering trims).
        """
        ts, tst = self.trim_speed, self.trim_steering
        if steering == 0:
            idx = np.nonzero(np.abs(tst) < 1e-9)[0]
            return int(idx[np.argmin(np.abs(ts[idx] - speed))])
        s_c, s_s = ts.min(), ts.max() - ts.min()
        st_c, st_s = tst.min(), tst.max() - tst.min()
        d = np.hypot(
            (ts - speed) / s_s,
            (tst - steering) / st_s,
        )
        del s_c, st_c
        return int(np.argmin(d))

    def to_tensors_for(self, options: "Config",
                       device: torch.device | str = "cuda") -> "MpaTensors":
        """Tensors with the options-dispatched area family.

        The reference dispatches road scenarios to the non-convex maneuver
        family + segment-intersection checking and everything else to the
        convex family + SAT (OptimizerInterface.m:36-46, Config.m:71-87).
        """
        return self.to_tensors(convex=not options.use_non_convex_obstacles,
                               device=device)

    def to_tensors(self, convex: bool = True,
                   device: torch.device | str = "cuda") -> "MpaTensors":
        def f32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32),
                                   device=device)

        def flag(a):
            return torch.as_tensor(np.asarray(a, dtype=bool), device=device)

        if convex:
            area, area_no, area_large = (
                self.area_conv, self.area_conv_no_offset,
                self.area_conv_large_offset,
            )
        else:
            area, area_no, area_large = (
                self.area_nc, self.area_nc_no_offset,
                self.area_nc_large_offset,
            )
        return MpaTensors(
            transition=flag(self.transition),
            dx=f32(self.dx),
            dy=f32(self.dy),
            dyaw=f32(self.dyaw),
            area=f32(area),
            area_no_offset=f32(area_no),
            area_large_offset=f32(area_large),
            local_reachable_sets=f32(self.local_reachable_sets_conv),
            local_reachable_sets_hdv=f32(
                self.local_reachable_sets_nonrecursive
                if self.local_reachable_sets_nonrecursive is not None
                else self.local_reachable_sets_conv
            ),
            trim_speed=f32(self.trim_speed),
            trim_steering=f32(self.trim_steering),
            trims_stop=flag(self.trims_stop),
        )


class MpaTensors(NamedTuple):
    """Frozen device-side MPA constants (torch tensors on one device)."""

    transition: torch.Tensor            # [Hp, n, n] bool
    dx: torch.Tensor                    # [n, n] f32
    dy: torch.Tensor                    # [n, n] f32
    dyaw: torch.Tensor                  # [n, n] f32
    area: torch.Tensor                  # [n, n, V, 2] f32 (with offset)
    area_no_offset: torch.Tensor        # [n, n, V, 2] f32
    area_large_offset: torch.Tensor     # [n, n, V, 2] f32
    local_reachable_sets: torch.Tensor  # [n, Hp, K, 2] f32
    local_reachable_sets_hdv: torch.Tensor  # [n, Hp, K, 2] f32
    trim_speed: torch.Tensor            # [n] f32
    trim_steering: torch.Tensor         # [n] f32
    trims_stop: torch.Tensor            # [n] bool

    @property
    def n_trims(self) -> int:
        return self.trim_speed.shape[0]

    @property
    def Hp(self) -> int:
        return self.transition.shape[0]


def _bfs_distance_to_equilibrium(adjacency: np.ndarray,
                                 speeds: np.ndarray) -> np.ndarray:
    """Graph distance from each trim to the nearest zero-speed trim.

    Reference: MotionPrimitiveAutomaton.m:133-136 (undirected for the
    reference's symmetric adjacencies; computed on the directed graph here,
    which is the semantically correct direction for recursive feasibility).
    """
    n = adjacency.shape[0]
    dist = np.full(n, np.iinfo(np.int32).max, dtype=np.int64)
    frontier = speeds == 0.0
    dist[frontier] = 0
    d = 0
    while frontier.any():
        d += 1
        # predecessors of the frontier (can reach frontier in one hop)
        reach = adjacency @ frontier.astype(np.int64) > 0
        new = reach & (dist > d)
        dist[new] = d
        frontier = new
    return dist


def _outer_poly_approx_np(points: np.ndarray, k: int) -> np.ndarray:
    """Numpy twin of ops.geometry.outer_poly_approx (offline use)."""
    theta = 2.0 * np.pi * np.arange(k) / k
    dirs = np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    h = (points @ dirs.T).max(axis=0)
    d1, d2 = dirs, np.roll(dirs, -1, axis=0)
    h1, h2 = h, np.roll(h, -1)
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    x = (h1 * d2[:, 1] - h2 * d1[:, 1]) / det
    y = (d1[:, 0] * h2 - d2[:, 0] * h1) / det
    return np.stack([x, y], axis=-1)


def _enumerate_reachability(mpa: Mpa, area_family: np.ndarray,
                            transition: np.ndarray,
                            max_frontier: int = 2_000_000,
                            record_frontiers: bool = False):
    """Exact level-by-level reachability enumeration.

    Enumerate all feasible trim paths through ``transition`` [T, n, n]
    (with exact-duplicate pose pruning), collect the transformed
    maneuver-area vertices, and outer-approximate to K-vertex hulls.

    Returns (out [n, T, K, 2], frontiers) where ``frontiers[t][root]`` is
    the (trims, x, y, yaw) tuple of poses reachable after step t+1 —
    recorded only when ``record_frontiers`` (used by the DP composition).
    """
    n = mpa.n_trims
    t_max = transition.shape[0]
    out = np.zeros((n, t_max, K_REACHABLE, 2))
    frontiers: list[dict] = [dict() for _ in range(t_max)]

    for root in range(n):
        trims = np.array([root])
        xs = np.zeros(1)
        ys = np.zeros(1)
        yaws = np.zeros(1)
        for t in range(t_max):
            mask = transition[t][trims]              # [F, n]
            idx_f, idx_j = np.nonzero(mask)
            if idx_f.size == 0:
                # No feasible continuation (cannot happen with the reference
                # trim sets); keep a degenerate point set.
                out[root, t:] = out[root, t - 1] if t else 0.0
                break
            pi, pj = trims[idx_f], idx_j
            px, py, pyaw = xs[idx_f], ys[idx_f], yaws[idx_f]
            c, s = np.cos(pyaw), np.sin(pyaw)

            # swept areas of the expanded maneuvers, in root frame
            areas = area_family[pi, pj]              # [E, VM, 2]
            ax = (
                c[:, None] * areas[:, :, 0]
                - s[:, None] * areas[:, :, 1] + px[:, None]
            )
            ay = (
                s[:, None] * areas[:, :, 0]
                + c[:, None] * areas[:, :, 1] + py[:, None]
            )
            verts = np.stack([ax, ay], axis=-1).reshape(-1, 2)
            out[root, t] = _outer_poly_approx_np(verts, K_REACHABLE)

            # child poses
            mdx, mdy, mdyaw = mpa.dx[pi, pj], mpa.dy[pi, pj], mpa.dyaw[pi, pj]
            nx = c * mdx - s * mdy + px
            ny = s * mdx + c * mdy + py
            nyaw = pyaw + mdyaw

            # exact-duplicate pruning keeps the enumeration bounded without
            # losing any reachable pose
            key = np.stack(
                [pj, np.round(nx, 9), np.round(ny, 9), np.round(nyaw, 9)],
                axis=1,
            )
            _, uniq = np.unique(key, axis=0, return_index=True)
            if uniq.size > max_frontier:
                import warnings

                warnings.warn(
                    f"reachability frontier truncated at root trim {root} "
                    f"step {t}: {uniq.size} > max_frontier={max_frontier} "
                    "— reachable sets may under-approximate; increase "
                    "max_frontier or use the DP path (Hp >= "
                    f"{_DP_HORIZON_THRESHOLD})",
                    stacklevel=2,
                )
                uniq = uniq[:max_frontier]
            trims, xs, ys, yaws = pj[uniq], nx[uniq], ny[uniq], nyaw[uniq]
            if record_frontiers:
                frontiers[t][root] = (trims, xs, ys, yaws)
    return out, frontiers


# Horizons above this use the divide-&-conquer composition; below it the
# exact brute-force enumeration is affordable and preferred (exact).
_DP_HORIZON_THRESHOLD = 7


def _reachability_analysis_offline(mpa: Mpa, area_family: np.ndarray,
                                   max_frontier: int = 2_000_000
                                   ) -> np.ndarray:
    """Local reachable sets per (root trim, step): conservative convex
    K-vertex outer approximations of the union of all reachable swept areas.

    Short horizons (Hp < 7): exact enumeration (vectorized re-design of
    the reference's brute-force polyshape unions,
    MotionPrimitiveAutomaton.m:252-385).

    Long horizons: divide-&-conquer dynamic programming
    (reachability_analysis_offline_DP, MotionPrimitiveAutomaton.m:394-647):
    enumerate frontier poses exactly to Hp_half, then compose each
    frontier pose with the rigidly-transformed half-horizon reachable set
    of its trim — exponent halves from E^Hp to E^(Hp/2). Like the
    reference, intermediate composed steps use the (less restrictive)
    first-half transitions — a conservative over-approximation under
    recursive feasibility — while the FINAL step composes the
    equilibrium-constrained tail variant (built from the last Hp_half
    transition matrices, the analogue of reachable_sets_local_HpHalf).
    """
    hp = mpa.Hp
    if hp < _DP_HORIZON_THRESHOLD:
        out, _ = _enumerate_reachability(
            mpa, area_family, mpa.transition, max_frontier
        )
        return out

    n = mpa.n_trims
    hp_half = -(-hp // 2)
    out = np.zeros((n, hp, K_REACHABLE, 2))

    # first half: exact, with per-depth frontiers recorded
    first, frontiers = _enumerate_reachability(
        mpa, area_family, mpa.transition[:hp_half], max_frontier,
        record_frontiers=True,
    )
    out[:, :hp_half] = first

    # tail sets: unconstrained variant for intermediate composed steps
    # (== the first-half transitions, reference DP :607-612) and the
    # equilibrium-constrained variant for the final step (:633-645)
    tail_free = first
    tail_eq, _ = _enumerate_reachability(
        mpa, area_family, mpa.transition[hp - hp_half:], max_frontier
    )

    for root in range(n):
        for t in range(hp_half, hp):
            d = t + 1 - hp_half                      # frontier depth (steps)
            trims, xs, ys, yaws = frontiers[d - 1][root]
            tail = tail_eq if t == hp - 1 else tail_free
            hulls = tail[trims, hp_half - 1]         # [F, K, 2]
            c, s = np.cos(yaws), np.sin(yaws)
            hx = (
                c[:, None] * hulls[:, :, 0]
                - s[:, None] * hulls[:, :, 1] + xs[:, None]
            )
            hy = (
                s[:, None] * hulls[:, :, 0]
                + c[:, None] * hulls[:, :, 1] + ys[:, None]
            )
            verts = np.stack([hx, hy], axis=-1).reshape(-1, 2)
            out[root, t] = _outer_poly_approx_np(verts, K_REACHABLE)
    return out


def build_mpa(options: Config) -> Mpa:
    """Build (or load from cache) the MPA for the given options.

    Reference: MotionPrimitiveAutomaton.m constructor (:25-180).
    """
    cache_path = os.path.join(_LIBRARY_DIR, mpa_cache_name(options))
    if os.path.isfile(cache_path):
        return _load_mpa(cache_path, options)

    max_acc_per_dt = MAX_ACCELERATION_M_S2 * options.dt_seconds
    max_dec_per_dt = MAX_DECELERATION_M_S2 * options.dt_seconds
    trim_inputs, adjacency = choose_trims(
        options.mpa_type, max_acc_per_dt, max_dec_per_dt
    )
    n = trim_inputs.shape[0]
    hp = options.Hp
    dt = options.dt_seconds
    ticks = options.tick_per_step

    steering = trim_inputs[:, 0]
    speed = trim_inputs[:, 1]

    # -- maneuvers (generate_maneuver.m) --------------------------------
    dx = np.zeros((n, n))
    dy = np.zeros((n, n))
    dyaw = np.zeros((n, n))
    man_traj = np.zeros((n, n, ticks + 1, 3))
    area_conv = np.zeros((n, n, VM_CONVEX, 2))
    area_conv_no = np.zeros((n, n, VM_CONVEX, 2))
    area_conv_large = np.zeros((n, n, VM_CONVEX, 2))
    area_nc = np.zeros((n, n, VM_NONCONVEX, 2))
    area_nc_no = np.zeros((n, n, VM_NONCONVEX, 2))
    area_nc_large = np.zeros((n, n, VM_NONCONVEX, 2))

    rects = {
        "offset": _rect_corners(
            VEHICLE_LENGTH / 2 + options.offset,
            VEHICLE_WIDTH / 2 + options.offset,
        ),
        "no_offset": _rect_corners(VEHICLE_LENGTH / 2, VEHICLE_WIDTH / 2),
        # larger length offset for the last prediction step
        # (generate_maneuver.m:57-59)
        "large_offset": _rect_corners(
            VEHICLE_LENGTH / 2 + 0.05, VEHICLE_WIDTH / 2
        ),
    }

    for i in range(n):
        for j in range(n):
            if not adjacency[i, j]:
                continue
            u = np.array(
                [
                    (steering[j] - steering[i]) / dt,
                    (speed[j] - speed[i]) / dt,
                ]
            )
            x0 = np.array([0.0, 0.0, 0.0, speed[i], steering[i]])
            states = integrate_rk4(x0, u, dt, ticks + 1)
            man_traj[i, j] = states[:, :3]
            dx[i, j], dy[i, j], dyaw[i, j] = states[-1, :3]
            signum = np.sign(dyaw[i, j])

            for name, (xr, yr), targets in (
                ("offset", rects["offset"], (area_conv, area_nc)),
                ("no_offset", rects["no_offset"], (area_conv_no, area_nc_no)),
                ("large_offset", rects["large_offset"],
                 (area_conv_large, area_nc_large)),
            ):
                del name
                x2, y2 = _rot_translate(dyaw[i, j], dx[i, j], dy[i, j], xr, yr)
                targets[0][i, j] = _maneuver_area(
                    xr, yr, x2, y2, signum, non_convex=False
                )
                targets[1][i, j] = _maneuver_area(
                    xr, yr, x2, y2, signum, non_convex=True
                )

    # -- recursive feasibility (MotionPrimitiveAutomaton.m:238-250) -----
    dist_eq = _bfs_distance_to_equilibrium(adjacency, speed)
    transition = np.broadcast_to(adjacency, (hp, n, n)).copy()
    if options.recursive_feasibility:
        for k in range(hp):
            k_to_go = hp - k - 1
            transition[k, :, dist_eq > k_to_go] = False

    mpa = Mpa(
        mpa_type=options.mpa_type,
        Hp=hp,
        dt_seconds=dt,
        offset=options.offset,
        recursive_feasibility=options.recursive_feasibility,
        trim_steering=steering,
        trim_speed=speed,
        adjacency=adjacency,
        transition=transition,
        distance_to_equilibrium=dist_eq,
        dx=dx,
        dy=dy,
        dyaw=dyaw,
        man_trajectory=man_traj,
        area_conv=area_conv,
        area_conv_no_offset=area_conv_no,
        area_conv_large_offset=area_conv_large,
        area_nc=area_nc,
        area_nc_no_offset=area_nc_no,
        area_nc_large_offset=area_nc_large,
        local_reachable_sets_conv=np.zeros((n, hp, K_REACHABLE, 2)),
    )

    # -- offline reachability (with-offset area family) ------------------
    family = area_nc if options.use_non_convex_obstacles else area_conv
    mpa.local_reachable_sets_conv = _reachability_analysis_offline(mpa, family)

    # HDV variant: reachability under the plain (non-recursive) adjacency
    if options.recursive_feasibility:
        import dataclasses as _dc

        mpa_nr = _dc.replace(
            mpa,
            transition=np.broadcast_to(adjacency, (hp, n, n)).copy(),
        )
        mpa.local_reachable_sets_nonrecursive = (
            _reachability_analysis_offline(mpa_nr, family)
        )
    else:
        mpa.local_reachable_sets_nonrecursive = (
            mpa.local_reachable_sets_conv.copy()
        )

    _save_mpa(mpa, cache_path)
    return mpa


def mpa_cache_name(options: Config) -> str:
    """Cache key. Reference: FileNameConstructor.get_mpa_name semantics."""
    _, adj = choose_trims(
        options.mpa_type,
        MAX_ACCELERATION_M_S2 * options.dt_seconds,
        MAX_DECELERATION_M_S2 * options.dt_seconds,
    )
    parts = [
        f"MPA_trims{adj.shape[0]}",
        "v2",
        f"Hp{options.Hp}",
        f"dt{options.dt_seconds:g}",
        f"off{options.offset:g}",
    ]
    if not options.recursive_feasibility:
        parts.append("norf")
    if options.use_non_convex_obstacles:
        parts.append("nonconvex")
    return "_".join(parts) + ".npz"


_ARRAY_FIELDS = [
    "trim_steering", "trim_speed", "adjacency", "transition",
    "distance_to_equilibrium", "dx", "dy", "dyaw", "man_trajectory",
    "area_conv", "area_conv_no_offset", "area_conv_large_offset",
    "area_nc", "area_nc_no_offset", "area_nc_large_offset",
    "local_reachable_sets_conv", "local_reachable_sets_nonrecursive",
]


def _save_mpa(mpa: Mpa, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # atomic write to avoid the reference's parallel file-race issue
    # (MotionPrimitiveAutomaton.m:173-178 skips saving in parallel mode)
    tmp = path + f".{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, **{f: getattr(mpa, f) for f in _ARRAY_FIELDS})
    os.replace(tmp, path)


def _load_mpa(path: str, options: Config) -> Mpa:
    with np.load(path) as data:
        arrays = {f: data[f] for f in _ARRAY_FIELDS}
    return Mpa(
        mpa_type=options.mpa_type,
        Hp=options.Hp,
        dt_seconds=options.dt_seconds,
        offset=options.offset,
        recursive_feasibility=options.recursive_feasibility,
        **arrays,
    )
