"""Collision masks of the beam search: obstacle-outline and lanelet-boundary
crossing and convex (SAT) overlap, as hand-written CUDA kernels with plain
PyTorch twins.

Replaces the three Pallas TPU kernels of pdmpc_tpu/ops/pallas_collision.py:

- ``outline_hits``  <- ``_outline_kernel`` via ``outline_hits_pre``
  (bundle ``precompute_outline``; road path);
- ``boundary_hits`` <- ``_boundary_kernel`` via ``boundary_hits_pre``
  (bundle ``precompute_segments``; road path);
- ``sat_hits``      <- ``_sat_kernel`` via ``sat_hits_pre``
  (bundle ``precompute_obstacles``; convex path: circle scenario and
  ``obstacle_geometry="convex"``).

Layout: candidates arrive vertex-major per vehicle, ``cx, cy [V, VA, C]``
(C = beam x trims), so one launch covers a whole planning chunk of V
vehicles. Obstacle bundles carry the same leading vehicle dim.

Two entry forms for each kernel, one scan:

- ``outline_hits(cx, cy, pre, live=None)`` / ``boundary_hits(...)`` /
  ``sat_hits(...)`` take candidate vertices; without ``live`` they return
  the hit mask, with it ``live & ~hit``;
- ``outline_hits_lattice(lattice, live, pre)`` /
  ``boundary_hits_lattice(...)`` / ``sat_hits_lattice(...)`` take one
  search layer's ``Lattice`` (area table, parent trims, poses and yaw
  cosines and sines) and its live mask ``[V, B, n]``, build the
  candidates in the kernel and return the feasibility mask
  ``live & ~hit``. The search feeds the obstacle check's result (outline
  or SAT) to the boundary kernel as its live mask.

What bounds the crossing kernels on an H100: operations, not bytes. Each
live candidate edge is tested against every active segment (VA x active
segments pairs, ~25 f32 ops each) while the inputs are a few hundred KB.
The SAT kernel: bytes, by the count of the least work (a separated pair
needs a single axis, so a typical mask needs less than the time to read
its inputs once); in practice latency, since a candidate meets its active
obstacles one after another. The design of all three (csrc/collision.cu
says more): a grid of resident blocks, each compacting its vehicle's
active segments or obstacles into shared memory, as many a round as the
scan's stage budget holds (``stage_plan``; a bundle past it is staged in
rounds, each OR-ing its hits in, which changes no mask); a group of lanes a
candidate (a warp for crossing, 8 lanes for SAT), each lane a strided
share of the segments or obstacles, the group leaving at its first hit;
candidates that are not live are not scanned. Skipping masked obstacles,
degenerate padded edges, repeated obstacle vertices, zero SAT axes and
dead candidates is exact; bounding-box culling is not (inside the
tolerance band, or on touching polygons) and is left out. The SAT scan
tests an obstacle's axes (VA projections each) before the candidate's
(one projection per distinct obstacle vertex).

Numerics: kernels and plain versions compute the crossing predicate in
the XLA form of ``pdmpc_tpu.ops.search.candidate_boundary_violations``
(numerators ``(b1 - a1) x s`` and ``(b1 - a1) x r``), not the Pallas
form ``b1 x s - a1 x s``: the CPU goldens were made on the XLA path.
Every product is rounded on its own (the CUDA source is built with
``-fmad=false``), so kernel and plain version agree bit for bit.

The SAT test also follows the XLA form,
``pdmpc_tpu.ops.search._sat_separates_batch``, not the Pallas kernel's:

- an edge (ex, ey) has the normal (-ey, ex), normalized by
  ``max(sqrt(fma(ay, ay, ax * ax)), 1e-9)`` (the Pallas kernel drops the
  normalization; on touching polygons the two can part ways);
- a vertex projects on a normal as ``fma(ay, y, ax * x)``;
- polygons are separated on an axis where ``min(pa) - max(pb) > 0`` or
  ``min(pb) - max(pa) > 0``.

That is how XLA:CPU evaluates the reference's norm and its d = 2 einsum:
of the placements of the multiply-adds, only this one matches the XLA
output everywhere (tests/test_torch_numerics.py). The kernel fuses with
``__fmaf_rn`` and rounds the square root and the division to nearest, the
plain version fuses with ``geometry.fma``; the two agree bit for bit.
XLA:CPU's vectorized f32 square root is itself one ulp above the rounded
one for some inputs (the same test file counts them), so the port agrees
with the XLA path on decisions, and on the axes to an ulp. Skipping a
masked obstacle or a zero axis (a repeated vertex: every projection on it
is 0) is exact.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

from pdmpc_torch.ops.geometry import fma

# Parameter-space tolerance of the crossing predicate
# (pdmpc_tpu/ops/search.py SEG_CROSS_TOL; also hard-coded in the kernel).
SEG_CROSS_TOL = 1e-4
# Bundle padding granules, kept from the reference bundles so the padded
# shapes match (pallas_collision.OUTLINE_GROUP / SEG_GROUP / OBS_GROUP).
OUTLINE_GROUP = 8
SEG_GROUP = 32
OBS_GROUP = 32
# Obstacles per step of the plain SAT version, to bound its memory
# (pdmpc_tpu/ops/search.py OBS_CHUNK).
SAT_CHUNK = 8
# the launcher puts one planning row on each gridDim.y index
# (csrc/collision.cu resident_grid), whose limit this is
MAX_ROWS = 65535
# Most candidates a row: the kernels index a row's candidates in 32-bit
# ints (a grid-stride loop, offsets into the row in 64 bits), so the
# stride past the last candidate must stay below 2^31. The centralized
# search's joint candidates (at most 8,000,000 a layer) are far inside.
MAX_CANDIDATES = 1 << 30
# Most candidate vertices one kernel thread holds in registers.
MAX_VA = 8
# Most vertices of an obstacle the SAT kernel stages (a half warp each).
MAX_VO = 16
# Shared-memory budget of one stage round of a kernel block (the segments
# or obstacles staged at a time; more are staged in rounds, see
# ``stage_plan``). A stage past 47 KB opts the kernel into more shared
# memory (csrc/collision.cu allow_smem); an H100 block may take 227 KB,
# some of it static. Chosen on the card (PERF.md, Findings, PR 6): on
# bundles of 5 to 16 times a 48 KB stage all three scans ran fastest in
# 48 KB rounds (96 KB up to 24% slower, 200 KB up to 55%: fewer resident
# blocks); at 1.3 stages one 64 KB stage was 2% to 4% faster. 48 KB holds
# 3,072 segments (mixed-64's whole outline stage, in one round as
# before) or 124 SAT obstacles of 16 vertices.
STAGE_BYTES = 48 * 1024
MAX_STAGE_BYTES = 226 * 1024
# Bytes a staged entry takes: a segment (b1x, b1y, sx, sy), or a SAT
# obstacle of VO vertices (vertex, axis and extents: 6 floats a vertex;
# vertex count, axis count and index: 3 ints).
SEG_STAGE_BYTES = 16


def sat_stage_bytes(vo: int) -> int:
    return 6 * vo * 4 + 3 * 4

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "collision.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lib = None
_lib_lock = threading.Lock()


def build_kernels(verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/collision.cu`` with nvcc and load it, once per
    process. The library lands in the package's ``_build/`` directory,
    named by a hash of the source and the flags, and a process that finds
    it there loads it without compiling (the ranks of a distributed run,
    started after one build)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if not os.path.isfile(nvcc):
            nvcc = "nvcc"
        os.makedirs(_BUILD_DIR, exist_ok=True)
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(
                NVCC_FLAGS).encode()).hexdigest()[:16]
        out = os.path.join(_BUILD_DIR, f"libcollision-{digest}.so")
        if not os.path.isfile(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            proc = subprocess.run(cmd + ["-o", tmp, _SRC],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed:\n{proc.stdout}{proc.stderr}")
            if verbose:
                print(proc.stdout + proc.stderr, flush=True)
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lattice = ([ptr, i32, i32, ptr, i64, i64, ptr, i64, i64, ptr, ptr,
                    i64, i64])
        lib.outline_hits.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
        lib.outline_hits_lattice.argtypes = (lattice + [ptr] * 5
                                             + [i32] * 5 + [ptr])
        lib.boundary_hits.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.boundary_hits_lattice.argtypes = (lattice + [ptr] * 4
                                              + [i32] * 4 + [ptr])
        lib.sat_hits.argtypes = [ptr] * 11 + [i32] * 6 + [ptr]
        lib.sat_hits_lattice.argtypes = (lattice + [ptr] * 9 + [i32] * 5
                                         + [ptr])
        for fn in (lib.outline_hits, lib.outline_hits_lattice,
                   lib.boundary_hits, lib.boundary_hits_lattice,
                   lib.sat_hits, lib.sat_hits_lattice):
            fn.restype = i32
        _lib = lib
        return lib


# ---------------------------------------------------------------------------
# Candidate-independent bundles (once per planning pass / per step)
# ---------------------------------------------------------------------------


class OutlinePre(NamedTuple):
    """Obstacle outlines: ox/oy [..., NO_pad, VO] f32 vertices; edge_ok
    [..., NO_pad, VO] i32, 1 where edge v -> v+1 (cyclic) is
    non-degenerate and its obstacle active; mask [..., NO_pad] i32."""

    ox: torch.Tensor
    oy: torch.Tensor
    edge_ok: torch.Tensor
    mask: torch.Tensor


def _pad_dim(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``dim`` to length ``n``."""
    pad = n - x.shape[dim]
    if pad <= 0:
        return x
    dim = dim % x.dim()
    return F.pad(x, [0, 0] * (x.dim() - 1 - dim) + [0, pad])


def precompute_outline(obs_polys: torch.Tensor,
                       obs_mask: torch.Tensor) -> OutlinePre:
    """obs_polys [..., NO, VO, 2], obs_mask [..., NO] -> OutlinePre
    (pallas_collision.precompute_outline without the tile bounding boxes,
    which only the Pallas tile skipping reads)."""
    n_obs = obs_polys.shape[-3]
    no_pad = -(-n_obs // OUTLINE_GROUP) * OUTLINE_GROUP
    obs = _pad_dim(obs_polys, no_pad, -3)
    mask = _pad_dim(obs_mask.to(torch.int32), no_pad, -1)
    nxt = torch.roll(obs, -1, dims=-2)
    edge_ok = ((torch.abs(nxt - obs).sum(dim=-1) > 0.0)
               & (mask > 0)[..., None]).to(torch.int32)
    return OutlinePre(ox=obs[..., 0].contiguous(), oy=obs[..., 1].contiguous(),
                      edge_ok=edge_ok.contiguous(), mask=mask.contiguous())


class SegmentsPre(NamedTuple):
    """Boundary segments: packed [..., 8, S_pad] f32 with rows sx, sy,
    b1x, b1y, cb = b1 x s, 0, 0, 0 (the reference's layout; the XLA-form
    kernel reads rows 0-3); mask [..., S_pad] i32."""

    packed: torch.Tensor
    mask: torch.Tensor


def precompute_segments(segments: torch.Tensor,
                        seg_mask: torch.Tensor) -> SegmentsPre:
    """segments [..., S, 2, 2], seg_mask [..., S] -> SegmentsPre
    (pallas_collision.precompute_segments without tile bounding boxes)."""
    s = segments.shape[-3]
    s_pad = -(-s // SEG_GROUP) * SEG_GROUP
    segs = _pad_dim(segments, s_pad, -3)
    mask = _pad_dim(seg_mask.to(torch.int32), s_pad, -1)
    b1 = segs[..., 0, :]
    sdir = segs[..., 1, :] - b1
    cb = b1[..., 0] * sdir[..., 1] - b1[..., 1] * sdir[..., 0]
    zero = torch.zeros_like(cb)
    packed = torch.stack(
        [sdir[..., 0], sdir[..., 1], b1[..., 0], b1[..., 1], cb,
         zero, zero, zero], dim=-2,
    )
    return SegmentsPre(packed=packed, mask=mask.contiguous())


def sat_axes(x, y, dim: int):
    """Normalized edge normals (XLA form) of polygons whose vertex
    coordinates ``x, y`` run along ``dim``: edge i -> i+1 (cyclic) gives
    (-ey, ex) / max(|.|, 1e-9)."""
    ax = -(torch.roll(y, -1, dims=dim) - y)
    ay = torch.roll(x, -1, dims=dim) - x
    norm = torch.clamp_min(torch.sqrt(fma(ay, ay, ax * ax)), 1e-9)
    return ax / norm, ay / norm


def sat_project(ax, ay, x, y):
    """Projection of vertices (x, y) on axes (ax, ay), as XLA:CPU
    evaluates the reference's d = 2 einsum: fma(ay, y, ax * x)."""
    return fma(ay, y, ax * x)


class ObstaclesPre(NamedTuple):
    """SAT obstacle bundle (pallas_collision.ObstaclesPre in the XLA form,
    without the tile bounding boxes): ox/oy [..., NO_pad, VO] vertices;
    oax/oay [..., NO_pad, VO] the normalized normal of edge v -> v+1;
    omn/omx [..., NO_pad, VO] the least and largest projection of the
    obstacle's own vertices on it; mask [..., NO_pad] i32."""

    ox: torch.Tensor
    oy: torch.Tensor
    oax: torch.Tensor
    oay: torch.Tensor
    omn: torch.Tensor
    omx: torch.Tensor
    mask: torch.Tensor


def precompute_obstacles(obs_polys: torch.Tensor,
                         obs_mask: torch.Tensor) -> ObstaclesPre:
    """obs_polys [..., NO, VO, 2], obs_mask [..., NO] -> ObstaclesPre, NO
    padded to a multiple of 32 with all-zero, masked polygons."""
    n_obs = obs_polys.shape[-3]
    no_pad = -(-n_obs // OBS_GROUP) * OBS_GROUP
    obs = _pad_dim(obs_polys, no_pad, -3)
    mask = _pad_dim(obs_mask.to(torch.int32), no_pad, -1)
    ox, oy = obs[..., 0].contiguous(), obs[..., 1].contiguous()
    oax, oay = sat_axes(ox, oy, -1)
    proj = sat_project(oax[..., :, None], oay[..., :, None],
                       ox[..., None, :], oy[..., None, :])  # [.., axis, vtx]
    return ObstaclesPre(ox=ox, oy=oy, oax=oax.contiguous(),
                        oay=oay.contiguous(),
                        omn=proj.amin(dim=-1).contiguous(),
                        omx=proj.amax(dim=-1).contiguous(),
                        mask=mask.contiguous())


# ---------------------------------------------------------------------------
# Plain versions (XLA form, no skipping)
# ---------------------------------------------------------------------------


def segment_cross_predicate(d, a_num, b_num):
    """Division-free robust crossing test given d = r x s, A = qp x s,
    B = qp x r: crossing iff |d| >= eps and A/d, B/d within [-TOL, 1+TOL]
    (pdmpc_tpu/ops/search.py _segment_cross_predicate)."""
    ad = torch.abs(d)
    t_lim = SEG_CROSS_TOL * d * d
    m_lim = ad * (1.0 + SEG_CROSS_TOL)
    return ((ad >= 1e-9)
            & (a_num * d >= -t_lim) & (torch.abs(a_num) <= m_lim)
            & (b_num * d >= -t_lim) & (torch.abs(b_num) <= m_lim))


def _crossings_plain(cx, cy, b1x, b1y, sx, sy, ok):
    """[V, C] any crossing of candidate edges (cx, cy [V, VA, C]) with the
    segments b1 + t s (each [V, E]) where ``ok`` [V, E]."""
    rx = (torch.roll(cx, -1, dims=1) - cx)[..., None]      # [V, VA, C, 1]
    ry = (torch.roll(cy, -1, dims=1) - cy)[..., None]
    sxe, sye = sx[:, None, None, :], sy[:, None, None, :]  # [V, 1, 1, E]
    qpx = b1x[:, None, None, :] - cx[..., None]             # [V, VA, C, E]
    qpy = b1y[:, None, None, :] - cy[..., None]
    d = rx * sye - ry * sxe
    a_num = qpx * sye - qpy * sxe
    b_num = qpx * ry - qpy * rx
    hit = segment_cross_predicate(d, a_num, b_num) & ok[:, None, None, :]
    return hit.any(dim=-1).any(dim=1)


def _live_only(hits):
    """A plain version from the hit mask ``hits(cx, cy, pre)`` [V, C]:
    without ``live`` the hit mask; with ``live`` [V, C] the feasibility
    ``live & ~hit``, the hits computed only on the candidates live in
    some row, as a kernel scans only live ones (the mask is the same)."""

    @functools.wraps(hits)
    def plain(cx, cy, pre, live=None):
        if live is None:
            return hits(cx, cy, pre)
        live = live.bool()
        cols = live.any(dim=0).nonzero()[:, 0]
        if cols.numel() == live.shape[1]:
            return live & ~hits(cx, cy, pre)
        hit = torch.zeros_like(live)
        if cols.numel():
            hit[:, cols] = hits(cx[..., cols], cy[..., cols], pre)
        return live & ~hit

    return plain


@_live_only
def outline_hits_plain(cx, cy, pre: OutlinePre) -> torch.Tensor:
    """[V, C] bool: a candidate edge crosses a valid edge of an active
    obstacle (with ``live`` [V, C]: ``live & ~hit``). Obstacles are taken 8
    at a time to bound memory, as pdmpc_tpu's candidate_outline_collisions
    does (OBS_CHUNK)."""
    v, _, c = cx.shape
    no = pre.ox.shape[1]
    hit = torch.zeros((v, c), dtype=torch.bool, device=cx.device)
    for o in range(0, no, OUTLINE_GROUP):
        b1x = pre.ox[:, o:o + OUTLINE_GROUP]
        b1y = pre.oy[:, o:o + OUTLINE_GROUP]
        sx = (torch.roll(b1x, -1, dims=-1) - b1x).reshape(v, -1)
        sy = (torch.roll(b1y, -1, dims=-1) - b1y).reshape(v, -1)
        ok = pre.edge_ok[:, o:o + OUTLINE_GROUP].reshape(v, -1) > 0
        hit |= _crossings_plain(cx, cy, b1x.reshape(v, -1),
                                b1y.reshape(v, -1), sx, sy, ok)
    return hit


@_live_only
def boundary_hits_plain(cx, cy, pre: SegmentsPre) -> torch.Tensor:
    """[V, C] bool: a candidate edge crosses an active boundary segment
    (with ``live`` [V, C]: ``live & ~hit``); segments taken 32 at a time to
    bound memory."""
    v, _, c = cx.shape
    s_pad = pre.packed.shape[-1]
    hit = torch.zeros((v, c), dtype=torch.bool, device=cx.device)
    for s in range(0, s_pad, SEG_GROUP):
        rows = pre.packed[:, :, s:s + SEG_GROUP]
        hit |= _crossings_plain(cx, cy, rows[:, 2], rows[:, 3], rows[:, 0],
                                rows[:, 1], pre.mask[:, s:s + SEG_GROUP] > 0)
    return hit


class Lattice(NamedTuple):
    """One search layer's candidates: candidate ``b * n + j`` of vehicle v
    is the area ``table[trim[v, b], j]`` placed at the parent pose
    ``pose[v, b]`` with the parent yaw's cosine ``c`` and sine ``s``."""

    table: torch.Tensor   # [n, n, VA, 2] f32
    trim: torch.Tensor    # [V, B] i64
    pose: torch.Tensor    # [V, B, 3] f32
    c: torch.Tensor       # [V, B, 1] f32
    s: torch.Tensor       # [V, B, 1] f32


def candidate_polys(table, trim, pose, c, s):
    """World-frame swept areas of every (beam node, successor) candidate,
    in the kernels' vertex-major layout [V, VA, B*n].

    table [n, n, VA, 2]; trim [V, B]; pose [V, B, 3]; c, s [V, B, 1]. The
    transform is computed op by op, fused as the reference's XLA path is:
    x = fma(c, tx, -(s * ty)) + px, y = fma(s, tx, c * ty) + py.
    """
    areas = table[trim]                                      # [V,B,n,VA,2]
    c4, s4 = c[..., None], s[..., None]
    ax = (fma(c4, areas[..., 0], -(s4 * areas[..., 1]))
          + pose[..., 0, None, None])
    ay = fma(s4, areas[..., 0], c4 * areas[..., 1]) + pose[..., 1, None, None]
    v, _, _, va = ax.shape
    return (ax.permute(0, 3, 1, 2).reshape(v, va, -1).contiguous(),
            ay.permute(0, 3, 1, 2).reshape(v, va, -1).contiguous())


def outline_hits_lattice_plain(lat: Lattice, live: torch.Tensor,
                               pre: OutlinePre) -> torch.Tensor:
    """[V, B, n] bool feasibility ``live & ~hit`` of the lattice's
    candidates against the obstacle bundle."""
    return outline_hits_plain(*candidate_polys(*lat), pre,
                              live.reshape(live.shape[0], -1)
                              ).reshape(live.shape)


def boundary_hits_lattice_plain(lat: Lattice, live: torch.Tensor,
                                pre: SegmentsPre) -> torch.Tensor:
    """[V, B, n] bool feasibility ``live & ~hit`` of the lattice's
    candidates against the boundary segments."""
    return boundary_hits_plain(*candidate_polys(*lat), pre,
                               live.reshape(live.shape[0], -1)
                               ).reshape(live.shape)


@_live_only
def sat_hits_plain(cx, cy, pre: ObstaclesPre) -> torch.Tensor:
    """[V, C] bool: a candidate polygon (cx, cy [V, VA, C]) overlaps an
    active obstacle, i.e. no normal of either polygon separates them (with
    ``live`` [V, C]: ``live & ~hit``); obstacles taken SAT_CHUNK at a time
    to bound memory."""
    v, _, c = cx.shape
    no = pre.ox.shape[1]
    nax, nay = sat_axes(cx, cy, 1)                           # [V, VA, C]
    own = sat_project(nax[:, :, None], nay[:, :, None], cx[:, None],
                      cy[:, None])                           # [V, k, v, C]
    cmn = own.amin(dim=2)[..., None]                         # [V, VA, C, 1]
    cmx = own.amax(dim=2)[..., None]
    hit = torch.zeros((v, c), dtype=torch.bool, device=cx.device)
    for o in range(0, no, SAT_CHUNK):
        part = [f[:, o:o + SAT_CHUNK] for f in pre[:6]]      # [V, G, VO]
        ox, oy, oax, oay, omn, omx = part
        # obstacle vertices on the candidate's normals: [V, VA, C, G, VO]
        pb = sat_project(nax[..., None, None], nay[..., None, None],
                         ox[:, None, None], oy[:, None, None])
        sep = ((cmn - pb.amax(dim=-1) > 0)
               | (pb.amin(dim=-1) - cmx > 0)).any(dim=1)     # [V, C, G]
        # candidate vertices on the obstacle's normals: [V, VA, C, G, VO]
        pa = sat_project(oax[:, None, None], oay[:, None, None],
                         cx[..., None, None], cy[..., None, None])
        sep |= ((pa.amin(dim=1) - omx[:, None] > 0)
                | (omn[:, None] - pa.amax(dim=1) > 0)).any(dim=-1)
        active = pre.mask[:, None, o:o + SAT_CHUNK] > 0      # [V, 1, G]
        hit |= (~sep & active).any(dim=-1)
    return hit


def sat_hits_lattice_plain(lat: Lattice, live: torch.Tensor,
                           pre: ObstaclesPre) -> torch.Tensor:
    """[V, B, n] bool feasibility ``live & ~hit`` of the lattice's convex
    candidates against the SAT obstacle bundle."""
    return sat_hits_plain(*candidate_polys(*lat), pre,
                          live.reshape(live.shape[0], -1)
                          ).reshape(live.shape)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


class StagePlan(NamedTuple):
    """How a kernel block stages a bundle: ``cap`` entries (segments or
    obstacles) a round in ``bytes`` of shared memory, in at most
    ``rounds`` rounds (that many when every entry is active; a round
    stages only active ones, so fewer are needed otherwise)."""

    cap: int
    bytes: int
    rounds: int


def stage_plan(entries: int, entry_bytes: int,
               budget: int | None = None) -> StagePlan:
    """The stage plan of a bundle of ``entries`` entries of
    ``entry_bytes`` each under a shared-memory ``budget`` in bytes
    (default ``STAGE_BYTES``): as many entries a round as the budget
    holds, at least one. Host arithmetic only, the same for every call of
    a shape."""
    budget = STAGE_BYTES if budget is None else budget
    if not entry_bytes <= budget <= MAX_STAGE_BYTES:
        raise ValueError(f"stage budget {budget} bytes outside "
                         f"[{entry_bytes}, {MAX_STAGE_BYTES}]")
    cap = max(1, min(entries, budget // entry_bytes))
    return StagePlan(cap, cap * entry_bytes, -(-entries // cap))


def _check_candidates(cx, cy):
    if cx.dim() != 3 or cx.shape != cy.shape:
        raise ValueError(f"candidates must be [V, VA, C]; got {cx.shape}, "
                         f"{cy.shape}")
    if cx.dtype != torch.float32 or cy.dtype != torch.float32:
        raise TypeError("candidates must be float32")
    if cx.shape[1] > MAX_VA:
        raise ValueError(f"at most {MAX_VA} candidate vertices")


_LIVE_DTYPES = (torch.bool, torch.uint8)


def _device_of(live):
    """Device index of a call's live mask (-1: the CPU); raises for any
    device that is neither the CPU nor CUDA."""
    if not (live.is_cuda or live.is_cpu):
        raise ValueError(f"the collision checks run on CPU or CUDA tensors, "
                         f"not on {live.device}")
    return live.get_device()


def _check(dev, specs):
    """Raise unless every (name, tensor, shape, dtype, dense) in ``specs``
    has that shape and dtype (None: bool or uint8), lies on device index
    ``dev`` (-1: the CPU) and, where ``dense``, is contiguous. One pass of
    cheap attribute reads: the wrappers stand in the host-bound step."""
    for name, t, shape, dtype, dense in specs:
        if (t.shape != shape
                or (t.dtype != dtype if dtype is not None
                    else t.dtype not in _LIVE_DTYPES)
                or t.get_device() != dev or (dev < 0 and not t.is_cpu)
                or (dense and not t.is_contiguous())):
            raise ValueError(
                f"{name}: expected {dtype or 'bool or uint8'} {shape} on "
                f"device {dev}{' (contiguous)' if dense else ''}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_lattice(lat: Lattice, live: torch.Tensor, dev: int):
    """Shapes, dtypes and devices of a lattice-form call; trims, poses and
    c, s may be strided views (an expanded trim row, a slice of a gathered
    payload), the rest must be dense. Returns (V, B, n, VA)."""
    table, trim, pose, c, s = lat
    if (table.dim() != 4 or table.shape[0] != table.shape[1]
            or table.shape[3] != 2 or table.shape[2] > MAX_VA
            or trim.dim() != 2):
        raise ValueError(f"lattice: table must be [n, n, VA <= {MAX_VA}, 2] "
                         f"and trim [V, B]; got {tuple(table.shape)}, "
                         f"{tuple(trim.shape)}")
    n, _, va, _ = table.shape
    v, b = trim.shape
    _check(dev, (("live", live, (v, b, n), None, dev >= 0),
                 ("table", table, (n, n, va, 2), torch.float32, dev >= 0),
                 ("trim", trim, (v, b), torch.int64, False),
                 ("pose", pose, (v, b, 3), torch.float32, False),
                 ("c", c, (v, b, 1), torch.float32, False),
                 ("s", s, (v, b, 1), torch.float32, False)))
    return v, b, n, va


def _stream(dev):
    """The current stream of CUDA device ``dev``, as a pointer."""
    return torch._C._cuda_getCurrentRawStream(dev)


def _lattice_args(lat: Lattice, n: int, va: int):
    """The lattice's leading ctypes arguments (csrc: outline_hits_lattice):
    pointers with their strides in elements, so the search passes trims,
    poses and c, s without a copy."""
    table, trim, pose, c, s = lat
    if pose.stride(2) != 1 or c.stride() != s.stride():
        raise ValueError("lattice: pose's last dim must be dense, c and s "
                         "alike in strides")
    return (table.data_ptr(), n, va, trim.data_ptr(), *trim.stride(),
            pose.data_ptr(), *pose.stride()[:2], c.data_ptr(), s.data_ptr(),
            *c.stride()[:2])


def _launched(err, kernel, form=None):
    """Count a launch of ``kernel`` (its wrapper's ``launches``: every
    form) and, for a lattice-form call, of ``form`` too; raise on a failed
    launch."""
    if err != 0:
        raise RuntimeError(f"{kernel.__name__} kernel launch failed: CUDA "
                           f"error {err}")
    kernel.launches += 1
    if form is not None:
        form.launches += 1


def _candidates(cx, cy, live):
    """Checks of a (cx, cy)-form call; returns (device index, V, VA, C)."""
    _check_candidates(cx, cy)
    v, va, c = cx.shape
    dev = _device_of(cx)
    specs = [("cx", cx, (v, va, c), torch.float32, dev >= 0),
             ("cy", cy, (v, va, c), torch.float32, dev >= 0)]
    if live is not None:
        specs.append(("live", live, (v, c), None, dev >= 0))
    _check(dev, specs)
    return dev, v, va, c


def check_candidate_count(c: int) -> None:
    """Raise unless a row's ``c`` candidates fit the kernels' 32-bit
    candidate index (MAX_CANDIDATES)."""
    if c > MAX_CANDIDATES:
        raise ValueError(f"{c} candidates a row exceed the collision "
                         f"kernels' {MAX_CANDIDATES}")


def check_rows(v: int) -> None:
    """Raise unless a launch's ``v`` planning rows fit the kernels' grid:
    each row is one ``gridDim.y`` index, at most MAX_ROWS. Past it no
    kernel launches and no plain version stands in."""
    if v > MAX_ROWS:
        raise ValueError(
            f"{v} planning rows exceed the collision kernels' {MAX_ROWS} "
            f"(one gridDim.y index a row); plan fewer scenarios at once")


def _outline_ptrs(pre: OutlinePre, v, dev):
    """Checks of an obstacle bundle for the kernel; returns its pointers
    and (NO, VO, segments a stage round)."""
    check_rows(v)
    no, vo = pre.ox.shape[1:]
    _check(dev, (("ox", pre.ox, (v, no, vo), torch.float32, True),
                 ("oy", pre.oy, (v, no, vo), torch.float32, True),
                 ("edge_ok", pre.edge_ok, (v, no, vo), torch.int32, True)))
    return ((pre.ox.data_ptr(), pre.oy.data_ptr(), pre.edge_ok.data_ptr()),
            no, vo, stage_plan(no * vo, SEG_STAGE_BYTES).cap)


def _segment_ptrs(pre: SegmentsPre, v, dev):
    """Checks of a segment bundle for the kernel; returns its pointers,
    S_pad and the segments a stage round."""
    check_rows(v)
    s_pad = pre.packed.shape[-1]
    _check(dev, (("packed", pre.packed, (v, 8, s_pad), torch.float32, True),
                 ("mask", pre.mask, (v, s_pad), torch.int32, True)))
    return ((pre.packed.data_ptr(), pre.mask.data_ptr()), s_pad,
            stage_plan(s_pad, SEG_STAGE_BYTES).cap)


def _obstacle_ptrs(pre: ObstaclesPre, v, dev):
    """Checks of a SAT obstacle bundle for the kernel; returns its
    pointers (the bundle's field order), NO, VO and the obstacles a stage
    round."""
    check_rows(v)
    no, vo = pre.ox.shape[1:]
    if vo > MAX_VO:
        raise ValueError(f"at most {MAX_VO} obstacle vertices, got {vo}")
    _check(dev, tuple((name, getattr(pre, name), (v, no, vo), torch.float32,
                       True) for name in ObstaclesPre._fields[:6])
           + (("mask", pre.mask, (v, no), torch.int32, True),))
    return (tuple(t.data_ptr() for t in pre), no, vo,
            stage_plan(no, sat_stage_bytes(vo)).cap)


def outline_hits(cx: torch.Tensor, cy: torch.Tensor, pre: OutlinePre,
                 live: torch.Tensor | None = None) -> torch.Tensor:
    """[V, C] outline-crossing mask of candidates cx, cy [V, VA, C]
    against the obstacle bundle ``pre`` (leading dim V); with ``live``
    [V, C] (bool or uint8) the feasibility ``live & ~hit`` instead, and
    candidates that are not live are not scanned."""
    dev, v, va, c = _candidates(cx, cy, live)
    if dev < 0:
        return outline_hits_plain(cx, cy, pre, live)
    check_candidate_count(c)
    ptrs, no, vo, cap = _outline_ptrs(pre, v, dev)
    out = torch.empty((v, c), dtype=torch.bool, device=cx.device)
    if out.numel() == 0:
        return out
    _launched(build_kernels().outline_hits(
        cx.data_ptr(), cy.data_ptr(), *ptrs,
        None if live is None else live.data_ptr(), out.data_ptr(), v, va, c,
        no, vo, cap, _stream(dev)), outline_hits)
    return out


outline_hits.launches = 0


def outline_hits_lattice(lat: Lattice, live: torch.Tensor,
                         pre: OutlinePre) -> torch.Tensor:
    """[V, B, n] bool feasibility ``live & ~hit`` of one search layer's
    candidates (built in the kernel from ``lat``) against the obstacle
    bundle ``pre``; ``live`` [V, B, n] bool or uint8. One launch of the
    outline kernel (counted on ``outline_hits.launches`` and on this
    form's own ``launches``)."""
    dev = _device_of(live)
    v, b, n, va = _check_lattice(lat, live, dev)
    if dev < 0:
        return outline_hits_lattice_plain(lat, live, pre)
    ptrs, no, vo, cap = _outline_ptrs(pre, v, dev)
    out = torch.empty((v, b, n), dtype=torch.bool, device=live.device)
    if out.numel() == 0:
        return out
    _launched(build_kernels().outline_hits_lattice(
        *_lattice_args(lat, n, va), *ptrs, live.data_ptr(), out.data_ptr(),
        v, b, no, vo, cap, _stream(dev)), outline_hits,
        outline_hits_lattice)
    return out


outline_hits_lattice.launches = 0


def boundary_hits(cx: torch.Tensor, cy: torch.Tensor, pre: SegmentsPre,
                  live: torch.Tensor | None = None) -> torch.Tensor:
    """[V, C] boundary-crossing mask of candidates cx, cy [V, VA, C]
    against the segment bundle ``pre`` (leading dim V); with ``live``
    [V, C] the feasibility ``live & ~hit`` instead."""
    dev, v, va, c = _candidates(cx, cy, live)
    if dev < 0:
        return boundary_hits_plain(cx, cy, pre, live)
    check_candidate_count(c)
    ptrs, s_pad, cap = _segment_ptrs(pre, v, dev)
    out = torch.empty((v, c), dtype=torch.bool, device=cx.device)
    if out.numel() == 0:
        return out
    _launched(build_kernels().boundary_hits(
        cx.data_ptr(), cy.data_ptr(), *ptrs,
        None if live is None else live.data_ptr(), out.data_ptr(), v, va, c,
        s_pad, cap, _stream(dev)), boundary_hits)
    return out


boundary_hits.launches = 0


def boundary_hits_lattice(lat: Lattice, live: torch.Tensor,
                          pre: SegmentsPre) -> torch.Tensor:
    """[V, B, n] bool feasibility ``live & ~hit`` of one search layer's
    candidates (built in the kernel from ``lat``) against the boundary
    segments ``pre``; ``live`` [V, B, n] bool or uint8 (in the search: the
    outline kernel's result). One launch of the boundary kernel (counted
    on ``boundary_hits.launches`` and on this form's own ``launches``)."""
    dev = _device_of(live)
    v, b, n, va = _check_lattice(lat, live, dev)
    if dev < 0:
        return boundary_hits_lattice_plain(lat, live, pre)
    ptrs, s_pad, cap = _segment_ptrs(pre, v, dev)
    out = torch.empty((v, b, n), dtype=torch.bool, device=live.device)
    if out.numel() == 0:
        return out
    _launched(build_kernels().boundary_hits_lattice(
        *_lattice_args(lat, n, va), *ptrs, live.data_ptr(), out.data_ptr(),
        v, b, s_pad, cap, _stream(dev)), boundary_hits,
        boundary_hits_lattice)
    return out


boundary_hits_lattice.launches = 0


def sat_hits(cx: torch.Tensor, cy: torch.Tensor, pre: ObstaclesPre,
             live: torch.Tensor | None = None) -> torch.Tensor:
    """[V, C] SAT overlap mask of candidates cx, cy [V, VA, C] against the
    obstacle bundle ``pre`` (leading dim V); with ``live`` [V, C] (bool or
    uint8) the feasibility ``live & ~hit`` instead, and candidates that
    are not live are not scanned."""
    dev, v, va, c = _candidates(cx, cy, live)
    if dev < 0:
        return sat_hits_plain(cx, cy, pre, live)
    check_candidate_count(c)
    ptrs, no, vo, cap = _obstacle_ptrs(pre, v, dev)
    out = torch.empty((v, c), dtype=torch.bool, device=cx.device)
    if out.numel() == 0:
        return out
    _launched(build_kernels().sat_hits(
        cx.data_ptr(), cy.data_ptr(), *ptrs,
        None if live is None else live.data_ptr(), out.data_ptr(), v, va, c,
        no, vo, cap, _stream(dev)), sat_hits)
    return out


sat_hits.launches = 0


def sat_hits_lattice(lat: Lattice, live: torch.Tensor,
                     pre: ObstaclesPre) -> torch.Tensor:
    """[V, B, n] bool feasibility ``live & ~hit`` of one search layer's
    convex candidates (built in the kernel from ``lat``) against the SAT
    obstacle bundle ``pre``; ``live`` [V, B, n] bool or uint8. One launch
    of the SAT kernel (counted on ``sat_hits.launches`` and on this form's
    own ``launches``)."""
    dev = _device_of(live)
    v, b, n, va = _check_lattice(lat, live, dev)
    if dev < 0:
        return sat_hits_lattice_plain(lat, live, pre)
    ptrs, no, vo, cap = _obstacle_ptrs(pre, v, dev)
    out = torch.empty((v, b, n), dtype=torch.bool, device=live.device)
    if out.numel() == 0:
        return out
    _launched(build_kernels().sat_hits_lattice(
        *_lattice_args(lat, n, va), *ptrs, live.data_ptr(), out.data_ptr(),
        v, b, no, vo, cap, _stream(dev)), sat_hits, sat_hits_lattice)
    return out


sat_hits_lattice.launches = 0
