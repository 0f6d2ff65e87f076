"""Collision masks of the beam search: obstacle-outline and lanelet-boundary
crossing, as hand-written CUDA kernels with plain PyTorch twins.

Replaces the two Pallas TPU kernels of the main (road) path in
pdmpc_tpu/ops/pallas_collision.py:

- ``outline_hits``  <- ``_outline_kernel`` via ``outline_hits_pre``
  (bundle ``precompute_outline``);
- ``boundary_hits`` <- ``_boundary_kernel`` via ``boundary_hits_pre``
  (bundle ``precompute_segments``).

Layout: candidates arrive vertex-major per vehicle, ``cx, cy [V, VA, C]``
(C = beam x trims), so one launch covers a whole planning chunk of V
vehicles. Obstacle bundles carry the same leading vehicle dim.

What bounds the kernels on an H100: operations, not bytes. Each candidate
edge is tested against every active obstacle edge (VA x NO x VO pairs,
~20 f32 ops each) while the inputs are a few hundred KB. The design (one
thread per candidate, the vehicle's active edges compacted into shared
memory, early exit on the first hit) keeps every pair in registers and
shared memory; skipping masked obstacles and degenerate padded edges is
exact. What it leaves for later: warp-tiled candidates and bounding-box
culling with a proven tolerance margin.

Numerics: kernels and plain versions compute the crossing predicate in
the XLA form of ``pdmpc_tpu.ops.search.candidate_boundary_violations``
(numerators ``(b1 - a1) x s`` and ``(b1 - a1) x r``), not the Pallas
form ``b1 x s - a1 x s``: the CPU goldens were made on the XLA path.
Every product is rounded on its own (the CUDA source is built with
``-fmad=false``), so kernel and plain version agree bit for bit.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

# Parameter-space tolerance of the crossing predicate
# (pdmpc_tpu/ops/search.py SEG_CROSS_TOL; also hard-coded in the kernel).
SEG_CROSS_TOL = 1e-4
# Bundle padding granules, kept from the reference bundles so the padded
# shapes match (pallas_collision.OUTLINE_GROUP / SEG_GROUP).
OUTLINE_GROUP = 8
SEG_GROUP = 32
# Most candidate vertices one kernel thread holds in registers.
MAX_VA = 8
# Shared-memory budget of one block's staged edges (4 floats each).
_MAX_STAGED_EDGES = 48 * 1024 // 16

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "collision.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lib = None
_lib_lock = threading.Lock()


def build_kernels(verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/collision.cu`` with nvcc (once per process) and load
    it. The library lands in the package's ``_build/`` directory."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if not os.path.isfile(nvcc):
            nvcc = "nvcc"
        os.makedirs(_BUILD_DIR, exist_ok=True)
        out = os.path.join(_BUILD_DIR, "libcollision.so")
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        proc = subprocess.run(cmd + ["-o", tmp, _SRC], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.outline_hits.argtypes = [ptr] * 5 + [ptr] + [i32] * 5 + [ptr]
        lib.outline_hits.restype = i32
        lib.boundary_hits.argtypes = [ptr] * 4 + [ptr] + [i32] * 4 + [ptr]
        lib.boundary_hits.restype = i32
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


def outline_hits_plain(cx, cy, pre: OutlinePre) -> torch.Tensor:
    """[V, C] bool: a candidate edge crosses a valid edge of an active
    obstacle. Obstacles are taken 8 at a time to bound memory, as
    pdmpc_tpu's candidate_outline_collisions does (OBS_CHUNK)."""
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


def boundary_hits_plain(cx, cy, pre: SegmentsPre) -> torch.Tensor:
    """[V, C] bool: a candidate edge crosses an active boundary segment
    (segments taken 32 at a time to bound memory)."""
    v, _, c = cx.shape
    s_pad = pre.packed.shape[-1]
    hit = torch.zeros((v, c), dtype=torch.bool, device=cx.device)
    for s in range(0, s_pad, SEG_GROUP):
        rows = pre.packed[:, :, s:s + SEG_GROUP]
        hit |= _crossings_plain(cx, cy, rows[:, 2], rows[:, 3], rows[:, 0],
                                rows[:, 1], pre.mask[:, s:s + SEG_GROUP] > 0)
    return hit


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_candidates(cx, cy):
    if cx.dim() != 3 or cx.shape != cy.shape:
        raise ValueError(f"candidates must be [V, VA, C]; got {cx.shape}, "
                         f"{cy.shape}")
    if cx.dtype != torch.float32 or cy.dtype != torch.float32:
        raise TypeError("candidates must be float32")
    if cx.shape[1] > MAX_VA:
        raise ValueError(f"at most {MAX_VA} candidate vertices")


def _check_operand(t, name, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")


def outline_hits(cx: torch.Tensor, cy: torch.Tensor,
                 pre: OutlinePre) -> torch.Tensor:
    """[V, C] outline-crossing mask of candidates cx, cy [V, VA, C]
    against the obstacle bundle ``pre`` (leading dim V)."""
    _check_candidates(cx, cy)
    if cx.device.type == "cpu":
        return outline_hits_plain(cx, cy, pre)
    v, va, c = cx.shape
    no, vo = pre.ox.shape[1:]
    for name, t, dt in (("cx", cx, torch.float32), ("cy", cy, torch.float32),
                        ("ox", pre.ox, torch.float32),
                        ("oy", pre.oy, torch.float32),
                        ("edge_ok", pre.edge_ok, torch.int32)):
        shape = (v, va, c) if name in ("cx", "cy") else (v, no, vo)
        _check_operand(t, name, shape, dt, cx.device)
    if no * vo > _MAX_STAGED_EDGES:
        raise ValueError(f"{no * vo} obstacle edges exceed the shared-"
                         f"memory stage of {_MAX_STAGED_EDGES}")
    out = torch.empty((v, c), dtype=torch.bool, device=cx.device)
    if out.numel() == 0:
        return out
    lib = build_kernels()
    err = lib.outline_hits(
        cx.data_ptr(), cy.data_ptr(), pre.ox.data_ptr(), pre.oy.data_ptr(),
        pre.edge_ok.data_ptr(), out.data_ptr(), v, va, c, no, vo,
        torch.cuda.current_stream(cx.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"outline_hits kernel launch failed: CUDA error "
                           f"{err}")
    outline_hits.launches += 1
    return out


outline_hits.launches = 0


def boundary_hits(cx: torch.Tensor, cy: torch.Tensor,
                  pre: SegmentsPre) -> torch.Tensor:
    """[V, C] boundary-crossing mask of candidates cx, cy [V, VA, C]
    against the segment bundle ``pre`` (leading dim V)."""
    _check_candidates(cx, cy)
    if cx.device.type == "cpu":
        return boundary_hits_plain(cx, cy, pre)
    v, va, c = cx.shape
    s_pad = pre.packed.shape[-1]
    _check_operand(cx, "cx", (v, va, c), torch.float32, cx.device)
    _check_operand(cy, "cy", (v, va, c), torch.float32, cx.device)
    _check_operand(pre.packed, "packed", (v, 8, s_pad), torch.float32,
                   cx.device)
    _check_operand(pre.mask, "mask", (v, s_pad), torch.int32, cx.device)
    if s_pad > _MAX_STAGED_EDGES:
        raise ValueError(f"{s_pad} segments exceed the shared-memory stage "
                         f"of {_MAX_STAGED_EDGES}")
    out = torch.empty((v, c), dtype=torch.bool, device=cx.device)
    if out.numel() == 0:
        return out
    lib = build_kernels()
    err = lib.boundary_hits(
        cx.data_ptr(), cy.data_ptr(), pre.packed.data_ptr(),
        pre.mask.data_ptr(), out.data_ptr(), v, va, c, s_pad,
        torch.cuda.current_stream(cx.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"boundary_hits kernel launch failed: CUDA error "
                           f"{err}")
    boundary_hits.launches += 1
    return out


boundary_hits.launches = 0
