"""Native runtime components (C++), loaded via ctypes.

Torch twin of pdmpc_tpu/native (``astar.cpp`` is a copy of its source).
The reference's native component is a C++ MEX priority queue powering its
A* (priority_queue_interface_mex.cpp, built by compile_priority_queue.m
and the CI Build job). Here the whole A* search core is native
(``astar.cpp``), compiled at first use with g++ (the
compile_priority_queue.m role) into the package's gitignored ``_build/``
directory and exposed through a C ABI: the host-side reference planner
and the fast oracle that validates the beam search
(``utils.astar_oracle.astar_plan`` is its numpy twin).

The library is named by a hash of the source and the flags. Concurrent
processes (pytest workers) build it once: a file lock serializes them, and
the library appears by an atomic rename. A failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "astar.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def compile_native(force: bool = False) -> str:
    """Build the shared library if it is not built yet, or again with
    ``force`` (the compile_priority_queue.m role); returns its path.
    Raises ``RuntimeError`` with the compiler's output when g++ fails."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(_BUILD_DIR, f"libpdmpc_astar-{digest}.so")
    with _lock:
        if not force and os.path.isfile(out):
            return out
        os.makedirs(_BUILD_DIR, exist_ok=True)
        with open(out + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if force or not os.path.isfile(out):
                tmp = f"{out}.{os.getpid()}.tmp"
                proc = subprocess.run(
                    ["g++", *GXX_FLAGS, "-o", tmp, _SRC],
                    capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"g++ failed:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, out)
        return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(compile_native())
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f8p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i4p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.astar_plan.restype = ctypes.c_int
        lib.astar_plan.argtypes = [
            ctypes.c_int, ctypes.c_int,                  # n_trims, hp
            u8p, f8p, f8p, f8p,                  # transition, dx, dy, dyaw
            f8p, ctypes.c_int,                           # areas, va
            ctypes.c_double, ctypes.c_double,            # x0, y0
            ctypes.c_double, ctypes.c_int,               # yaw0, trim0
            f8p, f8p, ctypes.c_double,                   # ref, vref, dt
            f8p, u8p, ctypes.c_int, ctypes.c_int,        # obs, mask, n_obs, vo
            ctypes.c_int,                                # non_convex
            f8p, ctypes.c_int,                           # bnd, n_bnd
            f8p, f8p,                                    # areas_bnd_no/lg
            i4p, f8p,                                    # out trims, poses
            ctypes.POINTER(ctypes.c_double),             # out cost
            ctypes.POINTER(ctypes.c_int),                # out n_expanded
        ]
        _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the native A* builds and loads here: False when g++ is
    missing or fails (or the library does not load); never raises."""
    try:
        _load()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def astar_plan_native(mpa, x0, trim0, ref_points, v_ref, obs_polys,
                      obs_mask, dt, boundary_segments=None,
                      boundary_mask=None, non_convex=False):
    """Native A* with the interface of ``utils.astar_oracle.astar_plan``
    (the road-path constraints included: non-convex outline obstacles and
    lanelet-boundary segments), on the port's ``models.mpa.Mpa``."""
    from pdmpc_torch.utils.astar_oracle import OraclePlan

    lib = _load()
    hp = mpa.Hp
    n = mpa.n_trims
    if non_convex:
        area_obs = mpa.area_nc
        area_bnd_no = mpa.area_nc_no_offset
        area_bnd_lg = mpa.area_nc_large_offset
    else:
        area_obs = mpa.area_conv
        area_bnd_no = mpa.area_conv_no_offset
        area_bnd_lg = mpa.area_conv_large_offset
    va = area_obs.shape[2]
    obs_polys = np.ascontiguousarray(obs_polys, dtype=np.float64)
    n_obs, vo = obs_polys.shape[0], obs_polys.shape[2]

    bnd = np.zeros((1, 2, 2), dtype=np.float64)
    n_bnd = 0
    if boundary_segments is not None:
        active = np.asarray(boundary_segments, dtype=np.float64)[
            np.asarray(boundary_mask, dtype=bool)]
        n_bnd = active.shape[0]
        if n_bnd:
            bnd = np.ascontiguousarray(active)

    out_trims = np.zeros(hp, dtype=np.int32)
    out_poses = np.zeros((hp, 3), dtype=np.float64)
    cost = ctypes.c_double()
    n_expanded = ctypes.c_int()

    rc = lib.astar_plan(
        n, hp,
        np.ascontiguousarray(mpa.transition, dtype=np.uint8),
        np.ascontiguousarray(mpa.dx, dtype=np.float64),
        np.ascontiguousarray(mpa.dy, dtype=np.float64),
        np.ascontiguousarray(mpa.dyaw, dtype=np.float64),
        np.ascontiguousarray(area_obs, dtype=np.float64),
        va,
        float(x0[0]), float(x0[1]), float(x0[2]), int(trim0),
        np.ascontiguousarray(ref_points, dtype=np.float64),
        np.ascontiguousarray(v_ref, dtype=np.float64),
        float(dt),
        obs_polys,
        np.ascontiguousarray(obs_mask, dtype=np.uint8),
        n_obs, vo,
        int(non_convex),
        bnd, n_bnd,
        np.ascontiguousarray(area_bnd_no, dtype=np.float64),
        np.ascontiguousarray(area_bnd_lg, dtype=np.float64),
        out_trims, out_poses,
        ctypes.byref(cost), ctypes.byref(n_expanded),
    )
    return OraclePlan(
        trims=out_trims.astype(np.int64),
        poses=out_poses,
        cost=float(cost.value),
        is_exhausted=rc != 0,
        n_expanded=int(n_expanded.value),
    )
