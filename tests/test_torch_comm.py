"""``MeshComm`` over gloo ranks on the CPU against ``LocalComm``; and the
rank workers of the port's distributed tests.

Each rank takes its block of a traffic-like bundle of mixed dtypes (poses
f32, trims and lanelet ids i64, flags bool, shapes f32, and an absent
field) and runs every method (``comm_checks``) over 2 and 4 ranks.
``gather_veh`` and the one fused collective of ``gather_tree`` must both
give ``LocalComm``'s identity on the whole bundle, bit for bit and in the
fields' own dtypes; ``local_slice`` and ``global_indices`` the rank's
block; ``psum`` the total.

``comm_checks`` and ``sharded_runs`` (tests/test_torch_sharded.py) run in
the ranks ``pdmpc_torch.parallel.multihost.spawn`` starts, which import
this module by name: like the port, it imports torch, numpy and
pdmpc_torch only, never jax.
"""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pdmpc_torch.parallel.comm import LocalComm, MeshComm
from pdmpc_torch.parallel.multihost import spawn

torch.set_num_threads(1)

N_VEHICLES = 8
SEED = 3


def global_tensors(n_vehicles: int, seed: int) -> tuple:
    """A traffic-like bundle [B = 2, N, ...] of mixed dtypes from a seed:
    poses f32, trims i64, flags bool, no HDV field (None), lanelet ids
    i64, shapes f32."""
    rng = np.random.default_rng(seed)
    b, n = 2, n_vehicles
    return (torch.as_tensor(rng.normal(size=(b, n, 3)), dtype=torch.float32),
            torch.as_tensor(rng.integers(0, 40, (b, n))),
            torch.as_tensor(rng.random((b, n)) < 0.5),
            None,
            torch.as_tensor(rng.integers(0, 200, (b, n, 8))),
            torch.as_tensor(rng.normal(size=(b, n, 6, 16, 2)),
                            dtype=torch.float32))


def comm_checks(device: torch.device, n_vehicles: int, seed: int) -> dict:
    """This rank's results of every ``MeshComm`` method on its block of
    ``global_tensors`` (as numpy), with ``LocalComm``'s identities on the
    global tensors beside them for the parent to compare."""
    tree = tuple(None if x is None else x.to(device)
                 for x in global_tensors(n_vehicles, seed))
    comm = MeshComm(n_vehicles)
    local = tuple(None if x is None else comm.local_slice(x) for x in tree)
    fused = comm.gather_tree(local)
    per_field = tuple(None if x is None else comm.gather_veh(x)
                      for x in local)
    counts = torch.tensor([int(local[2].sum())], device=device)
    psum = comm.psum(counts)
    ident = LocalComm(n_vehicles)
    return {
        "rank": dist.get_rank(), "n_local": comm.n_local,
        "global_indices": comm.global_indices(device).cpu().numpy(),
        "local": [None if x is None else x.cpu().numpy() for x in local],
        "fused": [None if x is None else x.cpu().numpy() for x in fused],
        "per_field": [None if x is None else x.cpu().numpy()
                      for x in per_field],
        "psum": int(psum), "local_psum": int(ident.psum(tree[2].sum())),
        "local_gather": [None if x is None else x.cpu().numpy()
                         for x in ident.gather_tree(tree)],
    }


def sharded_runs(device: torch.device, cells: list) -> dict:
    """Run each cell (name, Config, mesh shape (S, V), batch, kind) on
    this rank's block of ``batch`` identical starts: ``kind`` "sharded"
    (``make_sharded_run``) or "data_parallel" (``make_data_parallel_run``).
    Returns name -> (final states, records), the whole batch as numpy, as
    this rank assembled it."""
    from pdmpc_torch.experiment import create_scenario
    from pdmpc_torch.models.mpa import build_mpa
    from pdmpc_torch.parallel import sharded

    out = {}
    for name, cfg, shape, batch, kind in cells:
        cfg = cfg.validate()
        mpa = build_mpa(cfg)
        mpa_t = mpa.to_tensors_for(cfg, device)
        sc_t = create_scenario(cfg, mpa).to_tensors(device)
        mesh = sharded.make_mesh(*shape)
        make = (sharded.make_sharded_run if kind == "sharded"
                else sharded.make_data_parallel_run)
        states = sharded.place_batched_state(
            sharded.batched_initial_state(sc_t, cfg.Hp, batch), mesh)
        final, infos = make(cfg, mpa_t, sc_t, mesh)(states, mpa_t, sc_t)
        out[name] = (type(final)(*(x.cpu().numpy() for x in final)),
                     type(infos)(*(x.cpu().numpy() for x in infos)))
    return out


@functools.cache
def ranks(n_ranks):
    return spawn(comm_checks, n_ranks, (N_VEHICLES, SEED), device="cpu",
                 timeout=300)


def whole():
    return [None if x is None else x.numpy()
            for x in global_tensors(N_VEHICLES, SEED)]


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_gather_veh_equals_local_comm(n_ranks):
    want = whole()
    for r in ranks(n_ranks):
        for got, w, ident in zip(r["per_field"], want, r["local_gather"]):
            if w is None:
                assert got is None and ident is None
                continue
            assert got.dtype == w.dtype
            np.testing.assert_array_equal(got, w)
            np.testing.assert_array_equal(ident, w)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_gather_tree_equals_per_field_gathers(n_ranks):
    for r in ranks(n_ranks):
        for fused, per_field in zip(r["fused"], r["per_field"]):
            if per_field is None:
                assert fused is None
                continue
            assert fused.dtype == per_field.dtype
            assert fused.shape == per_field.shape
            assert fused.tobytes() == per_field.tobytes()


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_local_slice_and_global_indices(n_ranks):
    want = whole()
    nl = N_VEHICLES // n_ranks
    for r in ranks(n_ranks):
        rank = r["rank"]
        assert r["n_local"] == nl
        np.testing.assert_array_equal(
            r["global_indices"], np.arange(rank * nl, (rank + 1) * nl))
        for got, w in zip(r["local"], want):
            if w is not None:
                np.testing.assert_array_equal(
                    got, w[:, rank * nl:(rank + 1) * nl])


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_psum_equals_total(n_ranks):
    total = int(whole()[2].sum())
    for r in ranks(n_ranks):
        assert r["psum"] == r["local_psum"] == total
