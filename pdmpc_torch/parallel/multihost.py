"""Multi-process execution: the ``parallel_physically`` mode, and the
rank processes of the other distributed runs.

Torch twin of pdmpc_tpu/parallel/multihost.py. Reference: nuc_control/
(SSH deployment of one MATLAB process per NUC, each running
``main_distributed(i)``). Here every process runs the same program in one
``torch.distributed`` process group, the vehicle groups' collectives ride
the network between hosts, and the results land on rank 0.

Launch one process per rank (the reference's deploy_nuc.sh role is
played by the cluster scheduler, mpirun or a shell loop):

    python -m pdmpc_torch.parallel.multihost --coordinator host0:29500 \\
        --num-processes 4 --process-id $RANK --backend nccl -- \\
        --scenario commonroad --amount 20

The backend is the caller's choice and no run swaps it: NCCL where each
rank has a card of its own, gloo where ranks share one card or run on the
CPU (NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import argparse
import multiprocessing
import pickle
import queue
import socket
import sys
import time
import traceback

import torch
import torch.distributed as dist

from pdmpc_torch import resolve_device
from pdmpc_torch.parallel.comm import TIMEOUT


def initialize_distributed(coordinator_address: str, num_processes: int,
                           process_id: int, backend: str,
                           device=None) -> torch.device:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id`` (TCP rendezvous at ``coordinator_address``, host:port,
    which rank 0 serves; collectives fail after ``comm.TIMEOUT``) and
    return this rank's device: on CUDA card ``process_id`` modulo the
    cards (ranks beyond the count share cards), made current."""
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda",
                              process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return device


def free_port() -> int:
    """A TCP port of localhost that no socket holds right now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(fn, n_ranks: int, args=(), backend: str = "gloo", device=None,
          timeout: float | None = None) -> list:
    """Run ``fn(device, *args)`` in ``n_ranks`` fresh processes that form
    one process group (rendezvous on a free localhost port), each on one
    intra-op thread, on ``device`` (default CUDA; raises without it), and
    return each rank's return value in rank order. ``fn`` and its
    arguments and results must pickle (``fn`` a function of a module). A
    rank that raises or dies fails the call, and so does a run past
    ``timeout`` seconds where one is given (a mismatch of collectives
    already fails after ``comm.TIMEOUT``); every rank is stopped before
    it returns."""
    device = resolve_device(device)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    address = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, args, address, n_ranks, rank, backend, device, results))
        for rank in range(n_ranks)]
    for p in procs:
        p.start()
    out = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while len(out) < n_ranks:
            left = 1.0 if deadline is None else deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n_ranks} ranks of {fn.__name__} ran "
                                   f"past {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"ranks {dead} of {fn.__name__} died "
                                       f"without a result") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {fn.__name__} "
                                   f"failed:\n{value}")
            out[rank] = pickle.loads(value)
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(n_ranks)]


def _rank_main(fn, args, address, n_ranks, rank, backend, device, results):
    """One rank of ``spawn``: join, run ``fn``, report, leave."""
    torch.set_num_threads(1)
    try:
        dev = initialize_distributed(address, n_ranks, rank, backend, device)
        try:
            value = fn(dev, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    # pickled here, by value: the queue's own pickler would pass a
    # tensor's storage by a handle of this process, which ends now
    results.put((rank, True, pickle.dumps(value)))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="pdmpc_torch.parallel.multihost")
    parser.add_argument("--coordinator", required=True,
                        help="host:port of process 0")
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument("--process-id", type=int, required=True)
    parser.add_argument("--backend", choices=["nccl", "gloo"],
                        required=True)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("rest", nargs=argparse.REMAINDER,
                        help="arguments forwarded to pdmpc_torch.main")
    args = parser.parse_args(argv)

    device = initialize_distributed(args.coordinator, args.num_processes,
                                    args.process_id, args.backend,
                                    args.device)
    try:
        from pdmpc_torch.main import cli

        rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
        return cli(rest + ["--computation-mode", "parallel_physically",
                           "--device", str(device)])
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
