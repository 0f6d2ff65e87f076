"""Communication abstraction: the distributed backend of the framework.

Torch twin of pdmpc_tpu/parallel/comm.py. The reference exchanges
Traffic/Predictions/SolutionCost messages over ROS 2 topics
(InterHlcCommunication.m:140-236), each a blocking read; here every such
read is the implicit synchronization of a ``torch.distributed``
collective over the vehicle group:

- Traffic broadcast + read barrier -> one ``all_gather`` of the traffic
  tensors (``gather_tree``);
- per-level Predictions exchange   -> ``all_gather`` of the planned areas
  after each computation level (``gather_veh``);
- SolutionCost voting              -> ``all_gather`` of the candidates'
  costs, or ``psum``.

``LocalComm`` is the single-program identity backend (the
PrioritizedSequentialController semantics); ``MeshComm`` splits the
vehicles over the ranks of a process group. The step's tensors carry the
scenario dim first, so the vehicle dim of an exchanged tensor is dim 1:
[B, n_local, ...].
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist

# How long a rank waits in a collective before it fails: ranks that call
# different collectives (a mismatch) fail after it instead of hanging.
TIMEOUT = timedelta(seconds=300)


class LocalComm:
    """All vehicles in one program: gathers and slices are the identity."""

    def __init__(self, n_vehicles: int):
        self.n_vehicles = n_vehicles

    @property
    def n_local(self) -> int:
        """Vehicles this program plans: all of them."""
        return self.n_vehicles

    def global_indices(self, device=None) -> torch.Tensor:
        """The global index of each local vehicle."""
        return torch.arange(self.n_vehicles, device=device)

    def gather_tree(self, tree):
        """Every vehicle's entries of each tensor in ``tree``."""
        return tree

    def gather_veh(self, x):
        """Every vehicle's entries of ``x`` (vehicle dim 1)."""
        return x

    def local_slice(self, x):
        """This program's vehicles' entries of the global ``x``."""
        return x

    def psum(self, x):
        """The sum of ``x`` over the programs: ``x``."""
        return x


def all_gather_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` concatenated along ``dim`` in rank
    order: one collective (``all_gather_into_tensor``) into
    [R, *x.shape], the rank dim then moved next to ``dim``."""
    size = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    out = out.reshape(size, *x.shape).movedim(0, dim)
    return out.reshape(*x.shape[:dim], size * x.shape[dim],
                       *x.shape[dim + 1:])


class MeshComm:
    """Vehicle-sharded backend on a ``torch.distributed`` process group:
    rank r of ``group`` plans global vehicles r * n_local to
    (r + 1) * n_local - 1. Every rank of the group must call each
    collective method in the same order: a rank that skips one makes the
    others wait until the group's timeout."""

    def __init__(self, n_vehicles: int, group=None):
        self.n_vehicles = n_vehicles
        self.group = group
        self.axis_size = dist.get_world_size(group)
        self.axis_index = dist.get_rank(group)
        if n_vehicles % self.axis_size:
            raise ValueError(f"n_vehicles={n_vehicles} does not divide over "
                             f"{self.axis_size} ranks")
        self.n_local = n_vehicles // self.axis_size

    def global_indices(self, device=None) -> torch.Tensor:
        return self.axis_index * self.n_local + torch.arange(
            self.n_local, device=device)

    def gather_veh(self, x: torch.Tensor) -> torch.Tensor:
        """[B, n_local, ...] -> [B, N, ...]."""
        return all_gather_dim(x, 1, self.group)

    def gather_tree(self, tree):
        """ONE fused all_gather for a tuple of [B, n_local, ...] tensors
        (None entries pass through): the reference's Traffic topic is one
        message carrying every per-vehicle field. Each tensor is
        flattened to [B, n_local, K_i] and cast to f32, they are
        concatenated, gathered once and unpacked. The integers exchanged
        are trim, lanelet and priority indices and the booleans flags, all
        exact in f32, so the values equal those of per-field gathers."""
        leaves = [x for x in tree if x is not None]
        widths = [x[0, 0].numel() for x in leaves]
        packed = torch.cat([x.reshape(*x.shape[:2], -1).to(torch.float32)
                            for x in leaves], dim=-1)
        g = self.gather_veh(packed)                      # [B, N, sum K_i]
        out = iter(
            seg.to(x.dtype).reshape(x.shape[0], self.n_vehicles,
                                    *x.shape[2:])
            for x, seg in zip(leaves, g.split(widths, dim=-1)))
        return tuple(None if x is None else next(out) for x in tree)

    def local_slice(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, ...] -> this rank's [B, n_local, ...]."""
        return x.narrow(1, self.axis_index * self.n_local, self.n_local)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the group's ranks."""
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out
