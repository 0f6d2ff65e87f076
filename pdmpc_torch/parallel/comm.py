"""Communication abstraction: the distributed backend of the framework.

Torch twin of pdmpc_tpu/parallel/comm.py. The reference exchanges
Traffic/Predictions/SolutionCost messages over ROS 2 topics
(InterHlcCommunication.m:140-236); the distributed backend will replace
them with torch.distributed collectives. ``LocalComm`` is the
single-program identity backend (the PrioritizedSequentialController
semantics), the only one this port has so far.
"""

from __future__ import annotations


class LocalComm:
    """All vehicles in one program: gathers and slices are the identity."""

    def __init__(self, n_vehicles: int):
        self.n_vehicles = n_vehicles

    @property
    def n_local(self) -> int:
        """Vehicles this program plans: all of them."""
        return self.n_vehicles

    def gather_tree(self, tree):
        """Every vehicle's entries of each tensor in ``tree``."""
        return tree

    def gather_veh(self, x):
        """Every vehicle's entries of ``x`` (leading vehicle dim)."""
        return x

    def local_slice(self, x):
        """This program's vehicles' entries of the global ``x``."""
        return x
