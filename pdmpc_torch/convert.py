"""Carry the reference package's tables into the port's tensors.

For this system the "weights" are the MPA tables and the scenario/road
tensors. These helpers take them field by field as numpy arrays (for
example ``{k: np.asarray(v) for k, v in mpa_tensors._asdict().items()}``)
and return the port's NamedTuples on a device, so both packages can
compute on identical tables. Floats and flags keep their values and
dtypes; integer index fields become int64.
"""

from __future__ import annotations

import numpy as np
import torch

from pdmpc_torch.models.mpa import MpaTensors
from pdmpc_torch.scenarios.scenario import RoadTensors, ScenarioTensors


def _tensor(a, device):
    if a is None:
        return None
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    # a copy: arrays taken from JAX are read-only
    return torch.tensor(a, device=device)


def mpa_from_numpy(arrays: dict, device="cuda") -> MpaTensors:
    """MpaTensors from a dict of its fields as numpy arrays."""
    return MpaTensors(**{f: _tensor(arrays[f], device)
                         for f in MpaTensors._fields})


def scenario_from_numpy(arrays: dict, device="cuda") -> ScenarioTensors:
    """ScenarioTensors from a dict of its fields as numpy arrays; ``road``
    is itself such a dict of RoadTensors fields (or None)."""
    road = arrays.get("road")
    fields = {f: _tensor(arrays.get(f), device)
              for f in ScenarioTensors._fields if f != "road"}
    fields["road"] = (None if road is None else
                      RoadTensors(**{f: _tensor(road[f], device)
                                     for f in RoadTensors._fields}))
    return ScenarioTensors(**fields)
