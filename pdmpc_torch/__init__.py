"""pdmpc_torch — the PyTorch/CUDA port of pdmpc_tpu for one NVIDIA H100.

The same prioritized distributed MPC (motion-primitive receding-horizon
planning, coupling-graph prioritization, per-level planning), written as
eager PyTorch on tensors with leading batch dims, plus hand-written CUDA
kernels for the collision checks of the beam search (``csrc/``).

Numerics: float32 throughout, TF32 off (the reference forces full f32
precision wherever a contraction feeds a discrete decision).
"""

import torch

from pdmpc_torch.config import (
    ComputationMode,
    Config,
    ConstraintFromSuccessor,
    CouplingStrategies,
    CutStrategies,
    Environment,
    ManualControlConfig,
    MpaType,
    OptimizerType,
    PriorityStrategies,
    ScenarioType,
    WeightStrategies,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent —
    there is no silent CPU fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pdmpc_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU explicitly"
        )
    return device


__all__ = [
    "Config",
    "ComputationMode",
    "ConstraintFromSuccessor",
    "CouplingStrategies",
    "CutStrategies",
    "Environment",
    "ManualControlConfig",
    "MpaType",
    "OptimizerType",
    "PriorityStrategies",
    "ScenarioType",
    "WeightStrategies",
    "resolve_device",
]
