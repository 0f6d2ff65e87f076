"""Configuration of the p-DMPC framework — the port's own copy of
pdmpc_tpu/config.py, with the same field names so JSON configs load in
both packages.

Mirrors the capability surface of the reference MATLAB config system
(``config/Config.m`` and ``config/enums/*.m``): a single options
value-class with JSON round-trip, validation, dependent properties
(``tick_per_step``, ``k_end``, ``are_any_obstacles_non_convex``) and
options-equality used for experiment memoization.

Extensions that are not in the reference are grouped at the bottom of
:class:`Config`: batched-scenario count, beam width of the trim-lattice
search, and mesh axis sizes. The reference has no analogue because it plans
one scenario at a time in per-vehicle MATLAB processes.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass, field
from typing import Any


class ScenarioType(str, enum.Enum):
    """Reference: config/enums/ScenarioType.m"""

    commonroad = "commonroad"
    circle = "circle"
    # TPU extension (BASELINE config 4; not in the reference): CPM road
    # network plus off-map free-space circle clusters in one fleet
    mixed = "mixed"


class Environment(str, enum.Enum):
    """Reference: config/enums/Environment.m (CpmLab needs lab hardware)."""

    simulation = "Simulation"
    cpm_lab = "CpmLab"


class ComputationMode(str, enum.Enum):
    """Reference: config/enums/ComputationMode.m.

    On TPU the three modes map to: ``sequential`` = single-program level loop
    (PrioritizedSequentialController semantics), ``parallel_threads`` =
    vehicle-sharded ``shard_map`` on a single host's mesh, and
    ``parallel_physically`` = multi-host mesh via ``jax.distributed``.
    """

    sequential = "sequential"
    parallel_threads = "parallel_threads"
    parallel_physically = "parallel_physically"


class CouplingStrategies(str, enum.Enum):
    """Reference: config/enums/CouplingStrategies.m"""

    no_coupling = "no_coupling"
    reachable_set_coupling = "reachable_set_coupling"
    distance_coupling = "distance_coupling"
    full_coupling = "full_coupling"


class PriorityStrategies(str, enum.Enum):
    """Reference: config/enums/PriorityStrategies.m"""

    constant_priority = "constant_priority"
    random_priority = "random_priority"
    FCA_priority = "FCA_priority"
    coloring_priority = "coloring_priority"
    explorative_priority = "explorative_priority"
    optimal_priority = "optimal_priority"


class WeightStrategies(str, enum.Enum):
    """Reference: config/enums/WeightStrategies.m"""

    constant_weight = "constant_weight"
    random_weight = "random_weight"
    distance_weight = "distance_weight"


class CutStrategies(str, enum.Enum):
    """Reference: config/enums/CutStrategies.m"""

    greedy_cut = "greedy_cut"


class OptimizerType(str, enum.Enum):
    """Reference: config/enums/OptimizerType.m.

    ``TpuOptimal`` is the layered exhaustive/beam trim-lattice search (the
    TPU-native re-design of ``MatlabOptimal`` A*); ``TpuSampled`` is the
    batched Monte-Carlo rollout variant of ``MatlabSampled`` MCTS.
    """

    TpuOptimal = "TpuOptimal"
    TpuSampled = "TpuSampled"
    # Aliases so reference JSON configs load unchanged.
    MatlabOptimal = "MatlabOptimal"
    MatlabSampled = "MatlabSampled"

    @property
    def is_optimal(self) -> bool:
        return self in (OptimizerType.TpuOptimal, OptimizerType.MatlabOptimal)


class MpaType(str, enum.Enum):
    """Reference: config/enums/MpaType.m"""

    single_speed = "single_speed"
    triple_speed = "triple_speed"
    realistic = "realistic"


class ConstraintFromSuccessor(str, enum.Enum):
    """Reference: config/enums/ConstraintFromSuccessor.m"""

    none = "none"
    area_of_standstill = "area_of_standstill"
    area_of_previous_trajectory = "area_of_previous_trajectory"


@dataclass
class ManualControlConfig:
    """HDV (human-driven vehicle) config. Reference: config/ManualControlConfig.m"""

    is_active: bool = False
    amount: int = 0
    hdv_ids: tuple[int, ...] = ()

    def to_json_dict(self) -> dict[str, Any]:
        return {
            "is_active": self.is_active,
            "amount": self.amount,
            "hdv_ids": list(self.hdv_ids),
        }

    @staticmethod
    def from_json_dict(d: dict[str, Any]) -> "ManualControlConfig":
        return ManualControlConfig(
            is_active=bool(d.get("is_active", False)),
            amount=int(d.get("amount", 0)),
            hdv_ids=tuple(int(x) for x in d.get("hdv_ids", ())),
        )


_ENUM_FIELDS = {
    "scenario_type": ScenarioType,
    "environment": Environment,
    "computation_mode": ComputationMode,
    "coupling": CouplingStrategies,
    "priority": PriorityStrategies,
    "weight": WeightStrategies,
    "cut": CutStrategies,
    "optimizer_type": OptimizerType,
    "mpa_type": MpaType,
    "constraint_from_successor": ConstraintFromSuccessor,
}

# Fields ignored by equality, like the reference's irrelevant_properties
# (Config.m:278-283). Perf-only execution knobs (level_chunk,
# use_pallas_collision) do not change trajectories — results are
# bit-identical across their settings (tests/test_controller.py,
# tests/test_pallas_collision.py) — so result memoization via
# utils/filenames.load_latest must not miss on them.
_EQUALITY_IRRELEVANT = {
    "time_per_tick",
    "is_use_dynamic_programming",
    "should_do_dry_run",
    "level_chunk",
    "unroll_layers",
    "use_pallas_collision",
}


@dataclass
class Config:
    """Single options value-class. Reference: config/Config.m:1-302.

    All reference fields keep their names so reference JSON configs load
    unchanged (except MATLAB-only fields, which are accepted and ignored).
    """

    # ---- Scenario (Config.m:6-11)
    scenario_type: ScenarioType = ScenarioType.commonroad
    amount: int = 20
    T_end: float = 20.0
    path_ids: tuple[int, ...] = ()
    start_poses: tuple[tuple[float, float, float], ...] = ()

    # ---- Environment (Config.m:15-18)
    environment: Environment = Environment.simulation
    computation_mode: ComputationMode = ComputationMode.sequential

    # ---- High-Level Controller (Config.m:22-41)
    is_prioritized: bool = True
    coupling: CouplingStrategies = CouplingStrategies.reachable_set_coupling
    priority: PriorityStrategies = PriorityStrategies.constant_priority
    weight: WeightStrategies = WeightStrategies.distance_weight
    cut: CutStrategies = CutStrategies.greedy_cut
    max_num_CLs: int = 99
    optimizer_type: OptimizerType = OptimizerType.TpuOptimal
    dt_seconds: float = 0.2
    Hp: int = 6
    mpa_type: MpaType = MpaType.single_speed
    constraint_from_successor: ConstraintFromSuccessor = (
        ConstraintFromSuccessor.area_of_standstill
    )
    manual_control_config: ManualControlConfig = field(
        default_factory=ManualControlConfig
    )
    should_do_dry_run: bool = False

    # ---- Other (Config.m:45-50)
    isDealPredictionInconsistency: bool = True
    recursive_feasibility: bool = True
    time_per_tick: float = 0.01
    offset: float = 0.01
    is_use_dynamic_programming: bool = True

    # ---- TPU-native extensions (no reference analogue)
    # Number of independent scenario rollouts evaluated in one batched program
    # (the reference plans exactly one scenario; BASELINE.json asks for 1000+).
    n_scenarios: int = 1
    # Beam width of the layered trim-lattice search. The frontier of the
    # reference's A* at Hp=6 with <=13 successors/trim fits well below 4096
    # nodes; a beam at least that wide is an exhaustive (optimal) search.
    beam_width: int = 512
    # Random seed root for seeded strategies (random priority/weights, MCTS).
    seed: int = 0
    # Static cap on enumerated priority permutations in optimal_priority
    # mode (the reference enumerates 2^edges at run time,
    # Prioritizer.unique_priorities; a fixed-shape program needs a bound).
    max_priority_permutations: int = 16
    # Rollout budget of the sampled (MCTS-equivalent) optimizer; the
    # reference spends 250 tree expansions (MonteCarloTreeSearch.m:8).
    # One rollout evaluates Hp edges exactly, so ~ceil(250/Hp) rollouts
    # match the reference budget; the default spends more because parallel
    # rollouts are nearly free on TPU.
    mcts_n_rollouts: int = 256
    # Softmax temperature (m^2) of the cost-guided rollout policy in the
    # sampled optimizer; <= 0 falls back to uniform sampling over allowed
    # successors. Too cold collapses rollout diversity (exhaustion under
    # coupling constraints), too hot approaches uniform; 0.01 measured
    # best on the 3-vehicle circle (cost within 6% of exhaustive search).
    mcts_temperature: float = 0.01
    # Compact-level planning batch (single-program path): each level-loop
    # iteration plans up to this many same-level vehicles as one batch,
    # so every vehicle is planned exactly once per step instead of the
    # dense all-vehicles-every-level sweep. None = 2, the measured cr20
    # optimum (padded chunk slots burn a full planning pass, so narrow
    # chunks waste the least work; sweep on v5e after the round-4 sort-
    # payload coupling fix: 2 -> 7.2 ms step median, 3 -> 7.6, 4 -> 8.6;
    # pre-fix: 5 -> 10.9, 10 -> 14.8, 20 -> 27.4).
    # Purely a scheduling knob — results are identical at any value.
    level_chunk: int | None = None
    # Unroll the saturated-layer tail of the beam search (None = True).
    # Straight-line layers remove ~0.2 ms/chunk of scan carry staging —
    # best for single-rollout latency — but keep every layer's candidate
    # buffers live at once (~10 MB temp per rollout lane at beam 256), so
    # LARGE batched rollouts run out of HBM headroom; False switches the
    # tail to lax.scan. Purely an execution knob — results identical.
    unroll_layers: bool | None = None
    # Pallas TPU kernel for the SAT collision mask (None = auto: on for TPU
    # backends, off for CPU). The kernel avoids materializing the
    # [candidates x obstacles x axes x vertices] projection tensor in HBM
    # and runs ~3x faster than the f32-precision XLA path (microbench:
    # C=3072, 128 obstacles, v5e).
    use_pallas_collision: bool | None = None
    # Obstacle-geometry dispatch override. "auto" follows the reference's
    # rule (are_any_obstacles_non_convex, Config.m:71-87: road scenarios
    # use the non-convex maneuver family checked by outline/segment
    # intersection, OptimizerInterface.m:36-46; circle + centralized use
    # convex SAT). "convex" / "non_convex" force one family — used to
    # measure the conservatism delta between the two paths (docs/PARITY.md).
    obstacle_geometry: str = "auto"

    # ---- Dependent properties (Config.m:53-101)
    @property
    def tick_per_step(self) -> int:
        return int(round(self.dt_seconds / self.time_per_tick))

    @property
    def k_end(self) -> int:
        return int(self.T_end / self.dt_seconds)

    @property
    def are_any_obstacles_non_convex(self) -> bool:
        # Reference: Config.m:71-87. Circle scenarios and centralized planning
        # use convex maneuver areas + SAT; road scenarios use non-convex
        # reachable sets checked with segment intersection.
        if self.scenario_type == ScenarioType.circle or not self.is_prioritized:
            return False
        return True

    @property
    def use_non_convex_obstacles(self) -> bool:
        """Effective obstacle-geometry dispatch (honors the override)."""
        if self.obstacle_geometry == "convex":
            return False
        if self.obstacle_geometry == "non_convex":
            return True
        return self.are_any_obstacles_non_convex

    # ---- JSON round-trip (Config.m:104-195)
    def to_json_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, enum.Enum):
                v = v.value
            elif isinstance(v, ManualControlConfig):
                v = v.to_json_dict()
            elif isinstance(v, tuple):
                v = [list(x) if isinstance(x, tuple) else x for x in v]
            d[f.name] = v
        # dependent properties are encoded like the reference does
        d["tick_per_step"] = self.tick_per_step
        d["k_end"] = self.k_end
        d["are_any_obstacles_non_convex"] = self.are_any_obstacles_non_convex
        return d

    def save_to_file(self, file_name: str = "Config.json") -> None:
        with open(file_name, "w") as f:
            json.dump(self.to_json_dict(), f, indent=2)

    @staticmethod
    def from_json_dict(d: dict[str, Any]) -> "Config":
        kwargs: dict[str, Any] = {}
        names = {f.name for f in dataclasses.fields(Config)}
        for key, value in d.items():
            if key not in names:
                continue  # dependent/MATLAB-only fields: accepted and ignored
            if key in _ENUM_FIELDS:
                kwargs[key] = _ENUM_FIELDS[key](value)
            elif key == "manual_control_config":
                kwargs[key] = ManualControlConfig.from_json_dict(value)
            elif key == "path_ids":
                kwargs[key] = tuple(int(x) for x in value)
            elif key == "start_poses":
                kwargs[key] = tuple(tuple(float(y) for y in x) for x in value)
            else:
                kwargs[key] = value
        return Config(**kwargs)

    @staticmethod
    def load_from_file(json_file_path: str) -> "Config":
        assert json_file_path.endswith(".json"), "Input must be a json file!"
        with open(json_file_path) as f:
            return Config.from_json_dict(json.load(f))

    # ---- Validation (Config.m:197-263)
    def validate(self) -> "Config":
        cfg = dataclasses.replace(self)
        if cfg.environment == Environment.cpm_lab:
            assert cfg.is_prioritized, (
                "You are trying to run a centralized controller in the lab!"
            )
        cfg.max_num_CLs = min(cfg.max_num_CLs, cfg.amount)

        if cfg.scenario_type == ScenarioType.commonroad:
            if not cfg.path_ids:
                defaults = {
                    1: (18,),
                    2: (18, 20),
                    3: (18, 19, 20),
                    4: (17, 18, 19, 20),
                }
                if cfg.amount in defaults:
                    cfg.path_ids = defaults[cfg.amount]
                else:
                    cfg.path_ids = cfg.randomize_path_ids()
            assert len(cfg.path_ids) == cfg.amount, (
                f"Amount of path_ids ({len(cfg.path_ids)}) does not match "
                f"amount of vehicles ({cfg.amount})!"
            )
            assert len(cfg.path_ids) == len(set(cfg.path_ids)), (
                "Path_ids must be unique!"
            )

        if not cfg.manual_control_config.is_active:
            cfg.manual_control_config = ManualControlConfig()
        else:
            mcc = cfg.manual_control_config
            assert len(mcc.hdv_ids) == mcc.amount, (
                f"Amount of hdv_ids ({len(mcc.hdv_ids)}) does not match "
                f"amount of manual vehicles ({mcc.amount})!"
            )
        return cfg

    def randomize_path_ids(self, seed: int | None = None,
                           enforce_crossing_intersection: bool = True
                           ) -> tuple[int, ...]:
        """Reference: Config.m:127-152 (sampled without replacement)."""
        import numpy as np

        path_id_max = 41
        lo = 9 if enforce_crossing_intersection else 1
        possible = np.arange(lo, path_id_max + 1)
        rng = np.random.default_rng(self.seed if seed is None else seed)
        ids = rng.choice(possible, size=self.amount, replace=False)
        return tuple(int(x) for x in np.sort(ids))

    # ---- Options equality for result memoization (Config.m:265-298)
    def isequal(self, other: "Config") -> bool:
        for f in dataclasses.fields(self):
            if f.name in _EQUALITY_IRRELEVANT:
                continue
            if getattr(self, f.name) != getattr(other, f.name):
                return False
        return True
