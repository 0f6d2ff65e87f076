"""Plant layer: the environment abstraction.

Torch twin of pdmpc_tpu/plant.py (numpy only). Reference: plant/Plant.m
(abstract measure / apply / should_stop / end_run /
synchronize_start_with_plant, :45-50), plant/Simulation.m,
plant/CpmLab.m, plant/PlantMeasurement.m.

Two backends:

- :class:`SimulationPlant` — perfect-execution simulator: ``apply``
  teleports the state to the first predicted pose and trim
  (Simulation.m:86-117); the step's own apply does the same inside
  ``experiment.run_experiment``, so this plant exists for the host-driven
  loop (``hlc.run_with_plant``) with per-step host access.
- :class:`ExternalPlant` — the CpmLab-shaped adapter: measurements come
  from outside (lab middleware, another process), commands go out as
  Hp-step trajectory points with timestamps (the VehicleCommandTrajectory
  capability, CpmLab.m:230-284).

``apply`` of both takes the applied trims' speeds and steering angles as
keywords, so the host loop calls every plant alike. An external plant's
newest trajectory point carries the commanded heading and steering angle
beside the lab's (px, py, vx, vy): a perfect-execution plant process
(``plant_bridge``) restores the planned state from them exactly, where
the heading from atan2(vy, vx) loses its turns and a vehicle at standstill
its heading, and the steering angle is not in the lab's message at all.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Protocol

import numpy as np

from pdmpc_torch.config import Config, Environment


@dataclass
class PlantMeasurement:
    """Reference: plant/PlantMeasurement.m (x, y, yaw, speed, steering)."""

    x: np.ndarray          # [N]
    y: np.ndarray          # [N]
    yaw: np.ndarray        # [N]
    speed: np.ndarray      # [N]
    steering: np.ndarray   # [N]

    @property
    def poses(self) -> np.ndarray:
        return np.stack([self.x, self.y, self.yaw], axis=-1)


class Plant(Protocol):
    """Abstract plant interface (plant/Plant.m:45-50)."""

    def measure(self) -> PlantMeasurement: ...

    def apply(self, predicted_poses: np.ndarray,
              predicted_trims: np.ndarray, k: int,
              trim_speeds: np.ndarray | None = None,
              trim_steerings: np.ndarray | None = None) -> None: ...

    def should_stop(self) -> bool: ...

    def end_run(self) -> None: ...

    def synchronize_start_with_plant(self) -> None: ...

    def get_step_time(self) -> float: ...


def get_plant(options: Config, **kwargs) -> "Plant":
    """Plant factory. Reference: Plant.get_plant (plant/Plant.m:25-41)."""
    if options.environment == Environment.simulation:
        return SimulationPlant(options, **kwargs)
    return ExternalPlant(options, **kwargs)


class SimulationPlant:
    """Perfect-execution simulation. Reference: plant/Simulation.m.

    ``apply`` sets the state to the first predicted pose and trim — no
    online ODE integration; the dynamics live entirely in the MPA
    (Simulation.m:86-117).
    """

    def __init__(self, options: Config, start_poses: np.ndarray,
                 start_speeds: np.ndarray | None = None):
        self.options = options
        n = start_poses.shape[0]
        self._poses = np.asarray(start_poses, dtype=np.float64).copy()
        self._speeds = (
            np.zeros(n) if start_speeds is None
            else np.asarray(start_speeds, dtype=np.float64).copy()
        )
        self._steering = np.zeros(n)
        self.k = 0
        self._stopped = False

    def measure(self) -> PlantMeasurement:
        return PlantMeasurement(
            x=self._poses[:, 0].copy(),
            y=self._poses[:, 1].copy(),
            yaw=self._poses[:, 2].copy(),
            speed=self._speeds.copy(),
            steering=self._steering.copy(),
        )

    def apply(self, predicted_poses: np.ndarray,
              predicted_trims: np.ndarray, k: int,
              trim_speeds: np.ndarray | None = None,
              trim_steerings: np.ndarray | None = None) -> None:
        self._poses = np.asarray(predicted_poses)[:, 0, :].astype(np.float64)
        if trim_speeds is not None:
            self._speeds = np.asarray(trim_speeds, dtype=np.float64).copy()
        if trim_steerings is not None:
            self._steering = np.asarray(trim_steerings,
                                        dtype=np.float64).copy()
        self.k = k + 1

    def should_stop(self) -> bool:
        # end-of-run sentinel semantics (Simulation.m:164-173)
        return self._stopped or self.k >= self.options.k_end

    def end_run(self) -> None:
        self._stopped = True

    def synchronize_start_with_plant(self) -> None:
        pass

    def get_step_time(self) -> float:
        return self.options.dt_seconds


# CPM-lab map limits for the border stop check
# (CpmLab.is_veh_at_map_border, CpmLab.m:301-316)
_MAP_X = (0.0, 4.5)
_MAP_Y = (0.0, 4.0)
_VEHICLE_HALF_WIDTH = 0.05


class ExternalPlant:
    """CpmLab-shaped adapter for an external plant.

    The user supplies ``measure_fn`` and ``command_fn`` callbacks (the role
    of the lab's DDS readers and writers, CpmLab.m:318-332). ``apply``
    keeps an (Hp+1)-point trajectory ring buffer per vehicle: each step
    shifts the buffer by one and appends the newly applied pose stamped
    ``Hp`` periods into the future — the vehicle follows commands with the
    reference's Hp-1-step delay (CpmLab.m:230-284, "Delay of Hp-1 steps
    because of buffer"). ``valid_after`` is the second buffered point's
    stamp (CpmLab.m:278-280), and a vehicle whose 4th buffered point
    leaves the map borders stops the experiment (is_veh_at_map_border,
    CpmLab.m:301-316). The middleware period may override ``dt_seconds``
    (CpmLab.m:76).
    """

    def __init__(self, options: Config,
                 measure_fn: Callable[[], PlantMeasurement],
                 command_fn: Callable[[list[dict]], None] | None = None,
                 middleware_period_s: float | None = None,
                 stop_fn: Callable[[], bool] | None = None):
        self.options = options
        self._measure_fn = measure_fn
        self._command_fn = command_fn or (lambda cmds: None)
        self._stop_fn = stop_fn or (lambda: False)
        self._dt = (
            middleware_period_s
            if middleware_period_s is not None
            else options.dt_seconds
        )
        self.time_now_ns = 0
        self._stopped = False
        self._buffers: list[list[dict]] | None = None
        self.out_of_map_limits: np.ndarray | None = None

    def measure(self) -> PlantMeasurement:
        self.time_now_ns += int(self._dt * 1e9)
        return self._measure_fn()

    def _init_buffers(self, predicted_poses: np.ndarray) -> None:
        """Pre-fill each buffer with the first applied pose at standstill
        (the lab equivalent starts from standstill at the measured
        pose)."""
        n, hp = predicted_poses.shape[:2]
        dt_ns = int(self._dt * 1e9)
        self._buffers = []
        for v in range(n):
            self._buffers.append([
                {
                    "t_ns": self.time_now_ns + i * dt_ns,
                    "px": float(predicted_poses[v, 0, 0]),
                    "py": float(predicted_poses[v, 0, 1]),
                    "vx": 0.0,
                    "vy": 0.0,
                    "yaw": float(predicted_poses[v, 0, 2]),
                    "steering": 0.0,
                }
                for i in range(hp + 1)
            ])
        self.out_of_map_limits = np.zeros(n, dtype=bool)

    def apply(self, predicted_poses: np.ndarray,
              predicted_trims: np.ndarray, k: int,
              trim_speeds: np.ndarray | None = None,
              trim_steerings: np.ndarray | None = None) -> None:
        n, hp = predicted_poses.shape[:2]
        speeds = (
            np.zeros(n) if trim_speeds is None else np.asarray(trim_speeds)
        )
        steerings = (
            np.zeros(n) if trim_steerings is None
            else np.asarray(trim_steerings)
        )
        if self._buffers is None:
            self._init_buffers(predicted_poses)
        dt_ns = int(self._dt * 1e9)
        commands = []
        for v in range(n):
            # circshift by -1, append the new point Hp periods ahead
            # (CpmLab.m:252-269)
            buf = self._buffers[v]
            buf.pop(0)
            yaw_next = float(predicted_poses[v, 0, 2])
            buf.append({
                "t_ns": self.time_now_ns + hp * dt_ns,
                "px": float(predicted_poses[v, 0, 0]),
                "py": float(predicted_poses[v, 0, 1]),
                "vx": float(np.cos(yaw_next) * speeds[v]),
                "vy": float(np.sin(yaw_next) * speeds[v]),
                "yaw": yaw_next,
                "steering": float(steerings[v]),
            })
            # map-border check on the 4th buffered point (CpmLab.m:311-315)
            probe = buf[3] if len(buf) > 3 else buf[-1]
            self.out_of_map_limits[v] = (
                probe["px"] < _MAP_X[0] + _VEHICLE_HALF_WIDTH
                or probe["px"] > _MAP_X[1] - _VEHICLE_HALF_WIDTH
                or probe["py"] < _MAP_Y[0] + _VEHICLE_HALF_WIDTH
                or probe["py"] > _MAP_Y[1] - _VEHICLE_HALF_WIDTH
            )
            commands.append({
                "vehicle": v,
                "points": [dict(p) for p in buf],
                "valid_after_ns": buf[1]["t_ns"],
            })
        self._command_fn(commands)

    def should_stop(self) -> bool:
        if self.out_of_map_limits is not None and self.out_of_map_limits.any():
            return True
        return self._stopped or self._stop_fn()

    def end_run(self) -> None:
        self._stopped = True

    def synchronize_start_with_plant(self) -> None:
        # ready/start handshake hook (CpmLab.synchronize_start_with_plant,
        # :137-162); external bridges override by waiting in measure_fn
        self.time_now_ns = int(time.time() * 1e9)

    def get_step_time(self) -> float:
        return self._dt
