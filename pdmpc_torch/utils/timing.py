"""Named-span timing registry.

Torch twin of pdmpc_tpu/utils/timing.py's ``ControllerTiming``.
Reference: hlc/controller/common/ControllerTiming.m: named start/stop
spans recorded per time step as (start, duration) against a shared
reference clock, plus once-only timers and a posix start time for
cross-machine normalization (eval/2-processing/
normalize_timing_results.m aligns clocks offline). The span names of the
reference's main path (HighLevelController.m:169,315,380-391):

  hlc_init_all, control_loop, measure, analyze_reachability,
  receive_from_others, couple, prioritize, weigh, cut, group, plan,
  optimize, publish_predictions, receive_fallback

In the port, ``main``'s vehicle-sharded run times its once-only spans
(hlc_init_all, control_loop) here; the per-step spans have no caller yet.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ControllerTiming:
    """Per-step named timers. Reference: ControllerTiming.m."""

    n_steps_hint: int = 0
    controller_start_time: float = field(default_factory=time.time)
    _t0: float = field(default_factory=time.perf_counter)
    _per_step: dict[str, list[tuple[int, float, float]]] = field(
        default_factory=dict)
    _once: dict[str, tuple[float, float]] = field(default_factory=dict)
    _open: dict[str, tuple[int | None, float]] = field(default_factory=dict)

    def start(self, name: str, step: int | None = None) -> None:
        self._open[name] = (step, time.perf_counter() - self._t0)

    def stop(self, name: str) -> None:
        step, start = self._open.pop(name)
        duration = (time.perf_counter() - self._t0) - start
        if step is None:
            self._once[name] = (start, duration)
        else:
            self._per_step.setdefault(name, []).append(
                (step, start, duration))

    @contextlib.contextmanager
    def span(self, name: str, step: int | None = None):
        self.start(name, step)
        try:
            yield
        finally:
            self.stop(name)

    def get_all_timings(self) -> dict:
        """Timing struct (ControllerTiming.get_all_timings): once-only
        spans as [[start], [duration]], per-step ones as [2, n_steps]
        (NaN where a step has none)."""
        out: dict = {"controller_start_time": self.controller_start_time}
        for name, (start, duration) in self._once.items():
            out[name] = np.array([[start], [duration]])
        for name, entries in self._per_step.items():
            n = max(e[0] for e in entries) + 1
            arr = np.full((2, n), np.nan)
            for step, start, duration in entries:
                arr[0, step] = start
                arr[1, step] = duration
            out[name] = arr
        return out
