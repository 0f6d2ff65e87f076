"""Result post-processing — the eval/2-processing capability.

Torch twin of pdmpc_tpu/eval/processing.py (numpy only). Reference:
eval/2-processing/: merge_experiment_results.m (distributed per-vehicle
results -> one result; here results are born merged),
normalize_timing_results.m (cross-machine clock alignment; single-program
runs share one clock so it reduces to identity but the entry point exists
for multi-host timing structs), is_deadlock.m, compute_deadlock_free_runtime,
per-step cost/time extraction (data_*.m, data_time_experiment.m,
compute_levels_data.m). numpy only: it runs where matplotlib is not
installed (the card's hosts), so ``data_time_experiment``, which
pdmpc_tpu keeps in eval/plotting.py, lives here.
"""

from __future__ import annotations

import numpy as np

from pdmpc_torch.controller import StepInfo
from pdmpc_torch.experiment import ExperimentResult, is_deadlock


def compute_deadlock_free_runtime(result: ExperimentResult) -> float:
    """Seconds until the first deadlock (or the full duration).

    Reference: eval/2-processing/compute_deadlock_free_runtime.m.
    """
    options = result.options
    poses = np.asarray(result.infos.poses)[:, :, 0, :2]
    moved = np.linalg.norm(np.diff(poses, axis=0), axis=-1) > 1e-6
    threshold = 3 * options.Hp
    k_end = poses.shape[0]
    run = np.zeros(poses.shape[1], dtype=int)
    for k in range(moved.shape[0]):
        run = np.where(moved[k], 0, run + 1)
        if (run >= threshold).any():
            return (k + 1 - threshold) * options.dt_seconds
    return k_end * options.dt_seconds


def data_cost_per_step(result: ExperimentResult) -> np.ndarray:
    """Total solution cost per step [k_end] (data_cost capability)."""
    return np.asarray(result.infos.cost).sum(axis=-1)


def data_fallback_rate(result: ExperimentResult) -> float:
    fb = np.asarray(result.infos.needs_fallback)
    return float(fb.mean())


def compute_levels_data(result: ExperimentResult) -> dict:
    """Computation-level statistics per step.

    Reference: eval/2-processing/compute_levels_data.m.
    """
    levels = np.asarray(result.infos.levels)           # [k_end, N]
    n_levels = levels.max(axis=-1)
    return {
        "n_levels_per_step": n_levels,
        "max_levels": int(n_levels.max()),
        "median_levels": float(np.median(n_levels)),
        "mean_levels": float(n_levels.mean()),
    }


def data_n_expanded(result: ExperimentResult) -> np.ndarray:
    """Search-effort statistic per step (ControlResultsInfo.n_expanded)."""
    return np.asarray(result.infos.n_expanded).sum(axis=-1)


def data_time_experiment(result) -> np.ndarray:
    """Per-step controller computation time in seconds, shape [k_end].

    Reference: eval/2-processing/data_time_experiment.m (max over vehicles
    of the per-step HLC time). Here: the ``plan`` span if the result came
    from the host-driven loop, else the mean step time from
    ``control_loop`` (``run_experiment`` records no per-step spans).
    """
    t = result.timings or {}
    if "plan" in t:
        arr = np.asarray(t["plan"], dtype=float)
        return arr[1]  # row 0 = start, row 1 = duration
    if "control_loop" in t:
        arr = np.asarray(t["control_loop"], dtype=float)
        # run_experiment stores a plain duration; the host loop stores a
        # (start, duration) column
        total = float(arr if arr.ndim == 0 else arr.reshape(-1)[-1])
        n = max(result.n_steps, 1)
        return np.full(n, total / n)
    return np.zeros(result.n_steps)


def normalize_timing_results(timings: list[dict] | dict) -> list[dict] | dict:
    """Cross-controller clock alignment.

    Reference: eval/2-processing/normalize_timing_results.m:14-60 — having
    received all messages is a (nearly) simultaneous event on every
    controller, so per-controller clocks are aligned by the least-squares
    offset of each controller's per-step ``receive_from_others`` end times
    against the across-controller mean (with a constant design matrix the
    least-squares solution IS the mean residual); ``controller_start_time``
    is reset to the fleet minimum and the applied ``offset`` is recorded.

    ``timings``: one timing struct per controller (a single struct — the
    single-program case — is returned unchanged, like the reference's
    sequential-mode early exit). Each struct maps span name ->
    [2, n_steps] (start; duration) plus scalar ``controller_start_time``.
    """
    if isinstance(timings, dict):
        return timings
    if len(timings) <= 1:
        return timings

    t_end = np.stack(
        [np.sum(np.asarray(t["receive_from_others"]), axis=0)
         for t in timings]
    )                                                   # [n_ctrl, n_steps]
    t_end_mean = np.nanmean(t_end, axis=0)
    min_start = min(t.get("controller_start_time", 0.0) for t in timings)

    out = []
    for i, t in enumerate(timings):
        offset = float(np.nanmean(t_end[i] - t_end_mean))
        norm: dict = {}
        for name, value in t.items():
            if name == "controller_start_time":
                norm[name] = min_start
            elif name == "offset":
                continue
            elif isinstance(value, np.ndarray) and value.ndim == 2:
                shifted = value.copy()
                shifted[0, :] = shifted[0, :] - offset
                norm[name] = shifted
            else:
                norm[name] = value
        norm["offset"] = offset
        out.append(norm)
    return out


def summarize(result: ExperimentResult) -> dict:
    """Headline metrics of one experiment (the values.txt content of
    eval_phd.m:51-66: median/max per-step times, plus quality metrics)."""
    costs = data_cost_per_step(result)
    out = {
        "n_steps": result.n_steps,
        "n_vehicles": result.n_vehicles,
        "total_cost": float(costs.sum()),
        "fallback_rate": data_fallback_rate(result),
        "deadlocked_vehicles": int(
            is_deadlock(result.infos, result.options).sum()
        ),
        "deadlock_free_runtime_s": compute_deadlock_free_runtime(result),
        **compute_levels_data(result),
    }
    if "control_loop" in result.timings:
        cl = result.timings["control_loop"]
        if isinstance(cl, (int, float)):
            out["step_time_mean_ms"] = cl / max(result.n_steps, 1) * 1e3
    return out


def merge_experiment_results(results: list[ExperimentResult]
                             ) -> ExperimentResult:
    """Merge per-shard results into one (merge_experiment_results.m).

    Single-program runs are born merged; this merges results whose infos
    cover disjoint vehicle index ranges (multi-process interop path).
    """
    if not results:
        raise ValueError("nothing to merge")
    if len(results) == 1:
        return results[0]
    merged_infos = StepInfo(*(np.concatenate(xs, axis=1)
                              for xs in zip(*(r.infos for r in results))))
    base = results[0]
    return ExperimentResult(
        options=base.options,
        infos=merged_infos,
        final_state=base.final_state,
        timings={f"hlc_{i}": r.timings for i, r in enumerate(results)},
        git_hash=base.git_hash,
    )
