"""Dissertation evaluation driver — the eval/eval_phd capability.

Torch twin of pdmpc_tpu/eval/phd.py. Reference: eval/eval_phd/
eval_phd.m:1-80 — run the prioritization and bounding sweeps, then
reproduce the headline values.txt numbers: the
median/max per-step networked-control-system time of the CPM lab
experiment, skipping the first steps where warm-up dominates
(eval_phd.m:41-48 drops steps before i_step_start=21). ``python -m
pdmpc_torch.eval.run_phd`` runs it on the card.
"""

from __future__ import annotations

import os

import numpy as np

from pdmpc_torch.eval.processing import data_time_experiment
from pdmpc_torch.utils.filenames import RESULTS_ROOT


def compute_values(result, i_step_start: int = 20) -> dict:
    """Median/max step time [ms] after the warm-up prefix.

    Reference: eval_phd.m:41-52 (``t_cpm_lab = t(i_step_start:end)`` then
    median/max). ``i_step_start`` is 0-based here (reference is 1-based
    21); on the card the analogous warm-up is the first step, which builds
    the kernels' library and fills the allocator's cache.
    """
    times = data_time_experiment(result)
    if len(times) > i_step_start:
        times = times[i_step_start:]
    times = times[np.isfinite(times)]
    if times.size == 0:
        raise ValueError(
            "compute_values: no finite step times after the warm-up prefix "
            f"(i_step_start={i_step_start}) — the result has too few steps "
            "or its timing spans are all NaN"
        )
    return {
        "med_ms": float(np.median(times) * 1e3),
        "max_ms": float(np.max(times) * 1e3),
        "n_steps_used": int(len(times)),
    }


def write_values_txt(result, path: str | None = None,
                     i_step_start: int = 20,
                     label: str = "CPM Lab") -> str:
    """Write the values.txt summary line.

    Reference: eval_phd.m:54-66 writes
    ``"CPM Lab -- max: %5.2f ms -- med: %5.2f ms"`` to
    <all_results>/phd/values.txt; the default path here is
    <RESULTS_ROOT>/phd_torch/values.txt (``results/phd/`` holds the JAX
    package's).
    """
    vals = compute_values(result, i_step_start=i_step_start)
    if path is None:
        path = os.path.join(RESULTS_ROOT, "phd_torch", "values.txt")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(
            f"{label} -- max: {vals['max_ms']:5.2f} ms"
            f" -- med: {vals['med_ms']:5.2f} ms\n"
        )
    return path


def eval_phd(cpm_lab_result=None, run_sweeps: bool = False,
             out_path: str | None = None,
             sweep_base=None, sweep_kw: dict | None = None,
             sweep_bounds=None) -> dict:
    """Full dissertation evaluation.

    Reference: eval_phd.m:9-31 (eval_prioritization + eval_bounding for
    commonroad and circle — the circle arms at Hp=10 — under the sampled
    optimizer) followed by the CPM-lab values.txt block. Sweeps are opt-in
    here (they are long); ``sweep_base`` / ``sweep_kw`` (forwarded to
    eval_experiments: n_vehicles_list, seeds, use_cache, save, root,
    device) / ``sweep_bounds`` scale them down for CI. The values block needs a
    result from the headline scenario.
    """
    out: dict = {}
    if run_sweeps:
        import dataclasses

        from pdmpc_torch.config import (
            Config, OptimizerType, ScenarioType,
        )
        from pdmpc_torch.eval.experiments import (
            eval_bounding, eval_prioritization,
        )

        base = sweep_base or Config(optimizer_type=OptimizerType.TpuSampled)
        circle = dataclasses.replace(
            base, scenario_type=ScenarioType.circle, Hp=10, path_ids=()
        )
        kw = dict(sweep_kw or {})
        bkw = dict(kw)
        if sweep_bounds is not None:
            bkw["bounds"] = sweep_bounds
        out["prioritization_commonroad"] = eval_prioritization(base, **kw)
        out["prioritization_circle"] = eval_prioritization(circle, **kw)
        out["bounding_commonroad"] = eval_bounding(base, **bkw)
        out["bounding_circle"] = eval_bounding(circle, **bkw)

    if cpm_lab_result is not None:
        out["values"] = compute_values(cpm_lab_result)
        out["values_txt"] = write_values_txt(cpm_lab_result, path=out_path)
    return out
