"""Deterministic result paths and experiment memoization.

Torch twin of pdmpc_tpu/utils/filenames.py. Reference:
utility/FileNameConstructor.m: results under
``results/<scenario>_<NN>veh/<priority>/yymmdd-HHMMSS`` and
``load_latest(options)``, which finds the newest result whose saved
options equal the requested ones (Config.isequal), the whole-experiment
memoization of the eval sweeps (eval_experiments.m:72-76). Either
package's results serve (``ExperimentResult.save`` writes the same
files).
"""

from __future__ import annotations

import glob
import json
import os

from pdmpc_torch.config import Config

RESULTS_ROOT = os.environ.get("PDMPC_RESULTS_DIR", "results")


def results_directory(options: Config, root: str | None = None) -> str:
    """results/<scenario_type>_<amount>veh/<priority>/ (reference
    layout)."""
    return os.path.join(
        root or RESULTS_ROOT,
        f"{options.scenario_type.value}_{options.amount:02d}veh",
        options.priority.value)


def load_latest(options: Config, root: str | None = None):
    """The newest saved ExperimentResult with equal options, or None
    (FileNameConstructor.load_latest, :146-177). A result saved as
    partial (a truncated run) is never served."""
    from pdmpc_torch.experiment import ExperimentResult

    directory = results_directory(options, root)
    for meta_path in sorted(glob.glob(os.path.join(directory, "*.json")),
                            reverse=True):
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            saved = Config.from_json_dict(meta["config"])
        except (json.JSONDecodeError, KeyError, ValueError):
            continue
        if not meta.get("partial") and saved.isequal(options):
            return ExperimentResult.load(meta_path[: -len(".json")])
    return None

