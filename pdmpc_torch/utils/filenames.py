"""Deterministic result paths and experiment memoization.

Torch twin of pdmpc_tpu/utils/filenames.py. Reference:
utility/FileNameConstructor.m: results under
``results/<scenario>_<NN>veh/<priority>/yymmdd-HHMMSS`` and
``load_latest(options)``, which finds the newest result whose saved
options equal the requested ones (Config.isequal), the whole-experiment
memoization of the eval sweeps (eval_experiments.m:72-76). Either
package loads the other's results (``ExperimentResult.save`` writes the
same files), but ``load_latest`` serves only this package's: a result of
pdmpc_tpu's, which may hold the TPU's timings, is never served as the
port's.
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
    """The newest saved ExperimentResult of this package with equal
    options, or None (FileNameConstructor.load_latest, :146-177). A
    result saved as partial (a truncated run), or saved by pdmpc_tpu (no
    ``package`` mark of this package's), is never served."""
    from pdmpc_torch.experiment import PACKAGE, ExperimentResult

    directory = results_directory(options, root)
    for meta_path in sorted(glob.glob(os.path.join(directory, "*.json")),
                            reverse=True):
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            saved = Config.from_json_dict(meta["config"])
        except (json.JSONDecodeError, KeyError, ValueError):
            continue
        if (meta.get("package") == PACKAGE and not meta.get("partial")
                and saved.isequal(options)):
            return ExperimentResult.load(meta_path[: -len(".json")])
    return None



def mpa_library_dir() -> str:
    """The directory of this package's built MPA library
    (``models.mpa``), never pdmpc_tpu's."""
    from pdmpc_torch.models.mpa import _LIBRARY_DIR

    return _LIBRARY_DIR
