#!/usr/bin/env python3
"""Time this checkout against another one (say, its parent commit) on the
card, in turns.

    python3 compare_trees.py OTHER_DIR [--out FILE] [--kernels-only]

Runs, in the order other, this, this, other, each run a process of its
own started in that checkout's directory:

- kernels: phase 2 of this checkout's ``chip_smoke.py`` (its inputs, its
  exactness check and its timing) on each checkout's kernels, all
  candidates live: per kernel the device ms of a call, the ms of a call
  with its host part, and the plain version's device ms; where the
  checkout's ``ops/collision.py`` has the SAT lattice form (and with it
  every entry form phase 2 calls), also phase 2's live-mask and
  lattice-form runs, say against a scratch copy with another lane count;
- steps (unless ``--kernels-only``): each checkout's own ``python -m
  pdmpc_torch.profile_step``, for the road (``--scenario commonroad``) and
  the circle.

Prints one JSON line per run and, last, one JSON object with every run
(also written to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SCENARIOS = ("commonroad", "circle")


def kernels_worker() -> int:
    """Run in a checkout's directory: time its kernels with this
    checkout's phase 2."""
    import importlib.util

    sys.path[0] = os.getcwd()
    import torch

    from pdmpc_torch.ops import collision as coll

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rows = smoke.check_kernels(torch, coll, "cuda",
                               extras=hasattr(coll, "sat_hits_lattice"))
    print(json.dumps({row["name"]: {k: row[k] for k in
                                    ("ms", "event_ms", "plain_ms", "bound_ms",
                                     "live_mask", "lattice") if k in row}
                      for row in rows}))
    return 0


def last_json(cmd, cwd, timeout):
    """Run ``cmd`` in ``cwd``; its last line of output, parsed."""
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd} in {cwd} failed:\n{proc.stdout[-4000:]}"
                           f"\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", nargs="?")
    parser.add_argument("--out", default=None)
    parser.add_argument("--kernels-only", action="store_true",
                        help="time the kernels, not the steps")
    parser.add_argument("--kernels-worker", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.kernels_worker:
        return kernels_worker()
    if args.other is None:
        parser.error("OTHER_DIR is required")
    trees = {"other": os.path.abspath(args.other), "this": HERE}
    order = ("other", "this", "this", "other")
    runs = []
    for tree in order:
        got = last_json([sys.executable, os.path.abspath(__file__),
                         "--kernels-worker"], trees[tree], 600)
        runs.append({"run": "kernels", "tree": tree, **got})
        print(json.dumps(runs[-1]), flush=True)
    for scenario in () if args.kernels_only else SCENARIOS:
        for tree in order:
            got = last_json([sys.executable, "-m", "pdmpc_torch.profile_step",
                             "--scenario", scenario], trees[tree], 900)
            runs.append({"run": "profile_step", "scenario": scenario,
                         "tree": tree, **got})
            print(json.dumps(runs[-1]), flush=True)
    result = {"trees": trees, "order": order, "runs": runs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
