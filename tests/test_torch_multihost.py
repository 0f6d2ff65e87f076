"""Two OS processes through the port's multi-host entry on the CPU (the
``parallel_physically`` mode; reference: nuc_control/deploy_nuc.sh:17
launches ``main_distributed(i)`` on each NUC), as tests/test_multihost.py's
default case runs the JAX package's:

    python -m pdmpc_torch.parallel.multihost --coordinator 127.0.0.1:PORT \\
        --num-processes 2 --process-id I --backend gloo --device cpu -- \\
        --scenario circle --amount 4 --t-end 1.0 --beam-width 64

``main`` picks the (1, 2) mesh. Every process prints the same pose sum,
equal to the sequential run's, and rank 0's saved result equals the
sequential run in every record, bit for bit.
"""

import os
import re
import subprocess
import sys

import numpy as np
import torch

from pdmpc_torch import Config, ScenarioType
from pdmpc_torch.experiment import ExperimentResult, run_experiment
from pdmpc_torch.parallel.multihost import free_port

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = ["--scenario", "circle", "--amount", "4", "--t-end", "1.0",
       "--beam-width", "64"]


def test_two_process_run_equals_sequential(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               PDMPC_RESULTS_DIR=str(tmp_path / "results"))
    address = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pdmpc_torch.parallel.multihost",
         "--coordinator", address, "--num-processes", "2",
         "--process-id", str(pid), "--backend", "gloo", "--device", "cpu",
         "--", *CLI], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    try:
        outputs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {pid}:\n{out[-3000:]}"

    seq = run_experiment(Config(scenario_type=ScenarioType.circle, amount=4,
                                T_end=1.0, beam_width=64), device="cpu")
    want = repr(float(np.sum(seq.infos.poses, dtype=np.float64)))
    for pid, out in enumerate(outputs):
        assert re.search(r"^steps=5 vehicles=4 fallbacks=\d+ "
                         r"control_loop=[\d.]+s$", out, re.M), out
        line = next(ln for ln in out.splitlines() if ln.startswith("rank="))
        assert f"rank={pid} n_devices=2 mesh=[1, 2] backend=gloo" in line
        assert line.endswith(f"pose_sum={want}"), (line, want)

    # rank 0 alone wrote the configuration and the result
    assert (tmp_path / "Config.json").is_file()
    saved = sorted((tmp_path / "results").rglob("*.json"))
    assert len(saved) == 1, saved
    res = ExperimentResult.load(str(saved[0])[:-len(".json")])
    assert res.timings["mesh"] == [1, 2]
    assert res.timings["backend"] == "gloo"
    assert len(res.timings["launches_by_rank"]) == 2
    for f, got, w in zip(seq.infos._fields, res.infos, seq.infos):
        np.testing.assert_array_equal(got, w, err_msg=f)
