"""Records of the JAX package's own CPU runs that chip_smoke.py holds the
card's runs to, where no golden exists and the runs are too long for the
tier-1 tests (each takes 2 to 6 minutes on the CPU). The test here only
checks that each record is there and has its configuration's shape.

    JAX_PLATFORMS=cpu python -m tests.test_torch_reference_records [NAME ...]

runs each named configuration (default: all of ``runs()``) through
``pdmpc_tpu.experiment.run_experiment`` on the CPU and writes its step
records to ``tests/torch_fixtures/reference_<NAME>.npz`` (the fields of
``STEP_FIELDS``). chip_smoke.py loads them with numpy only.
"""

import os
import sys

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures")
# the record fields kept: what the exact gate and the behavior checks read
STEP_FIELDS = ("poses", "trims", "cost", "needs_fallback", "is_exhausted",
               "levels", "adjacency")


def runs():
    """name -> the configuration, as chip_smoke.py phase 17 drives it."""
    import pdmpc_tpu.config as jc

    def hdvs(*ids):
        return jc.ManualControlConfig(is_active=True, amount=len(ids),
                                      hdv_ids=ids)

    return {
        # phase 17a: cr20 with vehicles 3 and 11 human-driven
        "hdv_road": jc.Config(amount=20, T_end=4.0,
                              manual_control_config=hdvs(3, 11)),
        # phase 17b: circle-10 with vehicle 0 human-driven
        "hdv_circle": jc.Config(scenario_type=jc.ScenarioType.circle,
                                amount=10, T_end=8.0,
                                manual_control_config=hdvs(0)),
        # phase 17d and e: centralized planning on circle-3 and on cr3
        "centralized_circle3": jc.Config(
            scenario_type=jc.ScenarioType.circle, amount=3, T_end=4.0,
            beam_width=2048, is_prioritized=False),
        "centralized_cr3": jc.Config(amount=3, T_end=2.0, beam_width=1024,
                                     is_prioritized=False),
    }


def path(name: str) -> str:
    return os.path.join(FIXTURES, f"reference_{name}.npz")


def test_records_have_their_configurations_shapes():
    for name, cfg in runs().items():
        cfg = cfg.validate()
        with np.load(path(name)) as rec:
            assert sorted(rec.files) == sorted(STEP_FIELDS), name
            k, n = cfg.k_end, cfg.amount
            assert rec["poses"].shape == (k, n, cfg.Hp, 3), name
            assert rec["trims"].shape == (k, n, cfg.Hp), name
            assert rec["adjacency"].shape == (k, n, n), name
            assert np.isfinite(rec["poses"]).all(), name


def main(names) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pdmpc_tpu.experiment import run_experiment

    configs = runs()
    for name in names or sorted(configs):
        res = run_experiment(configs[name])
        np.savez_compressed(path(name), **{
            f: np.asarray(getattr(res.infos, f)) for f in STEP_FIELDS})
        print(f"{name}: {res.n_steps} steps -> {path(name)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
