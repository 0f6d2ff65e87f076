"""The port's own tables against the reference's, field by field, exactly.

For the 3- and 20-vehicle CommonRoad configurations, and for the other
golden configurations the port runs (circle Hp 10, the realistic MPA on
the circle, the triple-speed MPA on the road), every field of
pdmpc_torch's ``build_mpa(...).to_tensors_for`` and
``create_scenario(...).to_tensors`` equals ``np.asarray`` of its
pdmpc_tpu twin (values exactly; float and bool dtypes too, while integer
indices are int64 in the port). The port builds its MPA and parses the map
itself, so this also holds its copies of ``build_mpa``, the road parser
(with its own point-in-polygon rasterizer) and the scenario packing to
the reference. The ``convert`` helpers carry the reference's tensors over
unchanged.
"""

import numpy as np
import pytest
import torch

from pdmpc_torch import convert
from pdmpc_torch.config import Config as TConfig
from pdmpc_torch.experiment import create_scenario as t_create_scenario
from pdmpc_torch.models.mpa import build_mpa as t_build_mpa
from pdmpc_tpu.config import Config as JConfig
from pdmpc_tpu.experiment import create_scenario as j_create_scenario
from pdmpc_tpu.models.mpa import build_mpa as j_build_mpa

# One intra-op thread per process: the suite runs in several pytest
# workers at once, and a full torch thread pool in each of them
# oversubscribes the cores (a file that takes seconds alone then takes
# minutes).
torch.set_num_threads(1)

# enum fields by member name, resolved in each package's own Config
CONFIGS = {
    "cr3": dict(amount=3, T_end=4.0, beam_width=64),
    "cr20": dict(amount=20, T_end=4.0, beam_width=64),
    "circle_03veh_hp10": dict(scenario_type="circle", amount=3, T_end=2.0,
                              Hp=10, beam_width=128),
    "circle_03veh_realistic": dict(scenario_type="circle", amount=3,
                                   T_end=2.0, beam_width=128,
                                   mpa_type="realistic"),
    "commonroad_03veh_triple": dict(amount=3, T_end=2.0, beam_width=128,
                                    mpa_type="triple_speed"),
}
ROAD = sorted(k for k, kw in CONFIGS.items() if "scenario_type" not in kw)


def make_config(config_cls, name):
    import importlib

    enums = importlib.import_module(config_cls.__module__)
    kw = dict(CONFIGS[name])
    if "scenario_type" in kw:
        kw["scenario_type"] = enums.ScenarioType[kw["scenario_type"]]
    if "mpa_type" in kw:
        kw["mpa_type"] = enums.MpaType[kw["mpa_type"]]
    return config_cls(**kw).validate()


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def both(request):
    jcfg = make_config(JConfig, request.param)
    tcfg = make_config(TConfig, request.param)
    assert tcfg.path_ids == jcfg.path_ids
    jmpa = j_build_mpa(jcfg)
    tmpa = t_build_mpa(tcfg)
    return dict(
        jmpa=jmpa.to_tensors_for(jcfg),
        tmpa=tmpa.to_tensors_for(tcfg, device="cpu"),
        jsc=j_create_scenario(jcfg, jmpa).to_tensors(),
        tsc=t_create_scenario(tcfg, tmpa).to_tensors(device="cpu"),
    )


def assert_same(got: torch.Tensor, want, name: str):
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype.kind in "fb":
        assert got.dtype == want.dtype, f"{name}: {got.dtype} != {want.dtype}"
    else:
        assert got.dtype == np.int64, name
    np.testing.assert_array_equal(got, want, err_msg=name)


def asdict_np(nt):
    out = {}
    for k, v in nt._asdict().items():
        out[k] = (None if v is None else
                  asdict_np(v) if hasattr(v, "_asdict") else np.asarray(v))
    return out


def test_mpa_fields(both):
    for f in both["jmpa"]._fields:
        assert_same(getattr(both["tmpa"], f), getattr(both["jmpa"], f), f)


def test_scenario_fields(both):
    jsc, tsc = both["jsc"], both["tsc"]
    for f in jsc._fields:
        j, t = getattr(jsc, f), getattr(tsc, f)
        if f == "road" and j is not None:
            for rf in j._fields:
                assert_same(getattr(t, rf), getattr(j, rf), f"road.{rf}")
        elif j is None:
            assert t is None, f
        else:
            assert_same(t, j, f)


def test_convert_round_trip(both):
    mpa = convert.mpa_from_numpy(asdict_np(both["jmpa"]), device="cpu")
    for f in mpa._fields:
        assert_same(getattr(mpa, f), getattr(both["jmpa"], f), f)
    sc = convert.scenario_from_numpy(asdict_np(both["jsc"]), device="cpu")
    for f in sc._fields:
        j, t = getattr(both["jsc"], f), getattr(sc, f)
        if f == "road" and j is not None:
            for rf in j._fields:
                assert_same(getattr(t, rf), getattr(j, rf), f"road.{rf}")
        elif j is None:
            assert t is None, f
        else:
            assert_same(t, j, f)


@pytest.mark.parametrize("both", ROAD, indirect=True)
def test_closest_lanelets(both):
    """map_position_to_closest_lanelets on random map points: the closest
    lanelet and the set within 0.1 m of it, exactly."""
    import jax

    from pdmpc_torch.scenarios.scenario import (
        map_position_to_closest_lanelets as t_closest,
    )
    from pdmpc_tpu.scenarios.scenario import (
        map_position_to_closest_lanelets as j_closest,
    )

    xy = np.random.default_rng(3).uniform([0.0, 0.0], [4.5, 4.0],
                                          size=(256, 2)).astype(np.float32)
    want_best, want_within = jax.vmap(
        lambda p: j_closest(both["jsc"].road, p))(xy)
    got_best, got_within = t_closest(both["tsc"].road, torch.as_tensor(xy))
    np.testing.assert_array_equal(got_best.numpy(), np.asarray(want_best))
    np.testing.assert_array_equal(got_within.numpy(),
                                  np.asarray(want_within))
