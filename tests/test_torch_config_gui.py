"""The port's config wizard (pdmpc_torch/config_gui.py): the twin of
tests/test_config_gui.py, and on the same scripted answers the same
configuration as pdmpc_tpu's wizard. Each package keeps its previous
selection in a file of its own."""

import json

import pdmpc_torch.config_gui as tgui
import pdmpc_tpu.config_gui as jgui
from pdmpc_torch.config import Config, PriorityStrategies, ScenarioType
from pdmpc_torch.config_gui import config_gui

ANSWERS = (
    # 10 enum menus: pick option 2 for scenario (circle), defaults
    # elsewhere; priority is the 5th enum field
    ["2", "", "", "", "4", "", "", "", "", ""]
    # is_prioritized
    + [""]
    # amount, T_end, Hp, max_num_CLs, beam_width, seed
    + ["4", "2.0", "", "", "128", ""])


def test_defaults_non_interactive(monkeypatch, tmp_path):
    monkeypatch.setattr(tgui, "_PREVIOUS_PATH", str(tmp_path / "prev.json"))
    assert config_gui(interactive=False) == Config().validate()


def test_scripted_selection_and_persistence(monkeypatch, tmp_path):
    prev = str(tmp_path / "prev.json")
    monkeypatch.setattr(tgui, "_PREVIOUS_PATH", prev)
    answers = iter(ANSWERS)
    cfg = config_gui(input_fn=lambda _: next(answers))
    assert cfg.scenario_type == ScenarioType.circle
    assert cfg.priority == list(PriorityStrategies)[3]
    assert cfg.amount == 4 and cfg.T_end == 2.0 and cfg.beam_width == 128
    # previous selection persisted (config_gui.m:60-66) and reloaded as
    # the new defaults
    with open(prev) as f:
        assert json.load(f)["amount"] == 4
    cfg2 = config_gui(interactive=False)
    assert cfg2.scenario_type == ScenarioType.circle
    assert cfg2.amount == 4


def test_same_configuration_as_reference(monkeypatch, tmp_path):
    monkeypatch.setattr(tgui, "_PREVIOUS_PATH", str(tmp_path / "t.json"))
    monkeypatch.setattr(jgui, "_PREVIOUS_PATH", str(tmp_path / "j.json"))
    got, want = (gui.config_gui(input_fn=lambda _, a=iter(ANSWERS): next(a))
                 for gui in (tgui, jgui))
    assert got.to_json_dict() == want.to_json_dict()


def test_own_previous_selection_path():
    assert tgui._PREVIOUS_PATH.endswith("pdmpc_torch_config_gui.json")
    assert tgui._PREVIOUS_PATH != jgui._PREVIOUS_PATH
