"""Interactive configuration builder — the ui/config_gui capability.

Torch twin of pdmpc_tpu/config_gui.py. Reference: ui/config_gui.m:1-120
+ ConfigGui.mlapp (MATLAB App Designer): dropdowns for scenario /
control strategy / coupler / prioritizer / weigher / cutter / optimizer /
constraint-from-successor / computation mode, plus numeric fields, with
the previous selection persisted in tempdir and reloaded next launch
(config_gui.m:60-66).

A terminal wizard (the card's hosts are headless). Each enum field of
:class:`Config` becomes a numbered menu, numeric fields become prompts
with defaults. Non-interactive streams (pipes, CI) take
every default, so ``main --gui`` cannot hang a batch job.

Use: ``python -m pdmpc_torch.main --gui`` or ``config_gui()`` in code.
The previous selection is kept in ``pdmpc_torch_config_gui.json`` in the
temporary directory, apart from pdmpc_tpu's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile

from pdmpc_torch.config import _ENUM_FIELDS, Config

_PREVIOUS_PATH = os.path.join(tempfile.gettempdir(),
                              "pdmpc_torch_config_gui.json")

# fields surfaced by the GUI, in reference dropdown order (config_gui.m)
_NUMERIC_FIELDS = ("amount", "T_end", "Hp", "max_num_CLs", "beam_width",
                   "seed")
_BOOL_FIELDS = ("is_prioritized",)


def _load_previous() -> Config | None:
    """config_gui.m:60-66: reload the persisted previous selection."""
    try:
        with open(_PREVIOUS_PATH) as f:
            return Config.from_json_dict(json.load(f))
    except Exception:  # noqa: BLE001 — missing/stale tempdir file
        return None


def _save_previous(cfg: Config) -> None:
    try:
        with open(_PREVIOUS_PATH, "w") as f:
            json.dump(cfg.to_json_dict(), f)
    except OSError:
        pass


def _prompt(text: str, default: str, input_fn) -> str:
    raw = input_fn(f"{text} [{default}]: ").strip()
    return raw if raw else default


def config_gui(input_fn=None, interactive: bool | None = None) -> Config:
    """Build a :class:`Config` interactively; returns it validated.

    ``input_fn`` is injectable for tests; ``interactive=False`` (or a
    non-tty stdin) takes the previous/ default selection throughout.
    """
    if interactive is None:
        interactive = sys.stdin.isatty() and input_fn is None
    if input_fn is None:
        input_fn = input

    base = _load_previous() or Config()
    values = dataclasses.asdict(base)
    # dataclasses.asdict recurses into nested dataclasses; keep the real one
    values["manual_control_config"] = base.manual_control_config

    if interactive or input_fn is not input:
        print("Select your configuration "
              "(enter keeps the [previous/default] value)")
        for name, enum_cls in _ENUM_FIELDS.items():
            members = list(enum_cls)
            current = getattr(base, name)
            print(f"\n{name}:")
            for i, m in enumerate(members, 1):
                marker = "*" if m == current else " "
                print(f"  {i}{marker} {m.value}")
            raw = _prompt("choice", str(members.index(current) + 1),
                          input_fn)
            try:
                values[name] = members[int(raw) - 1]
            except (ValueError, IndexError):
                values[name] = current
        for name in _BOOL_FIELDS:
            raw = _prompt(f"{name} (y/n)",
                          "y" if getattr(base, name) else "n", input_fn)
            values[name] = raw.lower().startswith("y")
        for name in _NUMERIC_FIELDS:
            default = getattr(base, name)
            raw = _prompt(name, str(default), input_fn)
            try:
                values[name] = type(default)(raw)
            except ValueError:
                values[name] = default
    else:
        for name, enum_cls in _ENUM_FIELDS.items():
            values[name] = getattr(base, name)

    field_names = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in values.items() if k in field_names})
    cfg = cfg.validate()
    _save_previous(cfg)
    return cfg


if __name__ == "__main__":
    print(json.dumps(config_gui().to_json_dict(), indent=2))
