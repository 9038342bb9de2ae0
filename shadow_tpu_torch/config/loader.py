"""YAML config loading with CLI-style overrides (the port's copy of
the reference package's config/loader.py): the YAML text is parsed
first, then dotted-path overrides ("general.stop_time=10s") are applied
on the raw dict before schema conversion."""

from __future__ import annotations

from typing import Iterable, Optional

import yaml

from shadow_tpu_torch.config.schema import ConfigOptions


def _apply_override(raw: dict, dotted: str, value) -> None:
    parts = dotted.split(".")
    node = raw
    for i, p in enumerate(parts[:-1]):
        node = node.setdefault(p, {})
        if not isinstance(node, dict):
            prefix = ".".join(parts[: i + 1])
            raise ValueError(
                f"override path {dotted!r}: {prefix!r} is not a section"
            )
    node[parts[-1]] = value


def load_config_str(text: str,
                    overrides: Optional[Iterable[str]] = None) -> ConfigOptions:
    raw = yaml.safe_load(text) or {}
    for ov in overrides or ():
        key, eq, val = ov.partition("=")
        if not eq:
            raise ValueError(f"override {ov!r} is not of the form KEY=VALUE")
        _apply_override(raw, key.strip(), yaml.safe_load(val))
    return ConfigOptions.from_dict(raw)


def load_config(path: str,
                overrides: Optional[Iterable[str]] = None) -> ConfigOptions:
    with open(path) as f:
        return load_config_str(f.read(), overrides)
