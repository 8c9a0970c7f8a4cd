"""Hierarchical YAML configuration (the port's own copy of the loader).

Same semantics as ``diffsinger_tpu/config/hparams.py``:
  * ``base_config`` may be a string or a list of YAML paths; bases merge
    depth-first, later bases and finally the child override earlier values
    (dicts merge recursively, everything else replaces);
  * paths starting with ``.`` resolve relative to the including file;
  * a visited set guards against include cycles;
  * ``k=v,k2=v2`` overrides are coerced to the type of the existing value.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import yaml


class HParams(dict):
    """A dict with attribute access. Values are plain Python/YAML types."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value


def _deep_override(old: Dict[str, Any], new: Dict[str, Any]) -> None:
    """Merge ``new`` into ``old`` in place; nested dicts merge recursively."""
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(old.get(k), dict):
            _deep_override(old[k], v)
        else:
            old[k] = v


def load_config(config_path: str, _visited: Optional[set] = None) -> HParams:
    """Load one YAML file, resolving its ``base_config`` inheritance chain."""
    _visited = set() if _visited is None else _visited
    config_path = os.path.normpath(config_path)
    _visited.add(config_path)
    with open(config_path) as f:
        raw = yaml.safe_load(f) or {}

    bases = raw.pop("base_config", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for base in bases:
        if base.startswith("."):
            base = os.path.normpath(os.path.join(os.path.dirname(config_path), base))
        if base in _visited:
            continue
        _deep_override(merged, load_config(base, _visited))
    _deep_override(merged, raw)
    return HParams(merged)


def parse_overrides(hp: Dict[str, Any], hparams_str: str) -> None:
    """Apply ``k=v,k2=v2`` overrides, coercing to the type of the existing value."""
    if not hparams_str:
        return
    for item in hparams_str.split(","):
        if not item:
            continue
        k, v = item.split("=", 1)
        k = k.strip()
        if k not in hp:
            hp[k] = yaml.safe_load(v)
        elif isinstance(hp[k], bool) or v in ("True", "False", "true", "false"):
            hp[k] = v in ("True", "true", "1")
        elif hp[k] is None or isinstance(hp[k], (list, dict)):
            hp[k] = yaml.safe_load(v)
        else:
            hp[k] = type(hp[k])(v)


def set_hparams(config: str, hparams_str: str = "") -> HParams:
    """Resolve a config file plus ``k=v`` overrides into one ``HParams``."""
    hp = load_config(config)
    parse_overrides(hp, hparams_str)
    return hp
