"""Hierarchical YAML configuration (the port's own copy of the loader).

Same semantics as ``diffsinger_tpu/config/hparams.py``:
  * ``base_config`` may be a string or a list of YAML paths; bases merge
    depth-first, later bases and finally the child override earlier values
    (dicts merge recursively, everything else replaces);
  * paths starting with ``.`` resolve relative to the including file;
  * a visited set guards against include cycles;
  * ``k=v,k2=v2`` overrides are coerced to the type of the existing value;
  * ``set_hparams`` resolves a run: ``work_dir = ckpt_root/exp_name``, a
    saved ``<work_dir>/config.yaml`` overrides the chain unless ``reset`` (and
    stands in for a missing ``--config``), the resolved config is written
    there unless inferring, and ``infer`` / ``validate`` / ``debug`` /
    ``exp_name`` / ``work_dir`` are set. No module-level global: the result
    is passed by value.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Iterable, Optional

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


def set_hparams(config: str = "", exp_name: str = "", hparams_str: str = "", *,
                reset: bool = False, infer: bool = False, validate: bool = False,
                debug: bool = False, ckpt_root: str = "checkpoints",
                argv: Optional[Iterable[str]] = None,
                print_hparams: bool = False) -> HParams:
    """Resolve the configuration of a run. With neither ``config`` nor
    ``exp_name``, the flags ``--config --exp_name --hparams --infer
    --validate --reset --debug`` are parsed from ``argv`` (default
    ``sys.argv``)."""
    if config == "" and exp_name == "":
        parser = argparse.ArgumentParser(description="diffsinger_tpu_torch")
        parser.add_argument("--config", type=str, default="")
        parser.add_argument("--exp_name", type=str, default="")
        parser.add_argument("--hparams", type=str, default="")
        parser.add_argument("--infer", action="store_true")
        parser.add_argument("--validate", action="store_true")
        parser.add_argument("--reset", action="store_true")
        parser.add_argument("--debug", action="store_true")
        args, _ = parser.parse_known_args(argv)
        config, exp_name, hparams_str = args.config, args.exp_name, args.hparams
        infer, validate, reset, debug = args.infer, args.validate, args.reset, args.debug

    work_dir = os.path.join(ckpt_root, exp_name) if exp_name else ""
    saved_config_path = os.path.join(work_dir, "config.yaml") if work_dir else ""
    saved: Dict[str, Any] = {}
    if saved_config_path and os.path.exists(saved_config_path):
        try:
            with open(saved_config_path) as f:
                saved = yaml.safe_load(f) or {}
        except Exception:
            saved = {}
        if config == "":
            config = saved_config_path
    if not config:
        raise ValueError("either --config or a saved config in work_dir is required")

    hp = load_config(config)
    if not reset:
        _deep_override(hp, saved)
    hp["work_dir"] = work_dir
    parse_overrides(hp, hparams_str)
    if work_dir and (not os.path.exists(saved_config_path) or reset) and not infer:
        os.makedirs(work_dir, exist_ok=True)
        with open(saved_config_path, "w") as f:
            yaml.safe_dump(dict(hp), f)
    hp["infer"] = infer
    hp["validate"] = validate
    hp["debug"] = debug
    if not hp.get("exp_name"):
        hp["exp_name"] = exp_name
    if print_hparams:
        print("| HParams:")
        for k in sorted(hp):
            print(f"|   {k}: {hp[k]}")
    return hp
