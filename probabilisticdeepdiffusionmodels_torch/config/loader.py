"""Config-group composition and CLI overrides.

PyTorch-port copy of ``probabilisticdeepdiffusionmodels_tpu/config/loader.py``
over the port's own copy of the YAML tree (the same files, plus a top-level
``device`` key in the ``default``, ``sample`` and ``eval`` roots: null means
``cuda``), with the same composition semantics over PyYAML:

  * a root yaml with a ``defaults`` list of {group: choice} entries;
  * group yamls at <config_dir>/<group>/<choice>.yaml loaded under that key;
  * overrides ``group=choice`` (re-selects a group file) and
    ``a.b.c=value`` (dotted deep-set, values parsed as YAML: ``2e-4``
    without a dot stays a string, which the engine turns into a float);
  * ``key=null`` yields None.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import yaml

CONFIG_DIR = Path(__file__).parent

__all__ = ["load_config", "CONFIG_DIR", "deep_set", "to_dict"]


def _load_yaml(path: Path) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def deep_set(cfg: dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def load_config(
    root: str = "default",
    overrides: Optional[Sequence[str]] = None,
    config_dir: Optional[Path] = None,
) -> Dict[str, Any]:
    """Compose <config_dir>/<root>.yaml with its groups, then apply overrides."""
    config_dir = Path(config_dir) if config_dir else CONFIG_DIR
    cfg = _load_yaml(config_dir / f"{root}.yaml")
    defaults: List[dict] = cfg.pop("defaults", [])

    group_choice: Dict[str, str] = {}
    for entry in defaults:
        (group, choice), = entry.items()
        group_choice[group] = choice

    # group re-selections first (``model=unet_small``)
    kv_overrides = []
    for ov in overrides or []:
        key, _, raw = ov.partition("=")
        if "." not in key and (config_dir / key).is_dir():
            group_choice[key] = raw
        else:
            kv_overrides.append((key, yaml.safe_load(raw)))

    for group, choice in group_choice.items():
        cfg[group] = _load_yaml(config_dir / group / f"{choice}.yaml")
        cfg.setdefault("_choices", {})[group] = choice

    for key, value in kv_overrides:
        deep_set(cfg, key, value)
    return cfg


def to_dict(cfg) -> dict:
    return copy.deepcopy(cfg)
