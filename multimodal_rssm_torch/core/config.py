"""Hydra-compatible YAML config system (the port's own copy).

The reference composes its config from four groups (``main``, ``env``,
``rssm``, ``train``) via hydra and accepts dotted CLI overrides.  This module
re-implements the subset the reference relies on:

- group composition from a ``config.yaml`` ``defaults`` list;
- dotted overrides ``group.key=value`` with YAML value parsing, and hydra
  group swaps ``group=option``;
- saving the composed config as ``hydra_config.yaml`` in the run dir.

Configs are nested dicts wrapped in :class:`ConfigDict` for attribute
access (``cfg.rssm.belief_size``).  The default tree ships inside the
package (``multimodal_rssm_torch/configs``).
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Iterable, List, Optional

import yaml


class ConfigDict(dict):
    """A dict with attribute access and recursive wrapping."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value

    def __deepcopy__(self, memo):
        return ConfigDict(copy.deepcopy(dict(self), memo))

    def set_path(self, dotted: str, value):
        parts = dotted.split(".")
        node: Any = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = ConfigDict()
            node = node[part]
        node[parts[-1]] = value

    def to_dict(self) -> Dict[str, Any]:
        return _unwrap(self)


def _wrap(value):
    if isinstance(value, ConfigDict):
        return value
    if isinstance(value, dict):
        return ConfigDict(value)
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def _unwrap(value):
    if isinstance(value, dict):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    return value


def _merge(base: Dict[str, Any], extra: Dict[str, Any]) -> None:
    for k, v in extra.items():
        if k in base and isinstance(base[k], dict) and isinstance(v, dict):
            _merge(base[k], v)
        else:
            base[k] = v


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        data = yaml.safe_load(f)
    return data or {}


def default_config_dir() -> str:
    """The config-group tree shipped inside the package."""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs")


def compose(
    config_dir: Optional[str] = None,
    config_name: str = "config",
    overrides: Optional[Iterable[str]] = None,
) -> ConfigDict:
    """Compose a config from a hydra-style group tree.

    ``{config_dir}/{config_name}.yaml`` holds a ``defaults`` list of
    ``{group: option}`` entries; each resolves to
    ``{config_dir}/{group}/{option}.yaml`` and lands under ``cfg[group]``.
    """
    if config_dir is None:
        config_dir = default_config_dir()
    root = load_yaml(os.path.join(config_dir, config_name + ".yaml"))

    # "rssm=unimodal" swaps a whole group option before composition;
    # dotted "a.b=c" overrides apply after.
    group_overrides = {}
    value_overrides = []
    for ov in list(overrides or []):
        key = ov.split("=", 1)[0]
        if "=" in ov and "." not in key:
            group_overrides[key.strip()] = ov.split("=", 1)[1].strip()
        else:
            value_overrides.append(ov)

    cfg: Dict[str, Any] = {}
    defaults: List[Any] = root.pop("defaults", [])
    for entry in defaults:
        if isinstance(entry, dict):
            for group, option in entry.items():
                if group == "_self_" or option is None:
                    continue
                option = group_overrides.pop(str(group), option)
                group_cfg = load_yaml(
                    os.path.join(config_dir, str(group), str(option) + ".yaml"))
                _merge(cfg.setdefault(group, {}), group_cfg)
    if group_overrides:
        raise ValueError(f"unknown config groups: {sorted(group_overrides)}")
    _merge(cfg, root)

    config = ConfigDict(cfg)
    apply_overrides(config, value_overrides)
    return config


def apply_overrides(cfg: ConfigDict, overrides: Iterable[str]) -> ConfigDict:
    """Apply dotted ``a.b.c=value`` overrides (hydra CLI style)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must look like key.path=value")
        key, _, raw = ov.partition("=")
        cfg.set_path(key.strip(), yaml.safe_load(raw.strip()))
    return cfg


def save_config(cfg: ConfigDict, path: str) -> None:
    """Save a composed config (the run-archive ``hydra_config.yaml``)."""
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f, default_flow_style=False,
                       sort_keys=False)


def load_run_config(results_dir: str,
                    name: str = "hydra_config.yaml") -> ConfigDict:
    """Re-open a saved run's config (what ``--resume`` continues)."""
    return ConfigDict(load_yaml(os.path.join(results_dir, name)))
