"""YAML experiment configuration -> namespace, with ``CONF:KEY:VALUE``
overrides and the config checks (counterpart of
``tailored_avsr_tpu/utils/config.py``), so that reading a config pulls in
nothing of the JAX package."""

from __future__ import annotations

import argparse
from typing import List, Optional

import yaml


def load_config(path: str, overrides: Optional[List[str]] = None) -> argparse.Namespace:
    with open(path, "r", encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    if overrides:
        cfg = override_yaml(cfg, overrides)
    return argparse.Namespace(**cfg)


def override_yaml(cfg: dict, overrides: List[str]) -> dict:
    """Apply 'SECTION:KEY:VALUE' (nested) or 'KEY:VALUE' (top-level)
    overrides, keeping the type of the value replaced."""
    for spec in overrides or []:
        parts = spec.split(":")
        if len(parts) == 2:
            key, value = parts
            cfg[key] = _coerce(cfg.get(key), value)
        elif len(parts) == 3:
            section, key, value = parts
            if section not in cfg or cfg[section] is None:
                cfg[section] = {}
            cfg[section][key] = _coerce(cfg[section].get(key), value)
        else:
            raise ValueError(f"bad override (want CONF:KEY:VALUE): {spec}")
    return cfg


def _coerce(old, value: str):
    if isinstance(old, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(old, int):
        return int(value)
    if isinstance(old, float):
        return float(value)
    return yaml.safe_load(value)  # a list, or no previous value: YAML's reading


def security_checks(config: argparse.Namespace) -> None:
    """1 <= training_settings average_epochs <= epochs."""
    ts = getattr(config, "training_settings", {}) or {}
    avg, epochs = ts.get("average_epochs", 1), ts.get("epochs", 1)
    if not 1 <= avg <= epochs:
        raise ValueError(f"average_epochs ({avg}) must be within [1, epochs ({epochs})]")
