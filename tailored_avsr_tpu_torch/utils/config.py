"""YAML experiment configuration -> namespace
(counterpart of ``load_config`` in ``tailored_avsr_tpu/utils/config.py``,
without the CLI overrides), so that reading a config pulls in nothing of the
JAX package."""

from __future__ import annotations

import argparse

import yaml


def load_config(path: str) -> argparse.Namespace:
    with open(path, "r", encoding="utf-8") as f:
        return argparse.Namespace(**yaml.safe_load(f))
