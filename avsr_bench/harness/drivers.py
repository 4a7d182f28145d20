"""The system under test, driven through its entry points. A traffic
mix's ``entry`` names its driver, ``harness/entries/<entry>.py``, whose
``Driver`` subclasses the one here: it builds ``Speech2Text`` from the
configuration file, loads the benchmark's seeded weights into it (their
template is the reference model of the configuration's family,
``harness/families/<family>.py``) and makes one call a batch. The
program's own modules are imported here, by the entries and by
``kernel_counters``, and nowhere else in the harness (the reference never
imports them)."""

from __future__ import annotations

import argparse
import copy
import importlib
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from . import families, manifest, weights
from .manifest import ROOT

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the kernel wrappers' launch counters (the program's own), name -> "module:attribute"; a family or a
# metric reader adds its own by the same name, LAUNCH_COUNTERS
LAUNCH_COUNTERS = {
    "K1": "tailored_avsr_tpu_torch.ops.flash_attention:flash_attention_relpos.launches",
    "K2": "tailored_avsr_tpu_torch.ops.flash_attention:flash_attention.launches",
    "K3": "tailored_avsr_tpu_torch.ops.fused_csgu:fused_csgu.launches",
    "K4": "tailored_avsr_tpu_torch.ops.group_attend:group_attend_anc.launches",
    "K5": "tailored_avsr_tpu_torch.ops.cache_update:write_step_columns.launches",
    "K6": "tailored_avsr_tpu_torch.ops.group_attend:group_attend_anc_q.launches",
}


def token_list(cfg: Dict) -> List[str]:
    path = cfg["token_list"]
    if not isinstance(path, str):
        return list(path)
    with open(os.path.join(ROOT, path), encoding="utf-8") as f:
        return [line.rstrip() for line in f if line.rstrip()]


def model_config(config_file: Dict) -> Dict:
    """The configuration as the program takes it, with the vocabulary's size."""
    cfg = copy.deepcopy(config_file["model"])
    cfg["vocab"] = len(token_list(cfg))
    return cfg


def lm_keys(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The LM's weights under the program's names (the checkpoint's ``lm.`` prefix dropped)."""
    return {k[len("lm."):]: v for k, v in state.items()}


def served_dtype(config_file: Dict) -> str:
    return str(config_file["model"].get("dtype", "float32"))


class Driver:
    """Builds ``Speech2Text`` from the configuration, loads the seeded
    weights (model first, then the LM from the same stream) and calls one
    entry a batch. ``family`` is the configuration's family (``families.load``)."""

    uses_lm = False  # whether the entry fuses the configuration's LM

    @staticmethod
    def search_flops(cfg: Dict, b: int, t: int) -> float:
        """FLOPs that a call's search adds, before its steps, over the
        encoder's (b, t) output (``families.call_flops``)."""
        return 0.0

    def __init__(self, cell, seed: int, device: torch.device):
        from tailored_avsr_tpu_torch.inference import Speech2Text

        self.cell, self.device = cell, device
        self.family = families.load(cell.config["family"])
        self.cfg = model_config(cell.config)
        self.dtype = served_dtype(cell.config)
        ns = argparse.Namespace(**{k: v for k, v in copy.deepcopy(cell.config["model"]).items()})
        ns.token_list = os.path.join(ROOT, ns.token_list) if isinstance(ns.token_list, str) else ns.token_list
        lm_ns = None
        if self.uses_lm and "lm" in cell.config:
            lm_ns = argparse.Namespace(**copy.deepcopy(cell.config["lm"]))
            lm_ns.token_list = ns.token_list
        self.engine = Speech2Text(ns, lm_config=lm_ns, device=device)
        self.load(seed)

    def load(self, seed: int) -> None:
        """Makes the weights of ``seed`` (``state``) and loads them into the program."""
        self.state = self.seeded_state(seed)
        self.engine.model.load_state_dict(self.state["model"], strict=True)
        if self.engine.lm is not None:
            self.engine.lm.load_state_dict(lm_keys(self.state["lm"]), strict=True)

    def seeded_state(self, seed: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """The benchmark's weights for ``seed`` in the served type: the
        model's and, where the entry uses it, the LM's."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        dt = DTYPES[self.dtype]
        vocab = self.cfg["vocab"]
        out = {"model": weights.seeded_state(weights.template_of(self.family.build(self.cfg, vocab)), seed,
                                             self.device, dt, gen)}
        if self.uses_lm and "lm" in self.cell.config:
            out["lm"] = weights.seeded_state(weights.template_of(self.family.build_lm(self.cell.config["lm"], vocab)),
                                             seed, self.device, dt, gen)
        return out

    def call(self, batch: Dict[str, np.ndarray]):
        raise NotImplementedError


def driver_class(entry: str) -> type:
    """The ``Driver`` of ``harness/entries/<entry>.py``."""
    return manifest.module("entries", entry).Driver


def make(cell, seed: int, device: torch.device) -> Driver:
    return driver_class(cell.traffic["entry"])(cell, seed, device)


def _read(path: str) -> int:
    mod, attr = path.split(":")
    obj = importlib.import_module(mod)
    for name in attr.split("."):
        obj = getattr(obj, name)
    return int(obj)


def kernel_counters(declared: Optional[Dict[str, str]] = None) -> Dict[str, int]:
    """The launch counters, ``LAUNCH_COUNTERS`` and the ``declared`` ones, by name."""
    return {name: _read(path) for name, path in dict(LAUNCH_COUNTERS, **(declared or {})).items()}
