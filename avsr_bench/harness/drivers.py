"""The system under test, driven through its entry points: one driver a
traffic ``entry``, each building the program from a configuration file,
loading the benchmark's seeded weights into it and making one call a
batch. The program's own modules are imported here and nowhere else in
the harness (the reference never imports them)."""

from __future__ import annotations

import argparse
import copy
import os
from typing import Dict, List

import numpy as np
import torch

from reference import model as ref_model

from . import weights
from .manifest import ROOT

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    entry a batch."""

    entry = ""

    def __init__(self, cell, seed: int, device: torch.device):
        from tailored_avsr_tpu_torch.inference import Speech2Text

        self.cell, self.device = cell, device
        self.cfg = model_config(cell.config)
        self.dtype = served_dtype(cell.config)
        ns = argparse.Namespace(**{k: v for k, v in copy.deepcopy(cell.config["model"]).items()})
        ns.token_list = os.path.join(ROOT, ns.token_list) if isinstance(ns.token_list, str) else ns.token_list
        lm_ns = None
        if self.uses_lm and "lm" in cell.config:
            lm_ns = argparse.Namespace(**copy.deepcopy(cell.config["lm"]))
            lm_ns.token_list = ns.token_list
        self.engine = Speech2Text(ns, lm_config=lm_ns, device=device)
        self.state = self.seeded_state(seed)
        self.engine.model.load_state_dict(self.state["model"], strict=True)
        if self.engine.lm is not None:
            self.engine.lm.load_state_dict(lm_keys(self.state["lm"]), strict=True)

    uses_lm = False

    def seeded_state(self, seed: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """The benchmark's weights for ``seed`` in the served type: the
        model's and, where the entry uses it, the LM's."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        dt = DTYPES[self.dtype]
        vocab = self.cfg["vocab"]
        out = {"model": weights.seeded_state(weights.template_of(ref_model.build(self.cfg, vocab)), seed,
                                             self.device, dt, gen)}
        if self.uses_lm and "lm" in self.cell.config:
            out["lm"] = weights.seeded_state(weights.template_of(ref_model.build_lm(self.cell.config["lm"], vocab)),
                                             seed, self.device, dt, gen)
        return out

    def call(self, batch: Dict[str, np.ndarray]):
        raise NotImplementedError


class Greedy(Driver):
    """``Speech2Text.greedy``: one transcript an utterance, on the host."""

    entry = "greedy"

    def call(self, batch):
        return self.engine.greedy(batch)


class NBest(Driver):
    """``Speech2Text.nbest``: the joint CTC/attention beam with LM fusion;
    per utterance its n-best [(text, tokens, ids, score)]."""

    entry = "nbest"
    uses_lm = True

    def call(self, batch):
        return self.engine.nbest(batch)


DRIVERS = {d.entry: d for d in (Greedy, NBest)}


def make(cell, seed: int, device: torch.device) -> Driver:
    entry = cell.traffic["entry"]
    if entry not in DRIVERS:
        raise KeyError(f"traffic entry {entry!r} has no driver; known: {sorted(DRIVERS)}")
    return DRIVERS[entry](cell, seed, device)


def kernel_counters() -> Dict[str, int]:
    """The kernel wrappers' launch counters (the program's own)."""
    from tailored_avsr_tpu_torch.ops import cache_update, flash_attention, fused_csgu, group_attend

    return {"K1": flash_attention.flash_attention_relpos.launches, "K2": flash_attention.flash_attention.launches,
            "K3": fused_csgu.fused_csgu.launches, "K4": group_attend.group_attend_anc.launches,
            "K5": cache_update.write_step_columns.launches, "K6": group_attend.group_attend_anc_q.launches}
