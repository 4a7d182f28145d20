"""Deciding ``correct``: what the window served, judged against the plain
reference run on the same weights and inputs once the window has closed.

The judge is found by name: a traffic file's ``check`` (its ``entry`` by
default) names ``harness/checks/<check>.py`` (``find``), whose
``judge(cell, driver, pool, answers, device, threshold)`` returns the
numbers of a window's answers and whose ``readings(cell, driver, device,
pool, threshold)`` gives the sound, control and fault readings that
``tools/readings.py`` sets the limits from. ``greedy`` holds every
transcript to the reference's CTC log-probs of its utterance; ``nbest``
scores every 1-best again in full and holds it to the score the beam
returned. Each counts the answers whose own gap exceeds the cell's
per-answer threshold (``answers_over_gap``), so that one wrong answer
among a thousand fails the run where a mean would not move. An utterance
left without an answer fails the run.

Each cell compares the numbers its ``limits/<cell>.json`` names, each
against its limit, set from readings of sound runs and of the control
(the reference in the nearest precision below the configuration's, put
in the program's place; the readings are in PERF.md). The file's
``per_answer_gap`` is not compared: it is the threshold of
``answers_over_gap``. The helpers the checks share are here.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from reference import ops as ref_ops

from . import manifest
from .manifest import BENCH_DIR

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}  # the nearest precision below the configuration's
THRESHOLD = "per_answer_gap"  # a limits file's key that sets answers_over_gap's threshold, not a limit


def find(traffic: Dict):
    """The check module of a traffic mix: its ``check``, else its ``entry``."""
    return manifest.module("checks", traffic.get("check", traffic["entry"]))


def judge(cell, driver, pool, answers, device, threshold: float = float("inf")) -> Dict[str, float]:
    """The numbers of a window's ``answers`` ((pool index, output) a call),
    with ``threshold`` as the per-answer gap's."""
    return find(cell.traffic).judge(cell, driver, pool, answers, device, threshold)


def limits(cell_name: str) -> Dict[str, float]:
    path = os.path.join(BENCH_DIR, "limits", f"{cell_name}.json")
    if not os.path.isfile(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def reference_model(driver, device) -> torch.nn.Module:
    """The reference of the driver's family with its seeded weights, in float32."""
    m = driver.family.build(driver.cfg, driver.cfg["vocab"], device="meta")
    m.load_state_dict({k: v.float() if v.is_floating_point() else v for k, v in driver.state["model"].items()},
                      assign=True)
    return m.to(device)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device).long() if k.endswith("lengths")
            else torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()
            if k not in ("text", "text_lengths")}


@torch.no_grad()
def ctc_logprobs(family, model, batch: Dict[str, np.ndarray], device, precision: str = "f32") -> List[np.ndarray]:
    """Per utterance the reference's (T_i, V) CTC log-probs over its valid
    frames, computed in blocks of ``family.ROWS`` rows in ``precision``."""
    dev_batch = to_device(batch, device)
    n = len(next(iter(dev_batch.values())))
    step = family.ROWS
    out: List[np.ndarray] = []
    with ref_ops.precision(precision):
        for lo in range(0, n, step):
            enc, lens = family.encode_rows(model, dev_batch, range(lo, min(n, lo + step)))
            lp = family.ctc_log_probs(model, enc).double().cpu().numpy()
            out += [lp[i, :int(t)] for i, t in enumerate(lens.tolist())]
    return out


def per_answer(gaps: np.ndarray, threshold: float) -> Dict:
    """The answers whose gap exceeds ``threshold``, and the five widest gaps."""
    return {"answers_over_gap": int((gaps > threshold).sum()),
            "top_gaps": sorted(gaps.tolist(), reverse=True)[:5]}


def verdict(numbers: Dict[str, float], limit: Dict[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """Each number the cell's limits name, and the answers missing (limit
    0), beside its limit; correct when every one is within it. A cell
    with no limits is not correct."""
    compared = dict({k: v for k, v in limit.items() if k != THRESHOLD}, answers_missing=0)
    out, ok = {}, bool(limit)
    for name, lim in compared.items():
        value = numbers.get(name, float("inf"))
        ok &= bool(np.isfinite(value) and value <= lim)
        out[name] = {"value": value, "limit": lim}
    return ok, out


FORCED = -1.0e8  # a score this low is a forced finish that CTC cannot align


def score_gaps(served: np.ndarray, ref: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """|served - reference| per token (eos counted); 0 where both sides find
    the hypothesis unalignable by CTC."""
    both_forced = (served <= FORCED) & ~np.isfinite(ref)
    gap = np.abs(served - ref) / (lengths + 1)
    return np.where(both_forced, 0.0, np.where(np.isnan(gap), np.inf, gap))


def half_batch(out):
    """The fault ``half of the batch left out``, of any entry's answers."""
    return list(out)[: len(out) // 2]
