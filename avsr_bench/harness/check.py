"""Deciding ``correct``: what the window served, judged against the plain
reference run on the same weights and inputs once the window has closed.

Greedy cells: every transcript the window served is held to the
reference's CTC log-probs of its utterance (``reference/ctc.minmax_gap``):
the widest gap over the distinct answers and their mean. Beam cells:
every 1-best the window served is scored again by the reference in full
(``reference/model.hypothesis_scores``) and held to the score the beam
returned: the widest gap per token, and the mean gap. Both count the
answers whose own gap exceeds the cell's per-answer threshold
(``answers_over_gap``), so that one wrong answer among a thousand fails
the run where a mean would not move. An utterance left without an answer
fails the run.

Each cell compares the numbers its ``limits/<cell>.json`` names, each
against its limit, set from readings of sound runs and of the control
(``tools/readings.py``; the readings are in PERF.md). The file's
``per_answer_gap`` is not compared: it is the threshold of
``answers_over_gap``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from reference import ctc as ref_ctc
from reference import model as ref_model
from reference import ops as ref_ops

from .manifest import BENCH_DIR

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}  # the nearest precision below the configuration's
ROWS = {"avsr": 4, "asr": 16}  # utterances a block of the reference
THRESHOLD = "per_answer_gap"  # a limits file's key that sets answers_over_gap's threshold, not a limit


def limits(cell_name: str) -> Dict[str, float]:
    path = os.path.join(BENCH_DIR, "limits", f"{cell_name}.json")
    if not os.path.isfile(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def reference_model(cfg: Dict, state: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """The reference with the seeded weights, in float32."""
    m = ref_model.build(cfg, cfg["vocab"], device="meta")
    m.load_state_dict({k: v.float() if v.is_floating_point() else v for k, v in state.items()}, assign=True)
    return m.to(device)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device).long() if k.endswith("lengths")
            else torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()
            if k not in ("text", "text_lengths")}


@torch.no_grad()
def ctc_logprobs(model, cfg: Dict, batch: Dict[str, np.ndarray], device, precision: str = "f32") -> List[np.ndarray]:
    """Per utterance the reference's (T_i, V) CTC log-probs over its valid
    frames, computed in blocks of rows in ``precision``."""
    dev_batch = to_device(batch, device)
    n = len(next(iter(dev_batch.values())))
    step = ROWS[cfg["task"]]
    out: List[np.ndarray] = []
    with ref_ops.precision(precision):
        for lo in range(0, n, step):
            enc, lens = ref_model.encode_rows(model, dev_batch, range(lo, min(n, lo + step)))
            lp = ref_model.ctc_log_probs(model, enc).double().cpu().numpy()
            out += [lp[i, :int(t)] for i, t in enumerate(lens.tolist())]
    return out


def greedy_texts(logps: Sequence[np.ndarray], tokens: Sequence[str]) -> List[str]:
    """Transcripts the log-probs' best paths give (the control's answers)."""
    return [ref_ctc.ids_to_text(ref_ctc.collapse(lp.argmax(axis=1)), tokens) for lp in logps]


def per_answer(gaps: np.ndarray, threshold: float) -> Dict:
    """The answers whose gap exceeds ``threshold``, and the five widest gaps."""
    return {"answers_over_gap": int((gaps > threshold).sum()),
            "top_gaps": sorted(gaps.tolist(), reverse=True)[:5]}


def judge_greedy(calls: Sequence[Tuple[int, List[str]]], ref_logps: Sequence[Sequence[np.ndarray]],
                 tokens: Sequence[str], threshold: float = float("inf")) -> Dict[str, float]:
    """``calls``: (pool index, transcripts) of every call in the window;
    ``ref_logps[p]``: the reference's log-probs of pool batch p. Returns
    the widest gap, the mean, the answers over ``threshold``, the answers
    checked and the answers missing."""
    seen: Dict[Tuple[int, int, str], float] = {}
    missing = checked = 0
    for p, texts in calls:
        want = len(ref_logps[p])
        missing += max(0, want - len(texts))
        for i, text in enumerate(texts[:want]):
            key = (p, i, text)
            if key not in seen:
                try:
                    ids = ref_ctc.text_to_ids(text, tokens)
                    seen[key] = ref_ctc.minmax_gap(ref_logps[p][i], ids)
                except ValueError:
                    seen[key] = float("inf")
            checked += 1
    gaps = np.array(list(seen.values()) or [np.inf])
    return dict(per_answer(gaps, threshold), ctc_gap_nats=float(gaps.max()), ctc_gap_mean=float(gaps.mean()),
                answers_checked=checked, answers_missing=missing)


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


def lm_reference(cell, driver, device):
    m = ref_model.build_lm(cell.config["lm"], driver.cfg["vocab"], device="meta")
    m.load_state_dict({k: v.float() for k, v in driver.state["lm"].items()}, assign=True)
    return m.to(device)


@torch.no_grad()
def beam_reference_scores(model, lm, cfg: Dict, batch: Dict[str, np.ndarray], rows: Sequence[int],
                          hyps: Sequence[Sequence[int]], device, precision: str = "f32") -> np.ndarray:
    """The reference's joint scores of ``hyps``, hypothesis j of utterance
    ``rows[j]``, computed in ``precision``."""
    inf = cfg["inference_conf"]
    dev_batch = to_device(batch, device)
    out = []
    step = ROWS[cfg["task"]] * 16
    with ref_ops.precision(precision):
        for lo in range(0, len(rows), step):
            enc, lens = ref_model.encode_rows(model, dev_batch, rows[lo:lo + step])
            out.append(ref_model.hypothesis_scores(model, lm, enc, lens, hyps[lo:lo + step], float(inf["ctc_weight"]),
                                                   float(inf["lm_weight"])).cpu().numpy())
    return np.concatenate(out)


FORCED = -1.0e8  # a score this low is a forced finish that CTC cannot align


def score_gaps(served: np.ndarray, ref: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """|served - reference| per token (eos counted); 0 where both sides find
    the hypothesis unalignable by CTC."""
    both_forced = (served <= FORCED) & ~np.isfinite(ref)
    gap = np.abs(served - ref) / (lengths + 1)
    return np.where(both_forced, 0.0, np.where(np.isnan(gap), np.inf, gap))


def beam_answers(answers, pool, rows_of) -> Dict[Tuple[int, int, Tuple[int, ...]], float]:
    """The distinct (pool batch, utterance, ids) -> served score of every
    sampled utterance's 1-best in the window's ``answers``."""
    out: Dict = {}
    for p, hyps in answers:
        for i in rows_of(p):
            if i < len(hyps) and hyps[i]:
                out.setdefault((p, i, tuple(hyps[i][0][2])), float(hyps[i][0][3]))
    return out


def reference_scores(cell, driver, pool, keys, device, precision: str = "f32") -> Dict:
    """The reference's joint score of each (pool batch, utterance, ids) key."""
    model = reference_model(driver.cfg, driver.state["model"], device)
    lm = lm_reference(cell, driver, device)
    out = {}
    for p in sorted({k[0] for k in keys}):
        mine = [k for k in keys if k[0] == p]
        ref = beam_reference_scores(model, lm, driver.cfg, pool[p], [k[1] for k in mine], [list(k[2]) for k in mine],
                                    device, precision)
        out.update(zip(mine, ref.tolist()))
    return out


def judge_beam(cell, driver, pool, answers, device, served=None, threshold: float = float("inf"),
               ref=None) -> Dict[str, float]:
    """The widest per-token score gap, the mean gap and the answers whose
    gap exceeds ``threshold`` over every distinct answer of the window;
    ``served`` replaces the window's scores (the control's); ``ref``
    holds reference scores already computed, by key."""
    rows = range(len(pool[0]["video_lengths" if "video_lengths" in pool[0] else "speech_lengths"]))
    missing = sum(max(0, len(pool[p]["video_lengths" if "video_lengths" in pool[p] else "speech_lengths"])
                      - sum(1 for h in hyps if h)) for p, hyps in answers)
    served = beam_answers(answers, pool, lambda p: rows) if served is None else served
    keys = list(served)
    ref = dict(ref or {})
    todo = [k for k in keys if k not in ref]
    if todo:
        ref.update(reference_scores(cell, driver, pool, todo, device))
    got, want = np.array([served[k] for k in keys]), np.array([ref[k] for k in keys])
    lengths = np.array([len(k[2]) for k in keys])
    gaps = score_gaps(got, want, lengths) if keys else np.array([np.inf])
    whole = score_gaps(got, want, np.zeros_like(lengths)) if keys else np.array([np.inf])
    return dict(per_answer(whole, threshold), beam_score_gap=float(gaps.max()),
                beam_score_gap_mean=float(whole.mean()), answers_checked=len(keys), tokens_checked=int(lengths.sum()), answers_missing=missing)


def judge(cell, driver, pool, answers, device, threshold: float = float("inf")) -> Dict[str, float]:
    """The numbers of a window's ``answers`` ((pool index, output) a call),
    with ``threshold`` as the per-answer gap's."""
    from .drivers import token_list

    entry = cell.traffic["entry"]
    if entry == "nbest":
        return judge_beam(cell, driver, pool, answers, device, threshold=threshold)
    if entry != "greedy":
        raise NotImplementedError(f"no check for entry {entry!r}")
    model = reference_model(driver.cfg, driver.state["model"], device)
    used = sorted({p for p, _ in answers})
    logps = {p: ctc_logprobs(model, driver.cfg, pool[p], device) for p in used}
    del model
    return judge_greedy(answers, logps, token_list(driver.cfg), threshold)
