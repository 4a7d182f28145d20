"""The greedy check: every transcript the window served is held to the
reference's CTC log-probs of its utterance (``reference/ctc.minmax_gap``):
the widest gap over the distinct answers and their mean."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from reference import ctc as ref_ctc

from .. import check
from ..drivers import token_list


def greedy_texts(logps: Sequence[np.ndarray], tokens: Sequence[str]) -> List[str]:
    """Transcripts the log-probs' best paths give (the control's answers)."""
    return [ref_ctc.ids_to_text(ref_ctc.collapse(lp.argmax(axis=1)), tokens) for lp in logps]


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
    return dict(check.per_answer(gaps, threshold), ctc_gap_nats=float(gaps.max()), ctc_gap_mean=float(gaps.mean()),
                answers_checked=checked, answers_missing=missing)


def judge(cell, driver, pool, answers, device, threshold: float = float("inf")) -> Dict[str, float]:
    model = check.reference_model(driver, device)
    used = sorted({p for p, _ in answers})
    logps = {p: check.ctc_logprobs(driver.family, model, pool[p], device) for p in used}
    del model
    return judge_greedy(answers, logps, token_list(driver.cfg), threshold)


def alter_token(texts):
    """The fault ``a token altered where it is produced``: the middle
    character of the first non-empty transcript becomes another letter."""
    out = list(texts)
    for i, t in enumerate(out):
        if t:
            j = len(t) // 2
            out[i] = t[:j] + ("A" if t[j] != "A" else "E") + t[j + 1:]
            break
    return out


FAULTS = {"token_altered": alter_token, "half_batch": check.half_batch}


def readings(cell, driver, device, pool, threshold: float) -> dict:
    """Two passes of the pool (the timed entry, as a run calls it), the
    control's transcripts and the faults, against the reference's log-probs."""
    answers = [(p % len(pool), driver.call(pool[p % len(pool)])) for p in range(2 * len(pool))]
    tokens = token_list(driver.cfg)
    model = check.reference_model(driver, device)
    ref = {p: check.ctc_logprobs(driver.family, model, pool[p], device) for p in range(len(pool))}
    out = {"sound": judge_greedy(answers, ref, tokens, threshold)}
    control = check.CONTROL[driver.dtype]
    ctl = {p: greedy_texts(check.ctc_logprobs(driver.family, model, pool[p], device, control), tokens)
           for p in range(len(pool))}
    out["control"] = dict(judge_greedy(list(ctl.items()), ref, tokens, threshold), precision=control)
    for name, fault in FAULTS.items():
        out[name] = judge_greedy([(p, fault(t)) for p, t in answers], ref, tokens, threshold)
    return out
