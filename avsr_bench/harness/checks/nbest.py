"""The beam check: every 1-best the window served is scored again by the
reference in full (``reference/model.hypothesis_scores``) and held to the
score the beam returned: the widest gap per token, and the mean gap."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from reference import model as ref_model
from reference import ops as ref_ops

from .. import check, drivers


def lm_reference(cell, driver, device):
    m = driver.family.build_lm(cell.config["lm"], driver.cfg["vocab"], device="meta")
    m.load_state_dict({k: v.float() for k, v in driver.state["lm"].items()}, assign=True)
    return m.to(device)


@torch.no_grad()
def beam_reference_scores(family, model, lm, cfg: Dict, batch: Dict[str, np.ndarray], rows: Sequence[int],
                          hyps: Sequence[Sequence[int]], device, precision: str = "f32") -> np.ndarray:
    """The reference's joint scores of ``hyps``, hypothesis j of utterance
    ``rows[j]``, computed in ``precision``."""
    inf = cfg["inference_conf"]
    dev_batch = check.to_device(batch, device)
    out = []
    step = family.ROWS * 16
    with ref_ops.precision(precision):
        for lo in range(0, len(rows), step):
            enc, lens = family.encode_rows(model, dev_batch, rows[lo:lo + step])
            out.append(ref_model.hypothesis_scores(model, lm, enc, lens, hyps[lo:lo + step], float(inf["ctc_weight"]),
                                                   float(inf["lm_weight"])).cpu().numpy())
    return np.concatenate(out)


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
    model = check.reference_model(driver, device)
    lm = lm_reference(cell, driver, device)
    out = {}
    for p in sorted({k[0] for k in keys}):
        mine = [k for k in keys if k[0] == p]
        ref = beam_reference_scores(driver.family, model, lm, driver.cfg, pool[p], [k[1] for k in mine],
                                    [list(k[2]) for k in mine], device, precision)
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
    gaps = check.score_gaps(got, want, lengths) if keys else np.array([np.inf])
    whole = check.score_gaps(got, want, np.zeros_like(lengths)) if keys else np.array([np.inf])
    return dict(check.per_answer(whole, threshold), beam_score_gap=float(gaps.max()),
                beam_score_gap_mean=float(whole.mean()), answers_checked=len(keys), tokens_checked=int(lengths.sum()),
                answers_missing=missing)


def judge(cell, driver, pool, answers, device, threshold: float = float("inf")) -> Dict[str, float]:
    return judge_beam(cell, driver, pool, answers, device, threshold=threshold)


def alter_hypothesis(hyps):
    """The beam's ``a token altered where it is produced``: the first
    utterance's 1-best gets another first token, its score kept."""
    text, toks, ids, score = hyps[0][0]
    return [[(text, toks, [4 if (ids[:1] or [0])[0] != 4 else 5] + list(ids[1:]), score)]] + list(hyps[1:])


def beam_readings(cell, driver, device, pool, answers, steps, threshold: float) -> dict:
    served = beam_answers(answers, pool, lambda p: range(len(answers[0][1])))
    ref = reference_scores(cell, driver, pool, list(served), device)
    out = {"sound": judge_beam(cell, driver, pool, answers, device, threshold=threshold, ref=ref)}
    control = reference_scores(cell, driver, pool, list(served), device, check.CONTROL[driver.dtype])
    out["control"] = dict(judge_beam(cell, driver, pool, answers, device, served=control, threshold=threshold,
                                     ref=ref), precision=check.CONTROL[driver.dtype])
    for name, fault in (("token_altered", alter_hypothesis), ("half_batch", check.half_batch)):
        out[name] = judge_beam(cell, driver, pool, [(p, fault(h)) for p, h in answers], device,
                               threshold=threshold, ref=ref)
    lengths = sorted(len(k[2]) for k in served)
    out["hypothesis_tokens"] = {"min": lengths[0], "median": lengths[len(lengths) // 2], "max": lengths[-1],
                                "sum": sum(lengths)}
    out["forced"] = sum(v <= check.FORCED for v in served.values())
    out["steps"] = steps
    return out


def readings(cell, driver, device, pool, threshold: float) -> dict:
    """One pass of the pool (the beam is deterministic: it serves what a
    window serves), each call's beam steps (the step write's launches),
    then the control and the faults against the reference's scores."""
    answers, steps = [], []
    for p in range(len(pool)):
        k5 = drivers.kernel_counters()["K5"]
        answers.append((p, driver.call(pool[p])))
        steps.append(drivers.kernel_counters()["K5"] - k5)
    return beam_readings(cell, driver, device, pool, answers, steps, threshold)
