"""Readings that a cell's limits are set from (run on the card).

For each seed: the program's sound answers over two passes of the pool
(the timed entry, as a run calls it), then the control (the reference in
the nearest precision below the configuration's, put in the program's
place) and the planted faults, all judged as a run judges its window.

python3 avsr_bench/tools/readings.py --workload <cell> --seeds 11 12 13 [--out FILE]

Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

import torch  # noqa: E402

from harness import check, drivers, manifest  # noqa: E402
from harness import traffic as tf  # noqa: E402


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


def half_batch(texts):
    """The fault ``half of the batch left out``."""
    return list(texts)[: len(texts) // 2]


FAULTS = {"token_altered": alter_token, "half_batch": half_batch}


def alter_hypothesis(hyps):
    """The beam's ``a token altered where it is produced``: the first
    utterance's 1-best gets another first token, its score kept."""
    text, toks, ids, score = hyps[0][0]
    return [[(text, toks, [4 if (ids[:1] or [0])[0] != 4 else 5] + list(ids[1:]), score)]] + list(hyps[1:])


def beam_readings(cell, driver, seed: int, device, pool, answers, steps, threshold: float) -> dict:
    served = check.beam_answers(answers, pool, lambda p: range(len(answers[0][1])))
    ref = check.reference_scores(cell, driver, pool, list(served), device)
    out = {"seed": seed, "sound": check.judge_beam(cell, driver, pool, answers, device, threshold=threshold, ref=ref)}
    control = check.reference_scores(cell, driver, pool, list(served), device, check.CONTROL[driver.dtype])
    out["control"] = dict(check.judge_beam(cell, driver, pool, answers, device, served=control, threshold=threshold,
                                           ref=ref), precision=check.CONTROL[driver.dtype])
    for name, fault in (("token_altered", alter_hypothesis), ("half_batch", half_batch)):
        out[name] = check.judge_beam(cell, driver, pool, [(p, fault(h)) for p, h in answers], device,
                                     threshold=threshold, ref=ref)
    lengths = sorted(len(k[2]) for k in served)
    out["hypothesis_tokens"] = {"min": lengths[0], "median": lengths[len(lengths) // 2], "max": lengths[-1],
                                "sum": sum(lengths)}
    out["forced"] = sum(v <= check.FORCED for v in served.values())
    out["steps"] = steps
    return out


def readings(cell, driver, seed: int, device) -> dict:
    driver.state = driver.seeded_state(seed)
    driver.engine.model.load_state_dict(driver.state["model"], strict=True)
    if driver.engine.lm is not None:
        driver.engine.lm.load_state_dict(drivers.lm_keys(driver.state["lm"]), strict=True)
    pool = tf.make_pool(seed, cell.traffic)
    threshold = float(check.limits(cell.name).get(check.THRESHOLD, float("inf")))
    if cell.traffic["entry"] == "nbest":  # the beam is deterministic: one pass serves what a window serves
        answers, steps = [], []
        for p in range(len(pool)):
            k5 = drivers.kernel_counters()["K5"]
            answers.append((p, driver.call(pool[p])))
            steps.append(drivers.kernel_counters()["K5"] - k5)
        return beam_readings(cell, driver, seed, device, pool, answers, steps, threshold)
    answers = [(p % len(pool), driver.call(pool[p % len(pool)])) for p in range(2 * len(pool))]
    tokens = drivers.token_list(driver.cfg)
    model = check.reference_model(driver.cfg, driver.state["model"], device)
    ref = {p: check.ctc_logprobs(model, driver.cfg, pool[p], device) for p in range(len(pool))}
    out = {"seed": seed, "sound": check.judge_greedy(answers, ref, tokens, threshold)}
    control = check.CONTROL[driver.dtype]
    ctl = {p: check.greedy_texts(check.ctc_logprobs(model, driver.cfg, pool[p], device, control), tokens)
           for p in range(len(pool))}
    out["control"] = dict(check.judge_greedy(list(ctl.items()), ref, tokens, threshold), precision=control)
    for name, fault in FAULTS.items():
        out[name] = check.judge_greedy([(p, fault(t)) for p, t in answers], ref, tokens, threshold)
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out")
    args = p.parse_args()
    cell = manifest.cell(args.workload)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    driver = drivers.make(cell, args.seeds[0], device)
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = dict(readings(cell, driver, seed, device), workload=cell.name, seconds=time.perf_counter() - t0)
        print(json.dumps(r), flush=True)
        lines.append(r)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a", encoding="utf-8") as f:
            f.writelines(json.dumps(r) + "\n" for r in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
