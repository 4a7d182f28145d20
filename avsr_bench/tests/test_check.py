"""The judges of ``correct``: the CTC gap, the beam's score gap, the verdict."""

import math

import numpy as np
import pytest

from harness import check
from harness.checks.greedy import judge_greedy
from reference import ctc

TOKENS = ["<blank>", "<unk>", "<space>", "A", "B", "C", "<sos/eos>"]


def _logp(rng, t, v=len(TOKENS)):
    x = rng.standard_normal((t, v))
    return x - np.log(np.exp(x).sum(1, keepdims=True))


def test_text_round_trip():
    ids = [3, 2, 4, 1, 5, 6, 3]
    text = ctc.ids_to_text(ids, TOKENS)
    assert text == "A B<unk>C<sos/eos>A" and ctc.text_to_ids(text, TOKENS) == ids
    with pytest.raises(ValueError):
        ctc.text_to_ids("Z", TOKENS)


def test_the_best_path_has_no_gap_and_an_altered_token_has_one():
    rng = np.random.default_rng(0)
    lp = _logp(rng, 40)
    best = ctc.collapse(lp.argmax(1))
    assert ctc.minmax_gap(lp, best) == 0.0
    worst = int(lp.argmin(1)[20])
    altered = list(best)
    altered[len(best) // 2] = worst if worst != 0 else 3
    assert ctc.minmax_gap(lp, altered) > 0.0


def test_an_alignment_that_cannot_exist_is_inf():
    lp = _logp(np.random.default_rng(1), 3)
    assert math.isinf(ctc.minmax_gap(lp, [3, 3, 3]))
    assert ctc.minmax_gap(lp[:0], []) == 0.0


def test_a_near_tie_costs_its_margin():
    lp = np.log(np.full((4, len(TOKENS)), 0.01))
    lp[:, 0] = np.log(0.5)
    lp[2, 3] = np.log(0.49)
    assert ctc.minmax_gap(lp, []) == 0.0
    assert ctc.minmax_gap(lp, [3]) == pytest.approx(math.log(0.5 / 0.49))


def test_missing_answers_and_the_verdict():
    rng = np.random.default_rng(2)
    logps = {0: [_logp(rng, 10) for _ in range(4)]}
    texts = [ctc.ids_to_text(ctc.collapse(lp.argmax(1)), TOKENS) for lp in logps[0]]
    full = judge_greedy([(0, texts)], logps, TOKENS)
    half = judge_greedy([(0, texts[:2])], logps, TOKENS)
    assert full["ctc_gap_nats"] == 0.0 and full["answers_missing"] == 0 and half["answers_missing"] == 2
    assert check.verdict(full, {"ctc_gap_nats": 0.1})[0]
    assert not check.verdict(half, {"ctc_gap_nats": 0.1})[0]
    assert not check.verdict(full, {})[0]  # a cell with no limits is not correct
    assert check.verdict(full, {"ctc_gap_mean": 0.0})[0] and full["ctc_gap_mean"] == 0.0
    ok, compared = check.verdict(dict(full, ctc_gap_nats=0.2), {"ctc_gap_nats": 0.1})
    assert not ok and compared["ctc_gap_nats"] == {"value": 0.2, "limit": 0.1}


def test_score_gaps_per_token_and_forced_finishes():
    served = np.array([-10.0, -20.0, -1e9, -1e9])
    ref = np.array([-10.5, -20.0, -np.inf, -30.0])
    gaps = check.score_gaps(served, ref, np.array([4, 9, 100, 100]))
    assert gaps[0] == pytest.approx(0.1) and gaps[1] == 0.0 and gaps[2] == 0.0 and gaps[3] > 1e6


def test_one_answer_over_the_per_answer_threshold_fails_where_the_mean_holds():
    rng = np.random.default_rng(3)
    logps = {0: [_logp(rng, 12) for _ in range(40)]}
    texts = [ctc.ids_to_text(ctc.collapse(lp.argmax(1)), TOKENS) for lp in logps[0]]
    worst = [int(lp.argmin(1)[6]) or 3 for lp in logps[0][:1]]
    altered = [ctc.ids_to_text(worst, TOKENS)] + texts[1:]
    limit = {"ctc_gap_mean": 1.0, "answers_over_gap": 0, check.THRESHOLD: 0.5}
    sound = judge_greedy([(0, texts)], logps, TOKENS, limit[check.THRESHOLD])
    bad = judge_greedy([(0, altered)], logps, TOKENS, limit[check.THRESHOLD])
    assert sound["answers_over_gap"] == 0 and bad["answers_over_gap"] == 1
    assert bad["ctc_gap_mean"] < limit["ctc_gap_mean"] and bad["top_gaps"][0] > limit[check.THRESHOLD]
    ok, compared = check.verdict(sound, limit)
    assert ok and check.THRESHOLD not in compared and compared["answers_over_gap"] == {"value": 0, "limit": 0}
    assert not check.verdict(bad, limit)[0]
