"""The plain reference against the program at tiny widths on the CPU, on
the benchmark's seeded weights and traffic (float32)."""

import numpy as np
import pytest
import torch

import tiny
from harness import check, drivers, traffic
from harness.checks import greedy, nbest


def _driver(c, seed=3):
    return drivers.make(c, seed, torch.device("cpu"))


@pytest.mark.parametrize("name", ["tailored_greedy_long", "asr_greedy_f32_long"])
def test_encode_and_ctc_match_the_program(name):
    c = tiny.cell(name, dtype="float32")
    d = _driver(c)
    batch = traffic.make_pool(2 ** 31 + 3, c.traffic)[0]
    with torch.no_grad():
        enc, lens, _ = d.engine.model.encode(*d.engine.inputs(batch))
        got = torch.log_softmax(d.engine.model.ctc(enc).float(), -1)
    ref = check.reference_model(d, "cpu")
    want = check.ctc_logprobs(d.family, ref, batch, "cpu")
    assert [len(w) for w in want] == lens.tolist()
    for i, w in enumerate(want):
        np.testing.assert_allclose(got[i, :len(w)].numpy(), w, atol=2e-5, rtol=0)


def test_served_transcripts_have_no_gap_in_float32():
    c = tiny.cell("tailored_greedy_long", dtype="float32")
    d = _driver(c)
    pool = traffic.make_pool(11, c.traffic)
    answers = [(p, d.call(b)) for p, b in enumerate(pool)]
    ref = check.reference_model(d, "cpu")
    logps = {p: check.ctc_logprobs(d.family, ref, b, "cpu") for p, b in enumerate(pool)}
    got = greedy.judge_greedy(answers, logps, drivers.token_list(d.cfg))
    assert got["ctc_gap_nats"] < 1e-4 and got["answers_missing"] == 0
    assert got["answers_checked"] == sum(traffic.utterances(b) for b in pool)


def test_beam_scores_match_the_program():
    c = tiny.loose("tailored_avsr_es_bf16", "beam_512x4s", batch=3, seconds=1.2, dtype="float32")
    d = _driver(c, seed=5)
    pool = traffic.make_pool(5, c.traffic)
    answers = [(0, d.call(pool[0]))]
    got = nbest.judge_beam(c, d, pool, answers, "cpu")
    assert got["answers_checked"] == 3 and got["answers_missing"] == 0
    assert got["beam_score_gap"] < 1e-5


def test_lm_matches_the_program():
    c = tiny.loose("tailored_avsr_es_bf16", "beam_512x4s", batch=2, seconds=1.2, dtype="float32")
    d = _driver(c, seed=9)
    lm = nbest.lm_reference(c, d, "cpu")
    ys = torch.tensor([[36, 5, 7, 9], [36, 4, 4, 12]])
    with torch.no_grad():
        got = torch.log_softmax(d.engine.lm(ys, torch.tensor([4, 4])).float(), -1)
        want = lm(ys)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)
