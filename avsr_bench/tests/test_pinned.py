"""Readings pinned from the harness as it was before families, checks and
entries were found by name (each model, check and FLOP count was then
chosen by a branch on the task or the entry), so that they hold after the
move: each cell's seeded template (names, shapes and order) and its
weights at one seed, at tiny widths in float32; its FLOPs a call and the
encoder's padded length at the published sizes; and the check's numbers
of one tiny CPU run of each entry, on one thread (so that every sum runs
in one order). The beam's check numbers were read again once the
configuration fixed the beam's lengths."""

import hashlib

import pytest
import torch

import tiny
from harness import check, drivers, families, manifest
from harness import traffic as tf

SEED = 2 ** 31 + 77
AVSR_STATE = {"n": 280, "template": "dcddeda5fe1e7fee8ed2f74303a6e242f79004c32a3b7803f1eaaed8749cfa94",
              "values": "95866c6c91f01595859f9d4fa6417cbc5f0e61b1379aa8914c36dfe75aae5d27"}
PINNED = {
    "tailored_greedy_long": {
        "flops_per_call": 9524183424768.0, "frames": 500, "state": {"model": AVSR_STATE},
        "judge": {"answers_over_gap": 0, "top_gaps": [0.0, 0.0, 0.0, 0.0, 0.0], "ctc_gap_nats": 0.0,
                  "ctc_gap_mean": 0.0, "answers_checked": 9, "answers_missing": 0}},
    "tailored_beam_lm": {
        "flops_per_call": 40099055616000.0, "frames": 100,
        "state": {"model": AVSR_STATE,
                  "lm": {"n": 41, "template": "6df9b1a15a55e1f11f6af943ea6be67b836133ec0c37efe57c86c0c9e7601ab8",
                         "values": "fd3395d62050e13567d24354d50f05f7c6a8679ab0108bdbaf296d6416feece0"}},
        # read with the configuration's fixed beam lengths (minlenratio 0.115, maxlenratio -12)
        "judge": {"answers_over_gap": 0,
                  "top_gaps": [1.2225170067381441e-06, 7.768465977164851e-07, 5.145605044276635e-07,
                               4.168460279174724e-07, 3.057088520108664e-07],
                  "beam_score_gap": 2.5894886590549504e-07, "beam_score_gap_mean": 5.683549015126724e-07,
                  "answers_checked": 6, "tokens_checked": 18, "answers_missing": 0}},
    "asr_greedy_f32_long": {
        "flops_per_call": 3594432686080.0, "frames": 499,
        "state": {"model": {"n": 135, "template": "b0f37ae8db14e2e7a7180c84f25c1ef79c4f862a785160ba1bac1a8141386992",
                            "values": "20cbcc809b0a0e42d549095c799e2820614874eb383841d4a4bd17fd6e1c9203"}},
        "judge": {"answers_over_gap": 0, "top_gaps": [0.0, 0.0, 0.0, 0.0, 0.0], "ctc_gap_nats": 0.0,
                  "ctc_gap_mean": 0.0, "answers_checked": 9, "answers_missing": 0}},
}


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _digest(state):
    listing = ";".join(f"{k}:{tuple(v.shape)}:{v.dtype}" for k, v in state.items())
    values = hashlib.sha256()
    for v in state.values():
        values.update(v.contiguous().view(torch.uint8).numpy().tobytes() if v.dtype.is_floating_point
                      else v.numpy().tobytes())
    return {"n": len(state), "template": hashlib.sha256(listing.encode()).hexdigest(), "values": values.hexdigest()}


@pytest.mark.parametrize("name", list(PINNED))
def test_the_flops_and_frames_of_a_call_at_the_published_sizes(name):
    cell = manifest.cell(name)
    family = families.load(cell.config["family"])
    cfg = drivers.model_config(cell.config)
    assert family.call_flops(cfg, cell.traffic) == PINNED[name]["flops_per_call"]
    assert family.encoder_frames(cfg, *tf.buffer(cell.traffic)) == PINNED[name]["frames"]


@pytest.mark.parametrize("name", list(PINNED))
def test_the_seeded_weights_and_the_check_of_a_tiny_run(name, one_thread):
    c = tiny.cell(name, dtype="float32")
    d = drivers.make(c, SEED, torch.device("cpu"))
    assert {k: _digest(v) for k, v in d.state.items()} == PINNED[name]["state"]
    pool = tf.make_pool(SEED, c.traffic)
    answers = [(p, d.call(b)) for p, b in enumerate(pool)]
    assert check.judge(c, d, pool, answers, torch.device("cpu"), 1e-3) == PINNED[name]["judge"]
