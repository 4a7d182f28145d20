"""The readings the limits are set from, at tiny widths on the CPU: the
control and the planted faults read above the sound program."""

import os
import sys

import pytest
import torch

import tiny
from harness import drivers

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import readings  # noqa: E402


@pytest.mark.parametrize("cell", [
    lambda: tiny.cell("tailored_greedy_long", dtype="float32"),
    lambda: tiny.cell("asr_greedy_f32_long", dtype="float32"),
    lambda: tiny.loose("tailored_avsr_es_bf16", "beam_512x4s", batch=3, seconds=1.2, dtype="float32"),
], ids=["greedy_avsr", "greedy_asr", "beam"])
def test_faults_and_control_read_above_the_sound_program(cell):
    c = cell()
    d = drivers.make(c, 7, torch.device("cpu"))
    r = readings.readings(c, d, 2 ** 31 + 21, torch.device("cpu"))
    key = "beam_score_gap" if c.traffic["entry"] == "nbest" else "ctc_gap_nats"
    assert r["sound"][key] < 1e-4 and r["sound"]["answers_missing"] == 0
    assert r["token_altered"][key] > 10 * max(r["sound"][key], 1e-6)
    assert r["half_batch"]["answers_missing"] > 0
    assert key in r["control"]
