"""On the card: each cell's control (the reference in the precision below
the configuration's, in the program's place) and half of the batch left
out fail the cell's limits, and the program passes them, on three seeds
at the cell's widths with a batch a test run can hold; so does one answer
altered where it is produced, in each cell that holds its widest gap.
(At full size one altered answer reads 0.76 nats and up in the flagship's
greedy cell, whose sound answers reach 1.11, so it holds the mean alone;
in the beam cell, with its fixed lengths, 1.13 and up against sound
answers up to 0.71, so its count of answers over 2.5 nats catches 11 of
16 seeds'.
``test_run.py`` plants that fault in every cell at tiny widths.)

python -m pytest avsr_bench/tests -q -m card   (on a machine with the card)
"""

import copy
import os
import sys

import pytest
import torch

from harness import check, drivers, manifest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import readings  # noqa: E402

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]
WIDEST = ("ctc_gap_nats", "beam_score_gap")  # numbers that one answer can fail
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_and_the_faults_fail_and_the_program_passes(name, card):
    cell = copy.deepcopy(manifest.cell(name))
    cell.traffic = dict(cell.traffic, batch=min(int(cell.traffic["batch"]), 64 if cell.traffic["entry"] == "nbest"
                                                else 8))
    limit = check.limits(name)
    driver = drivers.make(cell, SEEDS[0], card)
    for seed in SEEDS:
        r = readings.readings(cell, driver, seed, card)
        assert check.verdict(r["sound"], limit)[0], r["sound"]
        assert not check.verdict(r["control"], limit)[0], r["control"]
        if any(key in limit for key in WIDEST):
            assert not check.verdict(r["token_altered"], limit)[0], r["token_altered"]
        assert not check.verdict(r["half_batch"], limit)[0], r["half_batch"]
        assert all(r["control"][key] > lim for key, lim in limit.items()
                   if key not in (check.THRESHOLD, "answers_over_gap")), r["control"]
