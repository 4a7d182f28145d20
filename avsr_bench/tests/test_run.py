"""A run end to end on the CPU at tiny widths (the harness's look for a
card skipped), and with the timed path broken underneath: each fault a
cell can have turns ``correct`` false."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

import tiny
from harness import check, drivers, main

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
LIMITS = {"greedy": {"ctc_gap_nats": 1e-3, "ctc_gap_mean": 1e-4}, "nbest": {"beam_score_gap": 1e-4,
                                                                            "beam_score_gap_mean": 1e-5}}


def _run(c, monkeypatch, trace=False, fault=None):
    monkeypatch.setattr(check, "limits", lambda name: LIMITS[c.traffic["entry"]])
    if fault is not None:
        cls = drivers.driver_class(c.traffic["entry"])
        sound = cls.call
        monkeypatch.setattr(cls, "call", lambda self, batch: fault(sound(self, batch)))
    return main.measure(c, 2 ** 31 + 99, 0.5, trace, torch.device("cpu"), time.perf_counter())


def _alter_text(texts):
    return ["B" + t for t in texts]


def _alter_beam(hyps):
    first = hyps[0][0]
    return [[(first[0], first[1], [4] + list(first[2]), first[3])]] + hyps[1:]


def _half(out):
    return out[: len(out) // 2]


GREEDY = ("tailored_greedy_long", "asr_greedy_f32_long")


@pytest.mark.parametrize("name", GREEDY)
def test_a_sound_run_is_correct_and_reports_the_end_to_end_metrics(name, monkeypatch):
    c = tiny.cell(name, dtype="float32")
    result, compared = _run(c, monkeypatch)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in c.end_to_end}
    assert compared["ctc_gap_nats"]["limit"] == LIMITS["greedy"]["ctc_gap_nats"]


@pytest.mark.parametrize("name", GREEDY)
def test_a_traced_run_reports_no_device_metric_without_a_device(name, monkeypatch):
    result, _ = _run(tiny.cell(name, dtype="float32"), monkeypatch, trace=True)
    assert result["correct"] and "busy_s" in result["device"] and "breakdown" in result
    assert not any(k.startswith(("k1_roofline", "encoder_ms", "visual_frontend_ms")) for k in result["metrics"])


@pytest.mark.parametrize("fault", [_alter_text, _half], ids=["token_altered", "half_batch"])
@pytest.mark.parametrize("name", GREEDY)
def test_a_broken_greedy_path_is_not_correct(name, fault, monkeypatch):
    result, _ = _run(tiny.cell(name, dtype="float32"), monkeypatch, fault=fault)
    assert not result["correct"]


@pytest.mark.parametrize("entry,fault", [("greedy", _alter_text), ("nbest", _alter_beam)], ids=["greedy", "beam"])
def test_one_altered_answer_fails_the_per_answer_count_alone(entry, fault, monkeypatch):
    c = tiny.cell("tailored_greedy_long", dtype="float32") if entry == "greedy" else _beam_cell()
    only = {"answers_over_gap": 0, check.THRESHOLD: 1e-3}
    monkeypatch.setitem(LIMITS, entry, only)
    sound, _ = _run(c, monkeypatch)
    result, compared = _run(c, monkeypatch, fault=fault)
    assert sound["correct"] and not result["correct"] and compared["answers_over_gap"]["value"] >= 1, compared


def _beam_cell():
    from harness import manifest

    c = tiny.loose("tailored_avsr_es_bf16", "beam_512x4s", batch=3, seconds=1.2, dtype="float32")
    m = manifest.load_manifest()
    c.end_to_end = [e for e in m["end_to_end"] if e["name"] in ("setup_s", "beam_speech_per_s")]
    return c


@pytest.mark.parametrize("fault", [None, _alter_beam, _half], ids=["sound", "token_altered", "half_batch"])
def test_the_beam_path_is_judged_by_its_scores(fault, monkeypatch):
    result, compared = _run(_beam_cell(), monkeypatch, fault=fault)
    assert result["correct"] == (fault is None), compared


def test_no_card_no_result(tmp_path):
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", "tailored_greedy_long",
                          "--seed", str(2 ** 31 + 1), "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, cwd=ROOT)
    assert out.returncode != 0 and '"correct"' not in out.stdout


def test_the_benchmark_alone_is_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "avsr_bench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "avsr_bench/run.py", "--workload", "tailored_greedy_long", "--seed", "3",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and '"correct"' not in out.stdout
    assert not any(json.loads(line).get("correct") for line in out.stdout.splitlines() if line.startswith("{"))


def test_declared_launch_counters_are_read_by_name_beside_the_kernels():
    got = drivers.kernel_counters({"VS": "tailored_avsr_tpu_torch.ops.visual_stem:visual_stem.launches"})
    assert set(got) == {"K1", "K2", "K3", "K4", "K5", "K6", "VS"} and all(isinstance(v, int) for v in got.values())
