"""The port's spans (``tailored_avsr_tpu_torch/utils/tracing.py``) on the
CPU at tiny widths: off by default and then invisible, on at the serving
path's layer boundaries with each child inside its parent, the beam's
steps and their phases counted exactly, the enabler's prefix on the
profiler's range names, a thread's own roots, results unchanged by
tracing, and the spans in ``avsr_main --profile-dir``'s trace."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from tailored_avsr_tpu_torch.inference import Speech2Text
from tailored_avsr_tpu_torch.utils import tracing
from tailored_avsr_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = os.path.join(ROOT, "tokenizers/char/spanish.txt")
PROGRAM = ("s2t.", "encode.", "beam.")
ENCODE = ("encode.audio_frontend", "encode.visual_frontend", "encode.visual_stem", "encode.encoder")


@pytest.fixture(autouse=True)
def _tracing_left_off():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    tracing.disable()
    torch.set_num_threads(threads)


def _avsr(**inference_conf):
    cfg = load_config(os.path.join(ROOT, "configs/tests/avsr_tiny.yaml"))
    cfg.token_list = TOKENS
    cfg.inference_conf = dict(cfg.inference_conf, **inference_conf)
    return Speech2Text(cfg, rng_seed=3, device="cpu")


def _asr():
    cfg = load_config(os.path.join(ROOT, "configs/ASR/branchformer_transformer+ctc_spanish.yaml"))
    cfg.token_list = TOKENS
    cfg.encoder_conf = dict(cfg.encoder_conf, output_size=32, linear_units=48, cgmlp_linear_units=48,
                            cgmlp_conv_kernel=7, num_blocks=2)
    cfg.decoder_conf = dict(cfg.decoder_conf, linear_units=48, num_blocks=1)
    return Speech2Text(cfg, rng_seed=3, device="cpu")


def _batch(task):
    rs = np.random.RandomState(5)
    audio = (rs.randn(2, 4480) * 0.1).astype(np.float32)
    audio_lengths = np.array([4480, 3520], np.int32)
    if task == "asr":
        return {"speech": audio, "speech_lengths": audio_lengths}
    return {"audio": audio, "audio_lengths": audio_lengths,
            "video": rs.randn(2, 7, 88, 88).astype(np.float32), "video_lengths": np.array([7, 5], np.int32)}


def _new_records(fn):
    """``fn()`` and the records of the calls it made."""
    seen = {r["id"] for r in tracing.records()}
    out = fn()
    return out, [r for r in tracing.records() if r["id"] not in seen]


def _names(spans, parent):
    return [s[0] for s in spans if s[1] == parent]


def _ancestors(spans, i):
    out = []
    while spans[i][1] >= 0:
        i = spans[i][1]
        out.append(spans[i][0])
    return out


def _assert_nested(spans):
    assert spans[0][1] == -1
    for name, parent, start, end in spans[1:]:
        assert 0 <= parent and spans[parent][2] <= start <= end <= spans[parent][3], name


def test_tracing_is_off_by_default_and_then_invisible():
    assert not tracing.enabled()
    assert tracing.span("s2t.inputs") is tracing.span("encode.encoder") is tracing.call("s2t.greedy")
    engine, batch = _avsr(), _batch("avsr")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, records = _new_records(lambda: engine.greedy(batch))
    assert records == []
    assert not [e.name for e in prof.events() if e.name.startswith(PROGRAM)]


@pytest.mark.parametrize("task", ["avsr", "asr"])
def test_a_greedy_call_leaves_one_root_with_its_layers_nested(task):
    engine, batch = (_avsr() if task == "avsr" else _asr()), _batch(task)
    tracing.enable()
    _, records = _new_records(lambda: engine.greedy(batch))
    assert len(records) == 1 and records[0]["entry"] == "s2t.greedy"
    spans = records[0]["spans"]
    _assert_nested(spans)
    assert _names(spans, 0) == ["s2t.inputs", "s2t.forward", "s2t.readback", "s2t.detokenize"]
    encode = {name for name, *_ in spans if name.startswith("encode.")}
    assert encode == (set(ENCODE) if task == "avsr" else {"encode.audio_frontend", "encode.encoder"})
    for i, (name, *_) in enumerate(spans):
        if name.startswith("encode."):
            assert "s2t.forward" in _ancestors(spans, i), name
    # the Branchformer's subsampling opens the audio frontend again, before the blocks
    if task == "asr":
        assert [s[0] for s in spans if s[0].startswith("encode.")] == [
            "encode.audio_frontend", "encode.audio_frontend", "encode.encoder"]
    assert tracing.count(records, "s2t.forward") == 1
    assert tracing.host_ms(records, "s2t.greedy") >= tracing.host_ms(records, "s2t.forward") > 0
    children = sum(tracing.host_ms(records, n) for n in _names(spans, 0))
    assert tracing.self_ms(records, "s2t.greedy") == pytest.approx(
        tracing.host_ms(records, "s2t.greedy") - children, abs=1e-6)


def test_a_fixed_length_beam_leaves_one_step_span_a_step_with_its_phases():
    lmax = 3
    engine, batch = _avsr(early_exit=False, maxlenratio=-float(lmax)), _batch("avsr")
    tracing.enable()
    _, records = _new_records(lambda: engine.nbest(batch))
    assert [r["entry"] for r in records] == ["s2t.nbest"]
    spans = records[0]["spans"]
    _assert_nested(spans)
    assert _names(spans, 0) == ["s2t.inputs", "s2t.forward", "beam.search", "s2t.readback", "s2t.detokenize"]
    search = [i for i, s in enumerate(spans) if s[0] == "beam.search"][0]
    assert _names(spans, search) == ["beam.step"] * lmax  # no early exit: no exit read
    for i, s in enumerate(spans):
        if s[0] == "beam.step":
            assert set(_names(spans, i)) == {"beam.score", "beam.ctc_prefix", "beam.select"}
    assert tracing.count(records, "beam.step") == lmax


def test_the_early_exit_read_is_a_child_of_the_search():
    engine, batch = _avsr(maxlenratio=-4.0), _batch("avsr")
    tracing.enable()
    _, records = _new_records(lambda: engine.nbest(batch))
    spans = records[0]["spans"]
    reads = [s for s in spans if s[0] == "beam.exit_read"]
    steps = tracing.count(records, "beam.step")
    assert steps >= 1 and len(reads) in (steps, steps + 1)
    assert {spans[s[1]][0] for s in reads} == {"beam.search"}


def test_the_prefix_names_the_profiler_ranges_and_a_second_thread_starts_its_own_root():
    engine, batch = _avsr(), _batch("avsr")
    tracing.enable(prefix="bench/")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        engine.greedy(batch)
    names = {e.name for e in prof.events()}
    assert {"bench/s2t.greedy", "bench/s2t.inputs", "bench/s2t.forward", *("bench/" + n for n in ENCODE)} <= names
    assert not [n for n in names if n.startswith(PROGRAM)]

    def upload():
        engine.device_put_batch(batch)

    with tracing.call("s2t.greedy"):
        seen = {r["id"] for r in tracing.records()}
        worker = threading.Thread(target=upload)
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        with tracing.span("s2t.readback"):
            pass
    records = [r for r in tracing.records() if r["id"] not in seen]
    assert [(r["entry"], [s[0] for s in r["spans"]]) for r in records] == [
        ("s2t.device_put", ["s2t.device_put"]), ("s2t.greedy", ["s2t.greedy", "s2t.readback"])]


@pytest.mark.parametrize("task,entry", [("avsr", "greedy"), ("asr", "greedy"), ("avsr", "nbest")])
def test_results_are_the_same_with_tracing_on_and_off(task, entry):
    engine = _avsr(nbest=2) if task == "avsr" else _asr()
    batch = _batch(task)
    off = getattr(engine, entry)(batch)
    tracing.enable(prefix="x/")
    on = getattr(engine, entry)(batch)
    assert on == off


def test_the_profile_dir_trace_shows_the_program_spans(tmp_path):
    import yaml

    from tailored_avsr_tpu_torch import avsr_main
    from tests.synthetic import make_synthetic_corpus

    csv_path, token_path = make_synthetic_corpus(str(tmp_path / "corpus"), n=2)
    with open(os.path.join(ROOT, "configs/tests/avsr_tiny.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["token_list"] = token_path
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    prof = str(tmp_path / "prof")
    avsr_main.main(["--config-file", cfg_path, "--test-dataset", csv_path, "--mode", "inference",
                    "--output-dir", str(tmp_path / "exp"), "--output-name", "t", "--device", "cpu",
                    "--profile-dir", prof])
    with open(os.path.join(prof, "trace.json")) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"s2t.nbest", "s2t.inputs", "s2t.forward", "beam.search", "beam.step"} <= names
    assert not tracing.enabled()
