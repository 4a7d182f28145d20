"""The readers of the program's own spans: a traced run on the CPU at tiny
widths reports the host-ms span metrics and no device-ms one, and the
program's ranges under the benchmark's prefix leave the device's busy
time as it was."""

from types import SimpleNamespace

import pytest
import torch

import tiny
from harness import manifest, program_spans, trace
from test_run import _beam_cell, _run
from test_trace import CPU, CUDA, _ev, _Prof

from tailored_avsr_tpu_torch.utils import tracing


def _span_metrics(cell):
    return [m for m in manifest.load_manifest()["per_layer"]
            if m["source"] == "program_span" and cell in m.get("workloads", ())]


def test_importing_the_readers_turns_the_spans_on_under_the_prefix():
    assert program_spans.tracing is tracing and tracing.enabled()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.call("s2t.greedy"), tracing.span("s2t.inputs"):
            pass
    assert {trace.PREFIX + "s2t.greedy", trace.PREFIX + "s2t.inputs"} <= {e.name for e in prof.events()}


@pytest.mark.parametrize("name,host", [
    ("tailored_greedy_long", ("upload_ms.greedy", "enqueue_ms.greedy")),
    ("asr_greedy_f32_long", ("upload_ms.greedy", "enqueue_ms.greedy")),
    ("tailored_beam_lm", ("upload_ms.beam", "beam_score_ms.beam", "beam_ctc_ms.beam", "beam_select_ms.beam",
                          "beam_exit_wait_ms.beam")),
])
def test_a_traced_cpu_run_reports_the_host_span_metrics_and_no_device_one(name, host, monkeypatch):
    tracing.enable(prefix=trace.PREFIX)
    if name == "tailored_beam_lm":
        c = _beam_cell()
        c.per_layer = _span_metrics(name)
    else:
        c = tiny.cell(name, dtype="float32")
    assert set(host) <= {m["name"] for m in c.per_layer}
    result, _ = _run(c, monkeypatch, trace=True)
    assert result["correct"]
    metrics = result["metrics"]
    for m in host:
        assert metrics[m]["value"] > 0 and metrics[m]["unit"] == "ms", m
    assert not [k for k in metrics if "_span_ms" in k]


def test_the_window_is_the_last_calls_of_the_entry():
    tracing.enable(prefix=trace.PREFIX)
    for entry in ("s2t.greedy", "s2t.nbest", "s2t.greedy", "s2t.greedy"):
        with tracing.call(entry), tracing.span("s2t.inputs"):
            pass
    run = SimpleNamespace(calls=2, traffic={"entry": "greedy"})
    last = [r for r in tracing.records() if r["entry"] == "s2t.greedy"][-2:]
    assert program_spans.window(run) == last
    assert program_spans.ms_per_call(run, "s2t.inputs") == pytest.approx(tracing.host_ms(last, "s2t.inputs") / 2)
    assert program_spans.ms_per_call(run, "s2t.absent") is None
    assert program_spans.ms_per_step(run, "s2t.inputs") is None  # no beam step in the window


def test_program_ranges_under_the_prefix_leave_the_busy_time_as_it_was():
    kernels = [_ev("avsr_bench/call", 0, 1000, CPU), _ev("avsr_bench/call", 0, 1000, CUDA),
               _ev("gemm", 150, 250, CUDA), _ev("conv", 300, 450, CUDA), _ev("copy", 700, 800, CUDA)]
    program = [_ev("avsr_bench/s2t.forward", 100, 600, CPU), _ev("avsr_bench/s2t.forward", 140, 460, CUDA),
               _ev("avsr_bench/encode.encoder", 280, 460, CPU), _ev("avsr_bench/encode.encoder", 290, 455, CUDA)]
    plain = trace.Reduced(_Prof(kernels), window_s=1e-3, calls=1)
    spanned = trace.Reduced(_Prof(kernels + program), window_s=1e-3, calls=1)
    assert spanned.busy_s == plain.busy_s == pytest.approx(350e-6)
    assert spanned.kernel_s == plain.kernel_s
    assert spanned.span_ms_per_call("encode.encoder") == pytest.approx(0.15)
    assert spanned.span_ms_per_call("s2t.forward") == pytest.approx(0.25)
    # each gap is named by the innermost range the host was in when it opened
    assert [n for n, _ in plain.idle_gaps] == ["call", "call"]
    assert spanned.idle_gaps == [("encode.encoder", pytest.approx(250e-6)), ("s2t.forward", pytest.approx(50e-6))]


def _id_ev(name, start, end, device, corr):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end), device_type=device, id=corr)


def test_device_time_under_a_span_counts_what_its_nested_ranges_launched():
    """The profiler gives each kernel to the innermost range, and links no
    ctypes launch to a host op: a program span around the benchmark's hook
    ranges reads the kernels launched inside its host interval, by the
    runtime call that shares each kernel's correlation id, and no range's
    own device-side annotation."""
    events = [
        _id_ev("avsr_bench/s2t.forward", 0, 100, CPU, 1), _id_ev("avsr_bench/encode.encoder", 10, 90, CPU, 2),
        _id_ev("avsr_bench/encoder", 30, 80, CPU, 3),
        _id_ev("cudaLaunchKernel", 12, 13, CPU, 10), _id_ev("lt", 200, 202, CUDA, 10),
        _id_ev("cudaLaunchKernel", 40, 41, CPU, 11), _id_ev("flash_attention_kernel", 205, 275, CUDA, 11),
        _id_ev("cudaLaunchKernel", 85, 86, CPU, 12), _id_ev("add", 280, 285, CUDA, 12),
        _id_ev("cudaMemcpyAsync", 95, 96, CPU, 13), _id_ev("Memcpy HtoD", 290, 300, CUDA, 13),
        _id_ev("avsr_bench/encode.encoder", 200, 202, CUDA, 2), _id_ev("avsr_bench/encoder", 205, 275, CUDA, 3),
        _id_ev("cudaLaunchKernel", 150, 151, CPU, 14), _id_ev("copy", 400, 401, CUDA, 14),
    ]
    got = program_spans.launched_device_s(events)
    assert got == pytest.approx({"s2t.forward": 87e-6, "encode.encoder": 77e-6, "encoder": 70e-6})
    reduced = trace.Reduced(_Prof(events), window_s=1e-3, calls=2)
    assert reduced.program_device_s == got
    assert reduced.span_ms_per_call("encode.encoder") == pytest.approx(0.001)  # the annotation: `lt` alone
    run = SimpleNamespace(trace=reduced, calls=2)
    assert program_spans.device_ms_per_call(run, "encode.encoder") == pytest.approx(0.0385)
    assert program_spans.device_ms_per_call(run, "encode.absent") is None
