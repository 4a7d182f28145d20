"""The reduction of a profiled window, on a synthetic trace."""

import sys
import types
from types import SimpleNamespace

import pytest
import torch

from harness import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _ev(name, start, end, device):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end), device_type=device)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_busy_spans_and_gaps():
    events = [
        _ev("avsr_bench/call", 0, 1000, CPU), _ev("avsr_bench/call", 0, 1000, CUDA),
        _ev("avsr_bench/encoder", 100, 400, CPU), _ev("avsr_bench/encoder", 150, 450, CUDA),
        _ev("gemm", 150, 250, CUDA), _ev("flash_attention_tc_kernel", 300, 450, CUDA),
        _ev("copy", 700, 800, CUDA),
    ]
    r = trace.Reduced(_Prof(events), window_s=1e-3, calls=1)
    assert r.busy_s == pytest.approx(350e-6)
    assert r.span_s["encoder"] == pytest.approx(250e-6) and r.span_count["encoder"] == 1
    assert r.span_ms_per_call("encoder") == pytest.approx(0.25) and r.span_ms_per_call("absent") is None
    assert r.kernels_matching("flash_attention") == pytest.approx(150e-6)
    assert r.idle_gaps[0] == ("call", pytest.approx(250e-6)) and r.idle_gaps[1][1] == pytest.approx(50e-6)
    assert "avsr_bench/call" not in dict(r.device_ops())


def test_spans_hook_the_matching_modules():
    model = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.Sequential(torch.nn.Linear(2, 2)))
    assert trace.module_paths(model, ["[0-9]"]) == ["0", "1"]
    handles = trace.install_spans(model, {"first": ["0"]})
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(torch.zeros(1, 2))
    assert any(e.name == "avsr_bench/first" for e in prof.events())
    for h in handles:
        h.remove()


def test_host_ranges_wrap_the_named_function_and_time_each_call(monkeypatch):
    mod = types.ModuleType("avsr_bench_fake_program")
    mod.search = lambda x: x + 1
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    timings = trace.install_host_ranges({"loop": mod.__name__ + ":search"}, torch.device("cpu"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert mod.search(1) == 2 and mod.search(2) == 3
    assert len(timings["loop"]) == 2 and all(t >= 0.0 for t in timings["loop"])
    assert sum(e.name == "avsr_bench/loop" for e in prof.events()) == 2
