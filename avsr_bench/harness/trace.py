"""The traced run: ``torch.profiler`` over the window, with
``record_function`` ranges that the benchmark's own forward hooks put
around the program's modules and that its own wrappers put around the
program's functions, reduced to device busy time, device time under each
range (the operations inside the device-side interval the profiler
annotates for the range), kernel time by name, and the longest idle gaps
named by the range the host was in."""

from __future__ import annotations

import bisect
import fnmatch
import importlib
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

PREFIX = "avsr_bench/"
CALL = PREFIX + "call"


def module_paths(model: torch.nn.Module, patterns: Iterable[str]) -> List[str]:
    names = [n for n, _ in model.named_modules() if n]
    return [n for n in names if any(fnmatch.fnmatchcase(n, p) for p in patterns)]


def install_spans(model: torch.nn.Module, spans: Dict[str, Iterable[str]]) -> List:
    """A ``record_function`` range ``avsr_bench/<span>`` around every call of
    each module whose path matches one of the span's patterns. Returns
    the hook handles."""
    handles = []
    modules = dict(model.named_modules())
    for span, patterns in spans.items():
        for path in module_paths(model, patterns):
            stack: List = []

            def pre(_m, _args, span=span, stack=stack):
                rf = torch.autograd.profiler.record_function(PREFIX + span)
                rf.__enter__()
                stack.append(rf)

            def post(_m, _args, _out, stack=stack):
                stack.pop().__exit__(None, None, None)

            handles += [modules[path].register_forward_pre_hook(pre), modules[path].register_forward_hook(post)]
    return handles


def install_host_ranges(ranges: Dict[str, str], device) -> Dict[str, List[float]]:
    """Wrap each function named ``"module:attribute"`` so that every call
    runs inside a ``record_function`` range ``avsr_bench/<range>``, with
    the device synchronised at its start and at its end, and its host
    seconds between the two appended to the returned ``timings[range]``."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    timings: Dict[str, List[float]] = {}
    for name, target in ranges.items():
        mod_name, attr = target.split(":")
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)
        seconds = timings.setdefault(name, [])

        def wrapped(*args, _orig=orig, _name=PREFIX + name, _seconds=seconds, **kw):
            sync()
            with torch.autograd.profiler.record_function(_name):
                t0 = time.perf_counter()
                out = _orig(*args, **kw)
                sync()
                _seconds.append(time.perf_counter() - t0)
            return out

        setattr(mod, attr, wrapped)
    return timings


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


class Reduced:
    """What the readers read from one profiled window."""

    def __init__(self, prof, window_s: float, calls: int):
        events = list(prof.events())
        dev = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                      if _is_device(e) and not e.name.startswith(PREFIX)), key=lambda x: x[0])
        self.window_s, self.calls = window_s, calls
        self.kernel_s: Dict[str, float] = {}
        for s, e, name in dev:
            self.kernel_s[name] = self.kernel_s.get(name, 0.0) + (e - s) / 1e6
        busy, gaps, end = 0.0, [], None
        for s, e, _ in dev:  # the union of the device's intervals, one stream or several
            if end is None or s > end:
                if end is not None:
                    gaps.append((end, s))
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        self.busy_s = busy / 1e6
        # device time under each range: the operations that ran inside the
        # range's device-side interval (the profiler's annotation of it)
        starts = [s for s, _, _ in dev]
        cum = [0.0]
        for s, e, _ in dev:
            cum.append(cum[-1] + (e - s))
        self.span_s: Dict[str, float] = {}
        self.span_count: Dict[str, int] = {}
        ranges = []
        for e in events:
            if not e.name.startswith(PREFIX):
                continue
            key = e.name[len(PREFIX):]
            if _is_device(e):
                lo = bisect.bisect_left(starts, e.time_range.start)
                hi = lo
                while hi < len(dev) and dev[hi][1] <= e.time_range.end:
                    hi += 1
                self.span_s[key] = self.span_s.get(key, 0.0) + (cum[hi] - cum[lo]) / 1e6
            else:
                self.span_count[key] = self.span_count.get(key, 0) + 1
                ranges.append((e.time_range.start, e.time_range.end, key))
        self.idle_gaps = self._name_gaps(gaps, ranges)

    @staticmethod
    def _name_gaps(gaps, ranges) -> List[Tuple[str, float]]:
        """The ten longest idle gaps, each named by the innermost range the
        host was in when the device went idle (``between calls`` outside
        every call)."""
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        out = []
        for s, e in longest:
            inside = [r for r in ranges if r[0] <= s <= r[1]]
            name = min(inside, key=lambda r: r[1] - r[0])[2] if inside else "between calls"
            out.append((name, (e - s) / 1e6))
        return out

    def kernels_matching(self, *patterns: str) -> float:
        return sum(t for name, t in self.kernel_s.items() if any(p in name for p in patterns))

    def device_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]

    def span_ms_per_call(self, span: str) -> Optional[float]:
        """Device ms under ``span`` a call, or None where it never ran."""
        if not self.span_count.get(span) or self.span_s.get(span, 0.0) <= 0.0 or not self.calls:
            return None
        return self.span_s[span] * 1e3 / self.calls


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)
