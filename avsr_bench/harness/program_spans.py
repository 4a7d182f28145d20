"""The program's own spans (``tailored_avsr_tpu_torch/utils/tracing.py``)
in the traced run, for the readers of the span metrics.

This is the harness's second import of the program, beside
``drivers.py``, made for the tracing module only. Importing this module
turns the program's spans on with the benchmark's range prefix
(``trace.PREFIX``), so that ``trace.Reduced`` reads the program's ranges
as it reads the benchmark's own: left out of the device's busy time, and
the idle gaps named by the innermost. The readers are loaded only for a
traced run (``--trace 1``), before its warm calls, so a run that reports
the end-to-end metrics keeps the spans off. A program without the
tracing module (an older commit) gives no records, and every reader of
them None.

The device time under a program span is not read from the profiler's
device-side annotation of its range (``span_ms_per_call``): the profiler
gives each kernel to the innermost range, so a range around the
benchmark's own hook ranges (``encode.encoder`` around each block's)
annotates only the kernels launched outside them. Nor from the host
events' linked kernels: the profiler links a kernel only to an ATen op,
and the program's own CUDA kernels launch from ctypes, outside any.
Importing this module makes ``trace.Reduced`` also keep
``program_device_s``: for each range under the prefix, the device seconds
of the operations whose launch (the runtime call that shares the
operation's correlation id) falls inside one of the range's host
intervals. The benchmark launches from one thread, so the intervals are
not told apart by thread.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

import torch

from . import trace

try:
    from tailored_avsr_tpu_torch.utils import tracing
except ImportError:
    tracing = None
else:
    tracing.enable(prefix=trace.PREFIX)


def launched_device_s(events) -> Dict[str, float]:
    """Device seconds of the operations launched inside each host range
    named ``trace.PREFIX + name``, by ``name`` (the ranges' own device-side
    annotations left out)."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    launched_at = {getattr(e, "id", None): e.time_range.start for e in events
                   if e.device_type == cpu and e.name.startswith("cu")}
    ops = [(launched_at[e.id], e.time_range.end - e.time_range.start) for e in events
           if e.device_type == cuda and not e.name.startswith(trace.PREFIX) and getattr(e, "id", None) in launched_at]
    ranges: Dict[str, List] = {}
    for e in events:
        if e.device_type == cpu and e.name.startswith(trace.PREFIX):
            ranges.setdefault(e.name[len(trace.PREFIX):], []).append((e.time_range.start, e.time_range.end))
    out: Dict[str, float] = {}
    for key, intervals in ranges.items():
        intervals.sort()
        starts = [s for s, _ in intervals]
        total = 0.0
        for t, us in ops:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= intervals[i][1]:
                total += us
        out[key] = total / 1e6
    return out


_reduce = trace.Reduced.__init__


def _reduce_with_launched(self, prof, window_s: float, calls: int):
    _reduce(self, prof, window_s, calls)
    self.program_device_s = launched_device_s(prof.events())


if not getattr(_reduce, "keeps_launched", False):
    _reduce_with_launched.keeps_launched = True
    trace.Reduced.__init__ = _reduce_with_launched


def window(run) -> List[Dict]:
    """The records of the window's calls: the last ``run.calls`` roots of
    the cell's entry (the warm calls' come before them)."""
    if tracing is None or not run.calls:
        return []
    entry = "s2t." + run.traffic["entry"]
    return [r for r in tracing.records() if r["entry"] == entry][-run.calls:]


def device_ms_per_call(run, span: str) -> Optional[float]:
    """Device ms a window call of the operations launched under ``span``,
    or None where none ran (no span, or no device)."""
    seconds = getattr(run.trace, "program_device_s", {}).get(span, 0.0)
    if seconds <= 0.0 or not run.calls:
        return None
    return seconds * 1e3 / run.calls


def ms_per_call(run, span: str) -> Optional[float]:
    """Host ms under ``span`` a window call, or None where it never opened."""
    records = window(run)
    if not tracing or not tracing.count(records, span):
        return None
    return tracing.host_ms(records, span) / len(records)


def ms_per_step(run, span: str) -> Optional[float]:
    """Host ms under ``span`` a beam step (the window's ``beam.step``
    spans), or None where either never opened."""
    records = window(run)
    steps = tracing.count(records, "beam.step") if tracing else 0
    if not steps or not tracing.count(records, span):
        return None
    return tracing.host_ms(records, span) / steps
