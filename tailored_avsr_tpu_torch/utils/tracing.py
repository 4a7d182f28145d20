"""Spans at the serving path's layer boundaries, on the host's clock and,
when a ``torch.profiler`` runs, on the profiler's.

Off by default: ``span(name)`` and ``call(entry)`` then return one shared
no-op object and call nothing in torch. ``enable(prefix)`` turns them on:

- each span enters ``torch.autograd.profiler.record_function(prefix +
  name)``, so a profiler running at the time shows it over the kernels
  the span launched. The prefix is the enabler's: a reader that tells its
  own ranges from the device's operations by a name prefix passes it, so
  that the program's ranges are read as its own are;
- each span appends ``(name, parent index, start_ns, end_ns)`` to the
  record of the call it runs in, on ``time.perf_counter_ns``. A record is
  ``{"id", "entry", "spans"}``; ``spans[0]`` is the root (parent -1),
  opened by ``call(entry)``, and a span's parent is its index in the
  same list. A span opened on a thread with no call open is the root of
  a record of its own (the upload thread of ``Speech2Text.stream``). The
  last ``KEEP`` records are kept, in the order their calls ended
  (``records()``).

The spans (the serving path's; none inside the encoder's blocks, the
kernels' wrappers or the train loop):

- ``s2t.greedy`` / ``s2t.nbest``: roots, one a ``Speech2Text.greedy`` /
  ``nbest`` call (``__call__`` and ``stream`` reach ``nbest``);
- ``s2t.inputs``: the batch's upload and dequantisation;
  ``s2t.forward``: the model's launches before the first read (greedy:
  ``ctc_greedy``; nbest: the encode and the CTC log-softmax);
  ``s2t.readback``: the ``.cpu()`` reads of the results;
  ``s2t.detokenize``: ids to text; ``s2t.device_put``: ``device_put_batch``;
- ``encode.audio_frontend`` (log-mel, normalisation, the audio embed or
  the encoder's subsampling), ``encode.visual_frontend`` (the lip
  frontend, the visual embed), ``encode.encoder`` (the blocks, the final
  norm, the adaptive fusion); each may open more than once a call;
- ``beam.search``: one ``beam_search``; ``beam.step``: one step, with the
  children ``beam.score`` (the decoder + LM scorer), ``beam.ctc_prefix``
  (the CTC prefix scorer and its selection) and ``beam.select`` (eos
  gating, the top-k's, the finished merge, the reorder and the scorer
  state's gather with the step write); ``beam.exit_read``: the early
  exit's host read, a child of ``beam.search``.

Whether on or off, a span adds no device synchronise and no host read of
a tensor, holds no tensor and changes no result.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
from typing import Dict, Iterable, List

import torch

KEEP = 1024  # records kept: the last KEEP calls

_on = False
_prefix = ""
_records: collections.deque = collections.deque(maxlen=KEEP)
_ids = itertools.count()
_local = threading.local()  # .open: this thread's open spans, [(record, index)]


class _Off:
    """The span of disabled tracing: enters and leaves, and does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "root", "record", "index", "start", "range")

    def __init__(self, name: str, root: bool):
        self.name, self.root = name, root

    def __enter__(self):
        stack = getattr(_local, "open", None)
        if stack is None:
            stack = _local.open = []
        if self.root or not stack:
            self.record, parent = {"id": next(_ids), "entry": self.name, "spans": []}, -1
        else:
            self.record, parent = stack[-1]
        spans = self.record["spans"]
        self.index = len(spans)
        self.range = torch.autograd.profiler.record_function(_prefix + self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        spans.append((self.name, parent, self.start, None))
        stack.append((self.record, self.index))
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _local.open.pop()
        spans = self.record["spans"]
        spans[self.index] = (self.name, spans[self.index][1], self.start, end)
        if self.index == 0:
            _records.append(self.record)
        return False


def enable(prefix: str = "") -> None:
    """Turn the spans on, their profiler ranges named ``prefix + name``."""
    global _on, _prefix
    _prefix, _on = str(prefix), True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str):
    """A context manager: the span ``name`` inside the current call (or a
    root of its own on a thread with no call open)."""
    return _Span(name, False) if _on else _OFF


def call(entry: str):
    """A context manager: the root span of one entry call, with a record of its own."""
    return _Span(entry, True) if _on else _OFF


def spanned(name: str):
    """A decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def records() -> List[Dict]:
    """The kept records, oldest first."""
    return list(_records)


def _closed(records_: Iterable[Dict], name: str):
    for rec in records_:
        spans = rec["spans"]
        for i, (n, _, s, e) in enumerate(spans):
            if n == name and e is not None:
                yield spans, i, s, e


def count(records_: Iterable[Dict], name: str) -> int:
    """How many times ``name`` opened (and closed) in ``records_``."""
    return sum(1 for _ in _closed(records_, name))


def host_ms(records_: Iterable[Dict], name: str) -> float:
    """Host ms under ``name`` in ``records_``, summed over its intervals."""
    return sum(e - s for _, _, s, e in _closed(records_, name)) / 1e6


def self_ms(records_: Iterable[Dict], name: str) -> float:
    """Host ms under ``name`` less the time its child spans cover."""
    total = 0
    for spans, i, s, e in _closed(records_, name):
        total += (e - s) - sum(ce - cs for _, p, cs, ce in spans if p == i and ce is not None)
    return total / 1e6
