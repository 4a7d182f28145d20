"""Host ms a greedy call spends under ``s2t.forward``: enqueueing the
model's launches (``ctc_greedy``) before the first read. Set beside the
device ms of the encode (the three ``*_span_ms.greedy``): where it comes
close to them, the encode is paced by its launches."""

from harness import program_spans


def read(run):
    return program_spans.ms_per_call(run, "s2t.forward")
