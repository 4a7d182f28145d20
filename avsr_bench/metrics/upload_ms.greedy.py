"""Host ms a greedy call spends under ``s2t.inputs``
(``Speech2Text.inputs``: the copy of the batch to the card from pageable
memory, which blocks the host, and the dequantisation launches)."""

from harness import program_spans


def read(run):
    return program_spans.ms_per_call(run, "s2t.inputs")
