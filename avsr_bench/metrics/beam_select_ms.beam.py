"""Host ms a beam step spends under ``beam.select``: eos gating, the
top-k's, the finished merge, the reorder and the scorer state's gather
with the step write (K5) and the ancestry update, over the window's
``beam.step`` spans."""

from harness import program_spans


def read(run):
    return program_spans.ms_per_step(run, "beam.select")
