"""Host ms a beam step spends under ``beam.ctc_prefix``: the CTC prefix
scorer and its selection (``decode/ctc_prefix.py``), over the window's
``beam.step`` spans."""

from harness import program_spans


def read(run):
    return program_spans.ms_per_step(run, "beam.ctc_prefix")
