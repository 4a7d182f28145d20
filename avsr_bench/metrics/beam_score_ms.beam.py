"""Host ms a beam step spends under ``beam.score``: the decoder + LM
scorer over the ancestry caches (K4), over the window's ``beam.step``
spans."""

from harness import program_spans


def read(run):
    return program_spans.ms_per_step(run, "beam.score")
