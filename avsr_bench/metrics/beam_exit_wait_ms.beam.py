"""Host ms a beam step spends blocked under ``beam.exit_read``: the early
exit's one host read a step, which waits for the card to finish the
step's work, over the window's ``beam.step`` spans."""

from harness import program_spans


def read(run):
    return program_spans.ms_per_step(run, "beam.exit_read")
