"""The greedy window's share of the card's peak (%): the benchmark's FLOP
count of every encode served (``run.flops_per_call``, the family's
``call_flops``) over the traced window's length times the peak of the
served type."""

from harness import flops


def read(run):
    if not run.calls or run.trace.window_s <= 0:
        return None
    return 100.0 * run.calls * run.flops_per_call / (run.trace.window_s * flops.PEAK_FLOPS[run.dtype])
