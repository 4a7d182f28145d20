"""The beam window's share of the card's peak (%): the benchmark's FLOP
count of every call's encode and memory projection (``run.flops_per_call``,
the family's ``call_flops``) and of every beam step served
(``flops.beam_step_flops``) over the traced window's length times the peak
of the served type."""

from harness import flops


def read(run):
    if not run.calls or run.trace.window_s <= 0:
        return None
    work = run.calls * run.flops_per_call + sum(
        flops.beam_step_flops(run.cfg, run.lm_cfg, run.batch, run.frames, pos) for pos in run.step_positions())
    return 100.0 * work / (run.trace.window_s * flops.PEAK_FLOPS[run.dtype])
