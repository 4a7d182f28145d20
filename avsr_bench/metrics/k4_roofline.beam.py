"""K4's share of its roofline over the traced window (%): the sum of its
bound over the beam steps run (``harness/flops.k4_step_bound_s``, every
cached layer of the decoder and the LM at each step's position) divided
by the device time of the group-attend kernels."""

from harness import flops


def read(run):
    seconds = run.trace.kernels_matching("group_attend")
    if run.launches.get("K4", 0) <= 0 or seconds <= 0:
        return None
    bound = sum(flops.k4_step_bound_s(run.cfg, run.lm_cfg, run.batch, pos, run.dtype)
                for pos in run.step_positions())
    return 100.0 * bound / seconds
