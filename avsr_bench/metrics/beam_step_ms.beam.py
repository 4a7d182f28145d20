"""Host ms a beam step takes: the seconds of every call of the program's
beam search (``decode/beam_search.beam_search``, after the encode) under
the benchmark's own range, the device synchronised at its start so that
the encode's device work is not counted, over the beam steps run, counted
by the step write's launches (one a step)."""

HOST_RANGES = {"beam_loop": "tailored_avsr_tpu_torch.inference:beam_search"}


def read(run):
    steps = run.launches.get("K5", 0)
    seconds = sum(run.host_s.get("beam_loop", ()))
    if steps <= 0 or seconds <= 0:
        return None
    return 1e3 * seconds / steps
