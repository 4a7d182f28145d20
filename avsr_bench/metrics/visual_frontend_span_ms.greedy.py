"""Device ms a greedy call spends in the operations launched under the
program's own span ``encode.visual_frontend`` (``models/avsr_model.py``:
the lip frontend, ``models/frontends.py``, and the visual embed): the
span-side twin of ``visual_frontend_ms.greedy``."""

from harness import program_spans


def read(run):
    return program_spans.device_ms_per_call(run, "encode.visual_frontend")
