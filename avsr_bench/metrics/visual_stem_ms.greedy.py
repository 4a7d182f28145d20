"""Device ms a greedy call spends in the operations launched under the
program's span ``encode.visual_stem`` (``models/frontends.py``: the
Conv3D stem, its BatchNorm, activation and max-pool, on either route),
inside ``encode.visual_frontend``. A program without the span reports
nothing."""

from harness import program_spans


def read(run):
    return program_spans.device_ms_per_call(run, "encode.visual_stem")
