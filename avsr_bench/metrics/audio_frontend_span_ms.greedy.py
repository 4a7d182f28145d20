"""Device ms a greedy call spends in the operations launched under the
program's own span ``encode.audio_frontend`` (log-mel, normalisation and
the conv2d subsampling: ``models/avsr_model.py``, ``models/asr_model.py``,
``models/branchformer.py``): the span-side twin of
``audio_frontend_ms.greedy``."""

from harness import program_spans


def read(run):
    return program_spans.device_ms_per_call(run, "encode.audio_frontend")
