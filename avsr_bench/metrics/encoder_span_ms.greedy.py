"""Device ms a greedy call spends in the operations launched under the
program's own span ``encode.encoder`` (the blocks, the final norm and,
audio-visual, the adaptive fusion): the span-side twin of
``encoder_ms.greedy``."""

from harness import program_spans


def read(run):
    return program_spans.device_ms_per_call(run, "encode.encoder")
